"""LeRobot real-robot adapter (counterpart of
maniskill_tpu/agents/robots/lerobot/manipulator.py).

Bridges a huggingface/lerobot ``Robot`` object to the BaseRealAgent
interface that Sim2RealEnv drives: degree<->radian conversion with the
per-robot calibration offsets, a rate-limited soft reset, cached qpos reads
(motor-bus reads are the latency bottleneck) and camera capture. The
``lerobot`` package is never imported: the caller hands over the robot.

Unlike the JAX adapter, qpos (dof,) and frames (H, W, 3) come back
unbatched, as ``BaseRealAgent`` documents and as ``Sim2RealEnv`` batches
them; the JAX adapter's extra leading axis breaks the pairing (see
ROADMAP.md, known reference faults).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ...base_real_agent import BaseRealAgent


class LeRobotRealAgent(BaseRealAgent):
    """Drives any LeRobot follower arm (SO100, Koch, ...).

    Args:
        robot: a connected ``lerobot`` Robot object (``name``, ``bus``
            with ``sync_read``, ``send_action``, ``cameras`` with
            ``async_read``, ``connect``, ``disconnect``).
        use_cached_qpos: serve qpos reads from the cache between commands;
            motor-bus reads cost 5-6 ms and otherwise cap the control rate.
    """

    # per-robot joint calibration offsets in degrees, subtracted on read and
    # added on write
    CALIBRATION_OFFSETS_DEG = {"so100_follower": {"elbow_flex": 6.8}}

    def __init__(self, robot, use_cached_qpos: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.real_robot = robot
        self.use_cached_qpos = use_cached_qpos
        self._cached_qpos: Optional[np.ndarray] = None
        self._captured_sensor_data = None
        self._motor_keys = None

    @property
    def _offsets(self):
        return self.CALIBRATION_OFFSETS_DEG.get(getattr(self.real_robot, "name", ""), {})

    def start(self):
        self.real_robot.connect()

    def stop(self):
        self.real_robot.disconnect()

    def set_target_qpos(self, qpos):
        self._cached_qpos = None
        deg = np.rad2deg(np.asarray(qpos, np.float64).ravel())
        keys = self._motor_keys or list(self.real_robot.bus.sync_read("Present_Position").keys())
        self._motor_keys = keys
        action = {f"{k}.pos": deg[i] + self._offsets.get(k, 0.0) for i, k in enumerate(keys)}
        self.real_robot.send_action(action)

    def set_target_qvel(self, qvel):
        raise NotImplementedError("LeRobot follower arms are position-driven")

    def reset(self, qpos: Optional[np.ndarray] = None):
        """Rate-limited soft move to qpos (at most 0.025 rad per 1/30 s)."""
        if qpos is None:
            return
        qpos = np.asarray(qpos, np.float64).ravel()
        freq, max_step = 30.0, 0.025
        target = np.asarray(self.get_qpos(), np.float64).ravel()
        for _ in range(int(20 * freq)):
            t0 = time.perf_counter()
            delta = np.clip(qpos - target, -max_step, max_step)
            if np.linalg.norm(delta) <= 1e-4:
                break
            target = target + delta
            self.set_target_qpos(target)
            dt = time.perf_counter() - t0
            if dt < 1.0 / freq:
                time.sleep(1.0 / freq - dt)

    def capture_sensor_data(self, sensor_names=None):
        cameras = self.real_robot.cameras
        names = sensor_names or list(cameras.keys())
        self._captured_sensor_data = {n: dict(rgb=np.asarray(cameras[n].async_read())) for n in names}

    def get_sensor_data(self, sensor_names=None):
        if self._captured_sensor_data is None:
            raise RuntimeError("No sensor data captured yet; call capture_sensor_data() first")
        data = self._captured_sensor_data
        if sensor_names is None:
            return data
        return {k: v for k, v in data.items() if k in sensor_names}

    def get_qpos(self):
        if self.use_cached_qpos and self._cached_qpos is not None:
            return self._cached_qpos.copy()
        deg = self.real_robot.bus.sync_read("Present_Position")
        for k, off in self._offsets.items():
            if k in deg:
                deg[k] = deg[k] - off
        if self._motor_keys is None:
            self._motor_keys = list(deg.keys())
        qpos = np.deg2rad(np.asarray([deg[k] for k in self._motor_keys], np.float64))
        self._cached_qpos = qpos
        return qpos

    def get_qvel(self):
        raise NotImplementedError("LeRobot motor buses do not report velocity")
