"""Sim2RealEnv (counterpart of maniskill_tpu/envs/sim2real_env.py).

Runs a policy trained in sim on a physical robot with the obs and action
contracts of the sim env:

- actions go through the *sim* controller (set_action -> drive targets) and
  the joint targets are mirrored to the real robot, paced to the control
  frequency with wall-clock sleeps;
- the real robot's qpos is written into the sim scene after every step and
  reset (one host-to-device copy, one batched column write through the
  robot's qpos addresses, one forward-kinematics pass; no host read), so the
  sim env's own ``_get_obs_extra``, ``evaluate`` and rewards see the
  physical robot;
- the agent obs takes the sim env's own ``_get_obs_agent`` layout: each leaf
  from the real robot where it reports it, else from the synced sim (a robot
  whose bus reports no velocity gets the sim's qvel; the controller state is
  the sim controller's);
- real frames are center-cropped to the sim camera's aspect ratio and
  resized to its shape; every obs leaf is a tensor on the sim env's device;
- wrappers around the sim env are replayed on the real env by swapping the
  innermost ``Wrapper``'s ``.env`` for a shim whose step and reset drive the
  hardware;
- on construction (unless ``skip_data_checks``) one sim reset and one real
  reset are compared recursively for shape and dtype.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..agents.base_real_agent import BaseRealAgent
from ..physics import forward
from ..utils import common
from ..utils.logging_utils import logger
from ..wrappers.base import Wrapper


def _center_crop_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Crop to the target aspect ratio, then nearest-neighbour resize (exact
    for integer down-scales; no image library needed)."""
    h, w = img.shape[:2]
    scale = max(out_h / h, out_w / w)
    ch, cw = max(1, round(out_h / scale)), max(1, round(out_w / scale))
    y0, x0 = (h - ch) // 2, (w - cw) // 2
    crop = img[y0 : y0 + ch, x0 : x0 + cw]
    yi = np.linspace(0, ch - 1, out_h).round().astype(int)
    xi = np.linspace(0, cw - 1, out_w).round().astype(int)
    return crop[yi][:, xi]


class _RealStepReset:
    """The innermost env handed to the sim env's wrapper chain: its step and
    reset drive the real hardware; anything else reads through the owner."""

    def __init__(self, owner: "Sim2RealEnv"):
        self._owner = owner

    def step(self, action):
        return self._owner._real_step(action)

    def reset(self, seed=None, options=None):
        return self._owner.get_obs(), {"reconfigure": False}

    def render(self):
        return self._owner.render()

    @property
    def unwrapped(self):
        return self._owner

    def __getattr__(self, name):
        if name.startswith("__") or name == "_owner":
            raise AttributeError(name)
        return getattr(self._owner, name)


def _shape_dtype(x):
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return tuple(x.shape), x.dtype


class Sim2RealEnv:
    metadata = {"render_modes": ["rgb_array", "sensors", "all"]}

    def __init__(
        self,
        sim_env,
        agent: BaseRealAgent,
        real_reset_function: Optional[Callable] = None,
        sensor_data_preprocessing_function: Optional[Callable] = None,
        render_mode: Optional[str] = "sensors",
        skip_data_checks: bool = False,
        control_freq: Optional[int] = None,
    ):
        self.sim_env = sim_env
        self.base_sim_env = sim_env.unwrapped
        assert self.base_sim_env.num_envs == 1, "Sim2RealEnv requires num_envs=1"
        self.num_envs = 1
        self.device = self.base_sim_env.device
        self.agent = agent
        self.agent._sim_agent = self.base_sim_env.agent
        self.render_mode = render_mode

        self.sim_freq = self.base_sim_env.sim_freq
        self.control_freq = control_freq or self.base_sim_env.control_freq
        self.control_dt = 1.0 / self.control_freq
        self.last_control_time: Optional[float] = None
        self.obs_mode = self.base_sim_env.obs_mode
        self.reward_mode = self.base_sim_env.reward_mode

        # the spaces of the WRAPPED sim env, which the policy was trained on
        self.observation_space = self.sim_env.observation_space
        self.action_space = self.sim_env.action_space

        wrappers = []
        cur = self.sim_env
        while isinstance(cur, Wrapper):
            wrappers.append(cur)
            cur = cur.env
        self._handle_wrappers = len(wrappers) > 0
        if self._handle_wrappers:
            self._first_wrapper = wrappers[0]
            self._last_wrapper = wrappers[-1]
        self._shim = _RealStepReset(self)

        self._sim_sensor_shapes = {
            name: (cfg.height, cfg.width) for name, cfg in self.base_sim_env._sensor_configs.items()
        }
        self._elapsed_steps = torch.zeros((1,), dtype=torch.int32, device=self.device)

        def default_real_reset(self: "Sim2RealEnv", seed=None, options=None):
            self.sim_env.reset(seed=seed, options=options)
            self.agent.reset(self.base_sim_env.agent.robot.qpos.cpu().numpy().reshape(-1))
            input("Press enter if the environment is reset")

        self.real_reset_function = real_reset_function or default_real_reset
        if sensor_data_preprocessing_function is not None:
            self.preprocess_sensor_data = sensor_data_preprocessing_function

        if not skip_data_checks:
            sample_sim_obs, _ = self.sim_env.reset()
            sample_real_obs, _ = self.reset()
            self._check_observations(sample_sim_obs, sample_real_obs)

    # ------------------------------------------------------------------
    @property
    def elapsed_steps(self):
        return self._elapsed_steps

    @property
    def unwrapped(self):
        return self

    def _sync_sim_from_real(self):
        """Write the real robot's joint positions into the sim scene and run
        one FK pass: one host-to-device copy of the qpos, a column write
        through the robot's qpos addresses (the first n of them for a real
        robot of n dofs), no host read."""
        base = self.base_sim_env
        qpos = torch.as_tensor(np.asarray(self.agent.get_qpos(), np.float32).reshape(1, -1))
        if base.device.type == "cuda":  # a pinned buffer: the copy does not block the host
            qpos = qpos.pin_memory()
        qpos = qpos.to(base.device, non_blocking=True)
        data = base.scene.data
        new_qpos = data.qpos.index_copy(1, base.agent.robot._qadr[: qpos.shape[1]], qpos)
        base.scene.data = forward(base.scene.model, data.replace(qpos=new_qpos))

    def _step_action(self, action):
        """Sim controller -> drive targets -> real robot, paced to
        ``control_dt``."""
        base = self.base_sim_env
        action = common.to_tensor(action, device=base.device)
        if action.ndim == len(base.single_action_space.shape):
            action = action[None]
        base.agent.set_action(action)
        ctrl = base.agent.controller

        if self.last_control_time is None:
            self.last_control_time = time.perf_counter()
        else:
            dt = time.perf_counter() - self.last_control_time
            if dt < self.control_dt:
                time.sleep(self.control_dt - dt)
            else:
                logger.warning(f"Control dt {self.control_dt} was not reached, actual dt was {dt}")
        self.last_control_time = time.perf_counter()

        data = base.scene.data
        if getattr(ctrl, "sets_target_qpos", True):
            self.agent.set_target_qpos(data.drive_target[0].cpu().numpy())
        if getattr(ctrl, "sets_target_qvel", False):
            self.agent.set_target_qvel(data.drive_vel_target[0].cpu().numpy())

    def _real_step(self, action):
        self._step_action(action)
        self._sync_sim_from_real()
        self._elapsed_steps = self._elapsed_steps + 1
        info = self.get_info()
        obs = self.get_obs(info)
        reward = self.get_reward(obs=obs, action=action, info=info)
        terminated = bool(torch.as_tensor(info.get("success", False)).reshape(-1)[0])
        truncated = False
        return obs, reward, terminated, truncated, info

    # -- step and reset through the sim wrapper chain --------------------
    def _through_wrappers(self, fn):
        orig = self._last_wrapper.env
        self._last_wrapper.env = self._shim
        try:
            return fn(self._first_wrapper)
        finally:
            self._last_wrapper.env = orig

    def step(self, action):
        if self._handle_wrappers:
            return self._through_wrappers(lambda w: w.step(action))
        return self._real_step(action)

    def reset(self, *, seed=None, options=None):
        self.real_reset_function(self, seed, options)
        self._elapsed_steps = torch.zeros_like(self._elapsed_steps)
        self.last_control_time = None
        self._sync_sim_from_real()
        if self._handle_wrappers:
            ret = self._through_wrappers(lambda w: w.reset(seed=seed, options=options))
        else:
            ret = self._shim.reset(seed=seed, options=options)
        ctrl = self.base_sim_env.agent.controller
        if hasattr(ctrl, "reset"):
            ctrl.reset()
        return ret

    # -- observations ----------------------------------------------------
    def _real_proprioception(self) -> Dict[str, Any]:
        try:
            return self.agent.get_proprioception()
        except NotImplementedError:  # e.g. a motor bus that reports no qvel
            return dict(qpos=self.agent.get_qpos())

    def get_obs(self, info: Optional[dict] = None) -> Any:
        if info is None:
            info = self.get_info()
        base = self.base_sim_env
        if base.obs_mode == "none":
            return {}
        real = self._real_proprioception()
        dev = base.device
        # the sim env's own layout, computed on the synced scene; each leaf
        # the real robot reports replaces the sim's
        agent_obs = {
            k: common.batch(np.asarray(real[k], np.float32)).to(dev) if k in real else v
            for k, v in base._get_obs_agent().items()
        }
        extra = base._get_obs_extra(info)
        state_dict = dict(agent=agent_obs, extra=extra)
        if base.obs_mode == "state":
            return common.flatten_state_dict(state_dict)
        if base.obs_mode == "state_dict":
            return state_dict
        state_dict["sensor_data"] = self._get_obs_sensor_data()
        state_dict["sensor_param"] = {name: sensor.get_params() for name, sensor in base._sensors.items()}
        return state_dict

    def _get_obs_sensor_data(self) -> Dict:
        if hasattr(self.agent, "capture_sensor_data"):
            self.agent.capture_sensor_data()
        return self.preprocess_sensor_data(self.agent.get_sensor_data())

    def preprocess_sensor_data(self, sensor_data: Dict) -> Dict:
        out = {}
        for name, modalities in sensor_data.items():
            shape = self._sim_sensor_shapes.get(name)
            proc = {}
            for mod, img in modalities.items():
                img = np.asarray(img)
                if shape is not None and img.ndim >= 2:
                    img = _center_crop_resize(img, *shape)
                proc[mod] = torch.as_tensor(np.ascontiguousarray(img))[None].to(self.device)
            out[name] = proc
        return out

    # -- info and rewards (the sim env's own, on the synced state) -------
    def get_info(self):
        info = dict(self.base_sim_env.evaluate())
        info["elapsed_steps"] = self._elapsed_steps.clone()
        return info

    def get_reward(self, obs, action, info):
        """Sparse: success less fail, read on the host (dense rewards may
        read sim-only state; override for a real-world reward)."""
        if self.reward_mode in ("none",):
            return 0.0
        if "success" in info:
            r = float(torch.as_tensor(info["success"]).reshape(-1)[0])
            if "fail" in info:
                r -= float(torch.as_tensor(info["fail"]).reshape(-1)[0])
            return r
        return 0.0

    # -- render ----------------------------------------------------------
    def render(self):
        data = self.agent.get_sensor_data()
        if not data:
            return None
        frames = [np.asarray(m["rgb"]) for m in data.values() if "rgb" in m]
        if not frames:
            return None
        if self.render_mode == "sensors" or self.render_mode == "all":
            return np.concatenate(frames, axis=1) if len(frames) > 1 else frames[0]
        return frames[0]

    # -- checks ----------------------------------------------------------
    def _check_observations(self, sample_sim_obs, sample_real_obs):
        """Recursive shape and dtype alignment of a sim and a real obs."""

        def check(sim_obs, real_obs, path=()):
            if isinstance(sim_obs, dict):
                for key in sim_obs:
                    if key not in real_obs:
                        raise KeyError(
                            'Key obs["%s"] found in simulation observation but not in real observation'
                            % ".".join(path + (key,))
                        )
                    check(sim_obs[key], real_obs[key], path + (key,))
            else:
                (s_shape, s_dtype), (r_shape, r_dtype) = _shape_dtype(sim_obs), _shape_dtype(real_obs)
                assert s_shape == r_shape, f"Shape mismatch: obs[\"{'.'.join(path)}\"]: {s_shape} vs {r_shape}"
                assert s_dtype == r_dtype, f"Dtype mismatch: obs[\"{'.'.join(path)}\"]: {s_dtype} vs {r_dtype}"

        check(sample_sim_obs, sample_real_obs)

    def close(self):
        self.agent.stop()

    def __getattr__(self, name):
        # anything else (task attributes, helper properties) from the sim env
        if name.startswith("__") or name in ("base_sim_env", "sim_env"):
            raise AttributeError(name)
        return getattr(self.base_sim_env, name)
