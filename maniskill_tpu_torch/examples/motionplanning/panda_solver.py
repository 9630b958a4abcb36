"""Batched motion-planning solver for the Panda arm (counterpart of
maniskill_tpu/examples/motionplanning/panda_solver.py).

One plan call steers the whole batch: damped-least-squares IK and a
joint-space interpolation run for every env at once, each env toward its
own goal pose. Execution drives the env's ``pd_joint_pos`` controller with
absolute targets.

Each move reads one number on the host: the largest joint step of the
batch, which sets the move's step count (the reference's semantics). So a
move synchronizes with the device once, and nothing else in a plan does:
constants are made on the device, and the arm's kinematics tables are
shared with the env's. ``PandaMotionPlanningSolver.moves`` counts the moves
of every solver.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...agents.controllers.utils.kinematics import arm_kinematics


def device_vector(values, device) -> torch.Tensor:
    """A small constant vector made on ``device`` by fills: a tensor built
    from host values would be a blocking host-to-device copy."""
    out = torch.zeros(len(values), device=device)
    for i, v in enumerate(values):
        if v:
            out[i:i + 1].fill_(v)
    return out


class PandaMotionPlanningSolver:
    OPEN = 1.0
    CLOSED = -1.0
    moves = 0

    def __init__(self, env, joint_vel_limit: float = 1.5):
        """``env`` must use control_mode='pd_joint_pos'."""
        self.env = env
        self.base = env.unwrapped
        if self.base.control_mode != "pd_joint_pos":
            raise ValueError(
                "PandaMotionPlanningSolver needs control_mode='pd_joint_pos', got "
                f"{self.base.control_mode}"
            )
        agent = self.base.agent
        arm_joints = [f"panda_joint{i}" for i in range(1, 8)]
        self.kin = arm_kinematics(self.base.scene, agent.robot, "panda_hand_tcp", arm_joints)
        self.joint_vel_limit = joint_vel_limit
        # a gripper-less arm (panda_stick, for the drawing tasks) takes an
        # arm-only action
        self.has_gripper = "gripper" in agent.controller.controllers
        self.gripper_state = self.OPEN
        self.control_dt = 1.0 / self.base.control_freq
        # the hand pointing straight down (its z axis toward the table)
        self.down_q = device_vector((0.0, 1.0, 0.0, 0.0), self.base.device)

    # -- primitives --------------------------------------------------------
    def _arm_qpos(self) -> torch.Tensor:
        return self.base.scene.data.qpos[:, self.kin.q_idx]

    def _exec_targets(self, targets: torch.Tensor):
        """One env step with absolute arm targets and the gripper's state."""
        act = dict(arm=targets)
        if self.has_gripper:
            act["gripper"] = torch.full((self.base.num_envs, 1), self.gripper_state, device=targets.device)
        return self.env.step(self.base.agent.controller.from_action_dict(act))

    def follow_qpos_path(self, q_goal: torch.Tensor, max_steps: int = 100):
        """Interpolate the joints linearly from where they are to ``q_goal``
        (B, 7), with the step count from the joint speed limit, and run it."""
        q0 = self._arm_qpos()
        dq = q_goal - q0
        # the move's one host read
        n = int(np.ceil(float(torch.max(torch.abs(dq))) / (self.joint_vel_limit * self.control_dt)))
        n = max(1, min(n, max_steps))
        PandaMotionPlanningSolver.moves += 1
        result = None
        for i in range(1, n + 1):
            result = self._exec_targets(q0 + dq * (i / n))
        return result

    def move_to_pose(self, pose7: torch.Tensor, steps: Optional[int] = None,
                     refine_steps: int = 0, arc_steps: int = 1):
        """IK to per-env end-effector poses (B, 7, wxyz), then follow the
        joint path. ``arc_steps > 1`` tracks a Cartesian arc: the pose is
        interpolated (lerp and slerp) and each waypoint solved from the
        previous solution, which keeps large reorientations inside the
        solver's basin and the joint limits."""
        cur = self.kin.ee_pose(self.base.scene.data)
        p0, q0 = cur[:, :3], cur[:, 3:]
        p1, q1 = pose7[:, :3], pose7[:, 3:]
        # shortest-arc slerp
        dot = torch.sum(q0 * q1, -1, keepdim=True)
        q0s = torch.where(dot < 0, -q0, q0)
        theta = torch.acos(torch.clamp(torch.abs(dot), -1.0, 1.0))
        sin_t = torch.clamp(torch.sin(theta), min=1e-6)
        per = max(1, (steps or 100) // max(1, arc_steps))
        result = None
        for j in range(1, arc_steps + 1):
            a = j / arc_steps
            if arc_steps == 1:
                wp = pose7
            else:
                p = p0 + (p1 - p0) * a
                q = torch.sin((1 - a) * theta) / sin_t * q0s + torch.sin(a * theta) / sin_t * q1
                q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
                wp = torch.cat([p, q], -1)
            q_goal = self.kin.compute_ik(wp, self._arm_qpos(), iterations=40)
            result = self.follow_qpos_path(q_goal, max_steps=per)
        for _ in range(refine_steps):
            result = self._exec_targets(q_goal)
        return result

    def _hold(self, state: float, steps: int):
        self.gripper_state = state
        result = None
        target = self._arm_qpos()
        for _ in range(steps):
            result = self._exec_targets(target)
        return result

    def open_gripper(self, steps: int = 6):
        return self._hold(self.OPEN, steps)

    def close_gripper(self, steps: int = 6):
        return self._hold(self.CLOSED, steps)
