"""PD joint position controllers (counterpart of
maniskill_tpu/agents/controllers/pd_joint_pos.py).

Delta/absolute targets, ``use_target`` (integrate deltas on the previous
target) and the mimic-joint variant. Targets are stored in Data.drive_target,
so they persist across steps and are partial-reset-masked automatically.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ...utils import gym_utils
from .base_controller import BaseController, ControllerConfig


@dataclasses.dataclass
class PDJointPosControllerConfig(ControllerConfig):
    joint_names: List[str] = None
    lower: Union[None, float, Sequence[float]] = None
    upper: Union[None, float, Sequence[float]] = None
    stiffness: Union[float, Sequence[float]] = 100.0
    damping: Union[float, Sequence[float]] = 10.0
    force_limit: Union[float, Sequence[float]] = 1e10
    friction: Union[float, Sequence[float]] = 0.0
    use_delta: bool = False
    use_target: bool = False
    interpolate: bool = False
    normalize_action: bool = True
    drive_mode: str = "force"

    @property
    def controller_cls(self):
        return PDJointPosController


class PDJointPosController(BaseController):
    config: PDJointPosControllerConfig

    def _action_bounds(self):
        """(low, high) of the unnormalized action."""
        n = len(self.config.joint_names)
        if self.config.use_delta or self.config.lower is not None:
            lo = np.broadcast_to(np.asarray(self.config.lower, np.float32), (n,))
            hi = np.broadcast_to(np.asarray(self.config.upper, np.float32), (n,))
            return lo, hi
        # absolute mode: limits come from the joint limits
        lims = self._joint_limits()
        return lims[:, 0], lims[:, 1]

    def _initialize_action_space(self):
        lims = self._joint_limits()
        dev = self.scene.device
        self._lim_lo = torch.as_tensor(lims[:, 0], device=dev)
        self._lim_hi = torch.as_tensor(lims[:, 1], device=dev)
        self._set_action_bounds(*self._action_bounds())

    def _set_action_bounds(self, lo, hi):
        """Action limits: host copies for the space, device copies for the
        per-step scaling."""
        self._lo, self._hi = np.array(lo, np.float32), np.array(hi, np.float32)
        self._lo_t = torch.as_tensor(self._lo, device=self.scene.device)
        self._hi_t = torch.as_tensor(self._hi, device=self.scene.device)
        if self.config.normalize_action:
            self._action_space = gym_utils.Box(-1.0, 1.0, self._lo.shape, np.float32)
        else:
            self._action_space = gym_utils.Box(self._lo, self._hi, dtype=np.float32)

    def _joint_limits(self) -> np.ndarray:
        src = self.scene.model.host_dof_limit
        lims = np.stack([np.asarray(src)[j.dof_adr] for j in self.joints])
        return np.clip(lims, -1e4, 1e4).astype(np.float32)

    def set_drive_property(self):
        n = len(self.joints)
        kp = np.broadcast_to(np.asarray(self.config.stiffness, np.float32), (n,))
        kd = np.broadcast_to(np.asarray(self.config.damping, np.float32), (n,))
        fl = np.broadcast_to(np.asarray(self.config.force_limit, np.float32), (n,))
        self.scene.set_drive_properties(self.dof_adrs.cpu().numpy(), kp, kd, fl)

    def reset(self):
        """Reset targets to the current joint positions (masked)."""
        scene = self.scene
        d = scene.data
        scene.data = d.replace(
            drive_target=scene.write_cols(d.drive_target, self.dof_adrs, d.qpos[:, self.q_adrs])
        )

    def _target_qpos(self) -> torch.Tensor:
        return self.scene.data.drive_target[:, self.dof_adrs]

    def _set_target(self, t: torch.Tensor):
        d = self.scene.data
        target = d.drive_target.clone()
        target[:, self.dof_adrs] = t
        self.scene.data = d.replace(drive_target=target)

    def set_action(self, action: torch.Tensor):
        action = action.to(torch.float32)
        if self.config.normalize_action:
            action = self._clip_and_scale_action(action, self._lo_t, self._hi_t)
        d = self.scene.data
        if self.config.use_delta:
            base = self._target_qpos() if self.config.use_target else d.qpos[:, self.q_adrs]
            target = base + action
        else:
            target = action.expand(self.scene.num_envs, len(self.joints))
        target = torch.minimum(torch.maximum(target, self._lim_lo), self._lim_hi)
        if self.config.interpolate:
            # per-sim-step linear interpolation from the current position to
            # the commanded target; substep 0 applies the first step
            self._interp_start = d.qpos[:, self.q_adrs]
            self._interp_final = target
            target = self._interp_start
        self._set_target(target)

    def before_simulation_step(self, data, substep):
        if not self.config.interpolate or not hasattr(self, "_interp_final"):
            return data
        frac = (substep + 1.0) / float(self.scene.sim_steps_per_control)
        t = self._interp_start + (self._interp_final - self._interp_start) * frac
        target = data.drive_target.clone()
        target[:, self.dof_adrs] = t
        return data.replace(drive_target=target)

    def get_state(self):
        return {"target_qpos": self._target_qpos()}

    def set_state(self, state):
        if "target_qpos" in state:
            self._set_target(self.scene.to_batch(state["target_qpos"], len(self.joints)))


@dataclasses.dataclass
class PDJointPosMimicControllerConfig(PDJointPosControllerConfig):
    """One commanded value drives several mimicking joints. ``mimic`` maps
    follower joint -> dict(joint=leader, multiplier, offset); by default every
    joint mimics the first 1:1 (two-finger grippers)."""

    mimic: Optional[dict] = None

    @property
    def controller_cls(self):
        return PDJointPosMimicController


class PDJointPosMimicController(PDJointPosController):
    def _initialize_action_space(self):
        # the action holds the leader (non-mimicking) joints only
        super()._initialize_action_space()
        names = list(self.config.joint_names)
        mimic = self.config.mimic or {
            n: dict(joint=names[0], multiplier=1.0, offset=0.0) for n in names[1:]
        }
        leaders = [n for n in names if n not in mimic]
        lidx = np.zeros(len(names), np.int64)
        mult = np.ones(len(names), np.float32)
        off = np.zeros(len(names), np.float32)
        for i, n in enumerate(names):
            spec = mimic.get(n)
            lidx[i] = leaders.index(spec["joint"] if spec else n)
            if spec:
                mult[i] = spec.get("multiplier", 1.0)
                off[i] = spec.get("offset", 0.0)
        keep = [names.index(n) for n in leaders]
        dev = self.scene.device
        self._lidx = torch.as_tensor(lidx, device=dev)
        self._mult = torch.as_tensor(mult, device=dev)
        self._off = torch.as_tensor(off, device=dev)
        self._leader_q = self.q_adrs[keep]
        self._leader_dof = self.dof_adrs[keep]
        self._set_action_bounds(self._lo[keep], self._hi[keep])

    def set_action(self, action: torch.Tensor):
        action = action.to(torch.float32)
        if self.config.normalize_action:
            action = self._clip_and_scale_action(action, self._lo_t, self._hi_t)
        d = self.scene.data
        leader = action.expand(self.scene.num_envs, self._lo.shape[0])
        if self.config.use_delta:
            base = d.drive_target[:, self._leader_dof] if self.config.use_target else d.qpos[:, self._leader_q]
            leader = base + leader
        target = leader[:, self._lidx] * self._mult + self._off
        self._set_target(torch.minimum(torch.maximum(target, self._lim_lo), self._lim_hi))
