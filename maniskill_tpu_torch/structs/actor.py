"""Batched ``Actor`` view over the physics state (counterpart of
maniskill_tpu/structs/actor.py).

An Actor is a (scene, body_id) view; setters are masked by the scene's
partial-reset mask.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from ..physics.types import DYNAMIC, KINEMATIC, STATIC
from .pose import Pose

if TYPE_CHECKING:
    from ..envs.scene import ManiSkillScene


class Actor:
    def __init__(
        self,
        scene: "ManiSkillScene",
        name: str,
        body_id: int,
        body_type: int,
        initial_pose: Optional[np.ndarray] = None,
    ):
        self.scene = scene
        self.name = name
        self.body_id = body_id
        self.body_type = body_type
        self.initial_pose = initial_pose
        self.per_scene_id = None  # segmentation id, assigned by the scene
        # q/dof addresses wired by scene.finalize() (the model exists only then)
        self._q_adr = None
        self._dof_adr = None
        self._mocap_idx = None  # index into Data.mocap_pose for dof-less markers

    @property
    def px_body_type(self) -> str:
        return {DYNAMIC: "dynamic", KINEMATIC: "kinematic", STATIC: "static"}[self.body_type]

    @property
    def is_static(self) -> bool:
        return self.body_type == STATIC

    # -- pose ----------------------------------------------------------
    @property
    def pose(self) -> Pose:
        scene = self.scene
        if self.is_static:
            raw = torch.as_tensor(self.initial_pose, dtype=torch.float32, device=scene.device)
            return Pose(raw.expand(scene.num_envs, 7))
        if self._mocap_idx is not None:
            return Pose(scene.data.mocap_pose[:, self._mocap_idx])
        qa = self._q_adr
        return Pose(scene.data.qpos[:, qa : qa + 7])

    @pose.setter
    def pose(self, pose):
        self.set_pose(pose)

    def set_pose(self, pose):
        if self.is_static:
            raise RuntimeError(f"cannot set pose of static actor {self.name}")
        scene = self.scene
        raw = scene.to_batch(Pose.create(pose).raw_pose, 7)
        d = scene.data
        if self._mocap_idx is not None:
            mocap = d.mocap_pose.clone()
            mocap[:, self._mocap_idx] = scene.masked(raw, mocap[:, self._mocap_idx])
            scene.data = d.replace(mocap_pose=mocap)
            return
        qa = self._q_adr
        scene.data = d.replace(qpos=scene.write_cols(d.qpos, slice(qa, qa + 7), raw))

    # -- velocities ----------------------------------------------------
    @property
    def linear_velocity(self) -> torch.Tensor:
        if self.is_static or self._mocap_idx is not None:
            return torch.zeros(self.scene.num_envs, 3, device=self.scene.device)
        va = self._dof_adr
        return self.scene.data.qvel[:, va : va + 3]

    @linear_velocity.setter
    def linear_velocity(self, v):
        self.set_linear_velocity(v)

    @property
    def angular_velocity(self) -> torch.Tensor:
        if self.is_static or self._mocap_idx is not None:
            return torch.zeros(self.scene.num_envs, 3, device=self.scene.device)
        va = self._dof_adr
        return self.scene.data.qvel[:, va + 3 : va + 6]

    @angular_velocity.setter
    def angular_velocity(self, v):
        self.set_angular_velocity(v)

    def set_linear_velocity(self, v):
        self._set_vel(0, v)

    def set_angular_velocity(self, v):
        self._set_vel(3, v)

    def _set_vel(self, start, v):
        if self.is_static:
            raise RuntimeError(f"cannot set velocity of static actor {self.name}")
        if self._mocap_idx is not None:
            return  # mocap markers have no dofs; velocity is identically zero
        scene = self.scene
        lo = self._dof_adr + start
        d = scene.data
        scene.data = d.replace(
            qvel=scene.write_cols(d.qvel, slice(lo, lo + 3), scene.to_batch(v, 3))
        )

    def is_static_check(self, lin_thresh: float = 1e-2, ang_thresh: float = 0.5) -> torch.Tensor:
        """(B,) bool: the actor's linear and angular speeds are both at most
        their thresholds."""
        v = torch.linalg.vector_norm(self.linear_velocity, dim=-1)
        w = torch.linalg.vector_norm(self.angular_velocity, dim=-1)
        return (v <= lin_thresh) & (w <= ang_thresh)

    # -- state (13,) = [pose7, linvel3, angvel3] -------------------------
    def get_state(self) -> torch.Tensor:
        return torch.cat(
            [self.pose.raw_pose, self.linear_velocity, self.angular_velocity], -1
        )

    def set_state(self, state):
        state = self.scene.to_batch(state, 13)
        self.set_pose(Pose(state[..., :7]))
        self.set_linear_velocity(state[..., 7:10])
        self.set_angular_velocity(state[..., 10:13])

    # -- forces ----------------------------------------------------------
    def apply_force(self, force, torque=None):
        """Add a world-frame external force at the COM (and a torque) for the
        next physics substep, which consumes it; calls before it sum, and a
        body-body drive's wrench adds to them in that substep."""
        scene = self.scene
        x = scene.data.xfrc_applied.clone()
        x[:, self.body_id, :3] += scene.to_batch(force, 3)
        if torque is not None:
            x[:, self.body_id, 3:] += scene.to_batch(torque, 3)
        scene.data = scene.data.replace(xfrc_applied=x)

    def get_net_contact_forces(self) -> torch.Tensor:
        """Net contact force (B, 3) on this actor."""
        return self.scene.net_contact_forces_for_bodies([self.body_id])

    @property
    def geom_ids(self) -> np.ndarray:
        """The ids of this actor's geoms in the model."""
        return np.nonzero(np.asarray(self.scene.model.geom_body) == self.body_id)[0]

    def __repr__(self):
        return f"Actor({self.name}, body={self.body_id}, {self.px_body_type})"
