"""Batched ``Articulation`` + ``ArticulationJoint`` views (counterpart of
maniskill_tpu/structs/articulation.py).

An articulation is a set of links (bodies) in the forest plus its active
(1-dof) joints; qpos/qvel/drive-target properties view gathered columns of
the batched state. Writes are masked by the scene's partial-reset mask.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional

import numpy as np
import torch

from ..physics.types import FREE, HINGE, SLIDE
from .link import Link
from .pose import Pose

if TYPE_CHECKING:
    from ..envs.scene import ManiSkillScene


class ArticulationJoint:
    def __init__(
        self,
        scene: "ManiSkillScene",
        name: str,
        body_id: int,
        jnt_type: int,
        q_adr: int,
        dof_adr: int,
        active_index: Optional[int],
        parent_link: Optional[Link],
        child_link: Optional[Link],
    ):
        self.scene = scene
        self.name = name
        self.body_id = body_id
        self.jnt_type = jnt_type
        self.q_adr = q_adr
        self.dof_adr = dof_adr
        self.active_index = active_index
        self.parent_link = parent_link
        self.child_link = child_link

    @property
    def type(self) -> str:
        return {FREE: "free", HINGE: "revolute", SLIDE: "prismatic"}.get(self.jnt_type, "fixed")

    @property
    def qpos(self) -> torch.Tensor:
        return self.scene.data.qpos[:, self.q_adr : self.q_adr + 1]

    @property
    def qvel(self) -> torch.Tensor:
        return self.scene.data.qvel[:, self.dof_adr : self.dof_adr + 1]

    @property
    def limits(self) -> torch.Tensor:
        """(2,) limits of this dof, or (B, 2) once set per env (gathered on
        the dof axis, as ``Articulation.qlimits``)."""
        return self.scene.model.dof_limit[..., self.dof_adr, :]

    @property
    def drive_target(self) -> torch.Tensor:
        return self.scene.data.drive_target[:, self.dof_adr : self.dof_adr + 1]

    def _write(self, field: str, target):
        """Write a shared or per-env (B,) value into this dof's column of
        ``Data.<field>``, masked by the partial-reset mask."""
        scene = self.scene
        if not isinstance(target, torch.Tensor):
            target = np.asarray(target, np.float32)
        col = scene.to_batch(target.reshape(-1, 1), 1)
        d = scene.data
        cols = slice(self.dof_adr, self.dof_adr + 1)
        scene.data = d.replace(**{field: scene.write_cols(getattr(d, field), cols, col)})

    def set_drive_target(self, target):
        self._write("drive_target", target)

    def set_drive_velocity_target(self, target):
        self._write("drive_vel_target", target)

    def set_drive_properties(self, stiffness, damping, force_limit=np.inf, mode="force"):
        """Update this dof's PD gains in the model."""
        self.scene.set_drive_properties([self.dof_adr], stiffness, damping, force_limit)


class Articulation:
    def __init__(self, scene: "ManiSkillScene", name: str):
        self.scene = scene
        self.name = name
        self.links: List[Link] = []
        self.links_map: Dict[str, Link] = {}
        self.joints: List[ArticulationJoint] = []
        self.joints_map: Dict[str, ArticulationJoint] = {}
        self.active_joints: List[ArticulationJoint] = []
        self.root: Optional[Link] = None
        self.fixed_root = True
        self.root_q_adr: Optional[int] = None  # set when the root joint is FREE
        self.root_dof_adr: Optional[int] = None
        self._qadr: Optional[torch.Tensor] = None  # qpos columns of active joints
        self._vadr: Optional[torch.Tensor] = None  # qvel columns

    def _finalize_indices(self):
        dev = self.scene.device
        self._qadr = torch.tensor([j.q_adr for j in self.active_joints], dtype=torch.int64, device=dev)
        self._vadr = torch.tensor([j.dof_adr for j in self.active_joints], dtype=torch.int64, device=dev)

    @property
    def dof(self) -> int:
        return len(self.active_joints)

    @property
    def max_dof(self) -> int:
        return self.dof

    def get_link(self, name: str) -> Link:
        return self.links_map[name]

    # -- joint state -----------------------------------------------------
    @property
    def qpos(self) -> torch.Tensor:
        return self.scene.data.qpos[:, self._qadr]

    @qpos.setter
    def qpos(self, value):
        self.set_qpos(value)

    def set_qpos(self, value):
        scene = self.scene
        d = scene.data
        scene.data = d.replace(
            qpos=scene.write_cols(d.qpos, self._qadr, scene.to_batch(value, self.dof))
        )

    @property
    def qvel(self) -> torch.Tensor:
        return self.scene.data.qvel[:, self._vadr]

    @qvel.setter
    def qvel(self, value):
        self.set_qvel(value)

    def set_qvel(self, value):
        scene = self.scene
        d = scene.data
        scene.data = d.replace(
            qvel=scene.write_cols(d.qvel, self._vadr, scene.to_batch(value, self.dof))
        )

    @property
    def qlimits(self) -> torch.Tensor:
        """(B, dof, 2) joint limits of the active joints, each env's own once
        the limits are set per env."""
        lim = self.scene.model.dof_limit[..., self._vadr, :]
        return lim.expand(self.scene.num_envs, self.dof, 2)

    # -- root ------------------------------------------------------------
    @property
    def pose(self) -> Pose:
        return self.root_pose

    @pose.setter
    def pose(self, p):
        self.set_root_pose(p)

    @property
    def root_pose(self) -> Pose:
        d = self.scene.data
        if self.fixed_root:
            b = self.root.body_id
            return Pose(torch.cat([d.xpos[:, b], d.xquat[:, b]], -1))
        qa = self.root_q_adr
        return Pose(d.qpos[:, qa : qa + 7])

    def set_root_pose(self, pose):
        if self.fixed_root:
            raise RuntimeError(f"articulation {self.name} has a fixed root; rebuild to move it")
        scene = self.scene
        qa = self.root_q_adr
        d = scene.data
        raw = scene.to_batch(Pose.create(pose).raw_pose, 7)
        scene.data = d.replace(qpos=scene.write_cols(d.qpos, slice(qa, qa + 7), raw))

    @property
    def root_linear_velocity(self) -> torch.Tensor:
        if self.fixed_root:
            return torch.zeros(self.scene.num_envs, 3, device=self.scene.device)
        va = self.root_dof_adr
        return self.scene.data.qvel[:, va : va + 3]

    @property
    def root_angular_velocity(self) -> torch.Tensor:
        if self.fixed_root:
            return torch.zeros(self.scene.num_envs, 3, device=self.scene.device)
        va = self.root_dof_adr
        return self.scene.data.qvel[:, va + 3 : va + 6]

    # -- drives ----------------------------------------------------------
    def _write_targets(self, field: str, targets, joints):
        """Write ``targets`` into the columns of ``joints`` (the active joints
        by default) of ``Data.<field>``, masked by the partial-reset mask."""
        scene = self.scene
        cols = self._vadr if joints is None else torch.tensor(
            [j.dof_adr for j in joints], dtype=torch.int64, device=scene.device)
        d = scene.data
        scene.data = d.replace(**{field: scene.write_cols(getattr(d, field), cols, scene.to_batch(targets, len(cols)))})

    def set_joint_drive_targets(self, targets, joints: Optional[List[ArticulationJoint]] = None):
        """Write PD position targets."""
        self._write_targets("drive_target", targets, joints)

    def set_joint_drive_velocity_targets(self, targets, joints: Optional[List[ArticulationJoint]] = None):
        self._write_targets("drive_vel_target", targets, joints)

    @property
    def drive_targets(self) -> torch.Tensor:
        return self.scene.data.drive_target[:, self._vadr]

    @property
    def drive_velocity_targets(self) -> torch.Tensor:
        return self.scene.data.drive_vel_target[:, self._vadr]

    # -- state dict (13 + 2*dof layout) -----------------------------------
    def get_state(self) -> torch.Tensor:
        return torch.cat(
            [self.root_pose.raw_pose, self.root_linear_velocity,
             self.root_angular_velocity, self.qpos, self.qvel], -1
        )

    def set_state(self, state):
        scene = self.scene
        state = scene.to_batch(state, 13 + 2 * self.dof)
        if not self.fixed_root:
            self.set_root_pose(Pose(state[..., :7]))
            qa = self.root_dof_adr
            d = scene.data
            scene.data = d.replace(
                qvel=scene.write_cols(d.qvel, slice(qa, qa + 6), state[..., 7:13])
            )
        n = self.dof
        self.set_qpos(state[..., 13 : 13 + n])
        self.set_qvel(state[..., 13 + n : 13 + 2 * n])

    # -- contacts --------------------------------------------------------
    def get_net_contact_forces(self, link_names: Optional[List[str]] = None) -> torch.Tensor:
        """(B, L, 3) net contact force on each named link (every link by
        default)."""
        links = [self.links_map[n] for n in link_names] if link_names else self.links
        return self.scene.net_contact_forces_per_body([link.body_id for link in links])

    def __repr__(self):
        return f"Articulation({self.name}, dof={self.dof}, links={len(self.links)})"
