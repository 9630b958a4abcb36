"""Batched ``Link`` view (counterpart of maniskill_tpu/structs/link.py).

A Link is a view over one body of the kinematic forest (or a fixed frame on a
body). Poses read the forward-kinematics cache in Data.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from ..utils.geometry import rotation_conversions as rc
from .pose import Pose

if TYPE_CHECKING:
    from ..envs.scene import ManiSkillScene


class Link:
    def __init__(
        self,
        scene: "ManiSkillScene",
        name: str,
        body_id: int,
        local_pose: Optional[np.ndarray] = None,
        index: int = 0,
        articulation=None,
    ):
        self.scene = scene
        self.name = name
        self.body_id = body_id
        # fixed offset from the body frame (merged fixed frames, e.g. TCP)
        self.local_pose = (
            np.asarray(local_pose, np.float32)
            if local_pose is not None
            else np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
        )
        self.index = index
        self.articulation = articulation
        self.joint = None  # backref set by the articulation builder
        self.per_scene_id = None

    @property
    def _identity_local(self) -> bool:
        return bool(
            np.allclose(self.local_pose[:3], 0.0)
            and np.allclose(self.local_pose[3:], [1, 0, 0, 0])
        )

    @property
    def pose(self) -> Pose:
        d = self.scene.data
        p = d.xpos[:, self.body_id]
        q = d.xquat[:, self.body_id]
        if not self._identity_local:
            lp = torch.as_tensor(self.local_pose[:3], device=p.device)
            lq = torch.as_tensor(self.local_pose[3:], device=p.device)
            p = p + rc.quaternion_apply(q, lp)
            q = rc.quaternion_multiply(q, lq)
        return Pose(torch.cat([p, q], -1))

    @property
    def linear_velocity(self) -> torch.Tensor:
        return self.scene.data.cvel[:, self.body_id, :3]

    @property
    def angular_velocity(self) -> torch.Tensor:
        return self.scene.data.cvel[:, self.body_id, 3:]

    def get_net_contact_forces(self) -> torch.Tensor:
        """(B, 3) net contact force on the link."""
        return self.scene.net_contact_forces_for_bodies([self.body_id])

    @property
    def geom_ids(self) -> np.ndarray:
        """The ids of this link's geoms in the model."""
        return np.nonzero(np.asarray(self.scene.model.geom_body) == self.body_id)[0]

    @property
    def is_root(self) -> bool:
        return self.articulation is not None and self.articulation.root is self

    def __repr__(self):
        return f"Link({self.name}, body={self.body_id})"
