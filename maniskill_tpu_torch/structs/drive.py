"""Drive struct (counterpart of maniskill_tpu/structs/drive.py).

A batched view over one body-body 6-dof drive: set the target relative pose
(per env, reset-masked) and tune its gains. The teleoperation CLIs drag
objects with it, a spring-damper instead of a teleport.
"""
from __future__ import annotations

import numpy as np

from .pose import Pose


class Drive:
    def __init__(self, scene, drive_id: int, body1: int, body2: int):
        self.scene = scene
        self.drive_id = drive_id
        self.body1 = body1
        self.body2 = body2

    def set_drive_target(self, pose):
        """Target relative pose of frame 2 in frame 1 (per env, masked)."""
        scene = self.scene
        d = scene.data
        raw = scene.to_batch(Pose.create(pose).raw_pose, 7)
        scene.data = d.replace(drive6_target=scene.write_cols(d.drive6_target, self.drive_id, raw))

    @property
    def drive_target(self) -> Pose:
        return Pose(self.scene.data.drive6_target[:, self.drive_id])

    def set_drive_property(self, stiffness=None, damping=None, force_limit=None,
                           angular_stiffness=None, angular_damping=None):
        """Update the gains (shared by every env: model level)."""
        m = self.scene.model
        i = self.drive_id
        ks, kd, lim = m.drive6_stiffness.clone(), m.drive6_damping.clone(), m.drive6_force_limit.clone()
        # python floats are written on the device: no host-to-device copy
        if stiffness is not None:
            ks[i, 0] = float(stiffness)
        if angular_stiffness is not None:
            ks[i, 1] = float(angular_stiffness)
        if damping is not None:
            kd[i, 0] = float(damping)
        if angular_damping is not None:
            kd[i, 1] = float(angular_damping)
        if force_limit is not None:
            fl = np.asarray(force_limit, np.float32).reshape(-1)
            lim[i, 0] = float(fl[0])
            lim[i, 1] = float(fl[-1])
        self.scene.model = m.replace(drive6_stiffness=ks, drive6_damping=kd, drive6_force_limit=lim)
