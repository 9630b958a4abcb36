"""StereoDepthCamera (counterpart of maniskill_tpu/sensors/depth_camera.py).

Active stereo depth, approximated physically: depth is rendered from two
horizontally offset eyes, pixels whose disparities disagree (occluded in
one eye) are invalidated, and depth is quantized to the disparity
resolution, which gives stereo's occlusion shadows and quantization bands
without an IR pipeline. Each observation renders two frames, each one
launch of the tiled-rasterizer kernel on the card: the left eye (the
camera's own, which also serves rgb and segmentation) and the right eye.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from ..physics.kinematics import geom_poses
from ..render.rasterizer import rasterize
from .camera import Camera, CameraConfig


@dataclasses.dataclass
class StereoDepthCameraConfig(CameraConfig):
    baseline: float = 0.055  # a RealSense D435's
    disparity_bits: int = 8

    @property
    def uuid(self):
        return self.uid


def stereo_depth(z_l: torch.Tensor, z_r: torch.Tensor, fx: float, baseline: float, levels: int) -> torch.Tensor:
    """(B, H, W) left and right metric depths (0 = background) -> the
    (B, H, W, 1) int16 millimetre depth of the stereo pair: the left eye's
    depth where the two disparities agree within 2 px, quantized to
    ``levels`` disparity steps, 0 elsewhere."""
    # fx * baseline as a tensor: ``scalar / tensor`` is a reciprocal and a
    # product in torch, which rounds differently from a division
    fb = torch.full_like(z_l, fx * baseline)
    disp_l = torch.where(z_l > 0, fb / torch.clamp(z_l, min=1e-4), 0.0)
    disp_r = torch.where(z_r > 0, fb / torch.clamp(z_r, min=1e-4), 0.0)
    valid = torch.abs(disp_l - disp_r) < 2.0
    max_disp = fx * baseline / 0.05
    disp_q = torch.round(disp_l / max_disp * levels) * (max_disp / levels)
    z_q = torch.where((disp_q > 0) & valid, fb / torch.clamp(disp_q, min=1e-6), 0.0)
    return torch.clamp(z_q * 1000.0, 0, 32767).to(torch.int16)[..., None]


class StereoDepthCamera(Camera):
    def __init__(self, config: StereoDepthCameraConfig, scene):
        super().__init__(config, scene)
        self.baseline = getattr(config, "baseline", 0.055)
        self.disparity_levels = 2 ** getattr(config, "disparity_bits", 8)

    def right_view_matrix(self) -> torch.Tensor:
        """(B, 4, 4) world -> the right eye's OpenGL frame: the left eye's
        moved ``baseline`` along its +x (the ROS camera's -y)."""
        view = self._view_matrix()
        view[:, 0, 3] -= self.baseline
        return view

    def get_obs(self, rgb=True, depth=True, segmentation=False, position=False, normal=False,
                apply_texture_transforms=True, hidden_actors: Sequence = ()) -> Dict[str, torch.Tensor]:
        mesh, buf_l = self.capture(hidden_actors)
        if normal:  # normals come from the face-chunked path: a frame of its own
            out = super().get_obs(rgb=rgb, segmentation=segmentation, position=position, normal=True,
                                  hidden_actors=hidden_actors)
        else:
            out = self.obs_from_buffer(buf_l, rgb=rgb, segmentation=segmentation, position=position)
        if not depth:
            return out
        gpos, gquat = geom_poses(self.scene.model, self.scene.data)
        buf_r = rasterize(
            mesh, mesh.world_vertices(gpos, gquat), self.right_view_matrix(), self.proj,
            self.config.height, self.config.width, lights=self.scene.lights,
        )
        out["depth"] = stereo_depth(buf_l["depth"], buf_r["depth"], self.fx, self.baseline, self.disparity_levels)
        return out
