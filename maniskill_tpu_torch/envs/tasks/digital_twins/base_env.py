"""Digital-twin base environment with greenscreen compositing (counterpart
of maniskill_tpu/envs/tasks/digital_twins/base_env.py).

A real "inpainting" photograph is composited over every pixel whose
segmentation id is not in a keep-set (the robot and the manipulated
objects), so a policy sees the simulated foreground on a real background.
The keep-set is a bool lookup table over segmentation ids, built at
reconfigure; the composite is one ``torch.where`` on the device. The
overlay is read from its file when the file exists, and is otherwise the
deterministic procedural stand-in image (the task's own semantics in both
packages); ``overlay_sources`` says which of the two each camera uses.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ....structs.articulation import Articulation
from ...base_env import BaseEnv


def procedural_overlay_image(width: int, height: int, seed: int = 7) -> np.ndarray:
    """A deterministic synthetic "real background" (uint8 HxWx3): a warm wall
    fading into a cooler tabletop, soft blobs and a little noise."""
    rng = np.random.RandomState(seed)
    y = np.linspace(0.0, 1.0, height)[:, None]
    x = np.linspace(0.0, 1.0, width)[None, :]
    wall = np.stack([0.62 + 0.1 * y, 0.55 + 0.08 * y, 0.48 + 0.05 * y], axis=-1)
    table = np.stack([0.45 + 0.05 * x, 0.38 + 0.04 * x, 0.32 + 0.03 * x], axis=-1)
    t = 1.0 / (1.0 + np.exp(-(y - 0.55) * 18.0))[..., None]
    img = wall * (1 - t) + table * t
    for _ in range(6):  # furniture and shadow stand-ins
        cy, cx = rng.uniform(0, 1, 2)
        r = rng.uniform(0.05, 0.2)
        tint = rng.uniform(-0.12, 0.12, 3)
        d2 = (y - cy) ** 2 + (x - cx) ** 2
        img = img + np.exp(-d2 / (2 * r * r))[..., None] * tint[None, None]
    img = img + rng.normal(0, 0.01, img.shape)  # sensor-noise texture
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def load_overlay_image(path: str, width: int, height: int) -> np.ndarray:
    """An overlay PNG/JPG bilinearly resized to (height, width, 3) uint8
    (needs PIL)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading the greenscreen overlay {path!r} needs PIL (pillow), which is not "
                          f"installed") from e
    img = Image.open(path).convert("RGB").resize((width, height), Image.BILINEAR)
    return np.asarray(img, np.uint8)


class BaseDigitalTwinEnv(BaseEnv):
    """Base class of the real2sim/sim2real digital-twin envs.

    Subclasses set ``rgb_overlay_paths`` (camera name -> image path) and
    call :meth:`remove_object_from_greenscreen` for each foreground object
    in ``_load_scene``; the robot's links are always kept.
    """

    rgb_overlay_paths: Optional[Dict[str, str]] = None
    rgb_overlay_mode: str = "background"  # "background" | "debug" | "none"

    def __init__(self, **kwargs):
        self._greenscreen_keep: List = []
        self._keep_lut: Optional[torch.Tensor] = None
        self._rgb_overlay_images: Dict[str, torch.Tensor] = {}
        # camera name -> "file" or "procedural": which overlay it composites
        self.overlay_sources: Dict[str, str] = {}
        super().__init__(**kwargs)

    def remove_object_from_greenscreen(self, obj):
        """Keep ``obj`` rendered from the simulation (out of the overlay)."""
        if isinstance(obj, Articulation):
            self._greenscreen_keep.extend(obj.links)
        else:
            self._greenscreen_keep.append(obj)

    def _after_reconfigure(self, options: dict):
        super()._after_reconfigure(options)
        if self.rgb_overlay_mode == "none" or not self.rgb_overlay_paths:
            return
        for agent in getattr(self.agent, "agents", [self.agent]):
            self.remove_object_from_greenscreen(agent.robot)
        keep_ids = sorted({int(o.per_scene_id) for o in self._greenscreen_keep if o.per_scene_id is not None})
        lut = np.zeros(int(self.scene._next_seg_id) + 1, bool)
        lut[np.asarray(keep_ids, np.int64)] = True
        self._keep_lut = torch.as_tensor(lut, device=self.device)
        self._greenscreen_keep = []
        for cam_name, path in self.rgb_overlay_paths.items():
            cfg = self._sensor_configs[cam_name]
            if path is not None and os.path.exists(path):
                img, source = load_overlay_image(path, cfg.width, cfg.height), "file"
            else:
                img, source = procedural_overlay_image(cfg.width, cfg.height), "procedural"
            self._rgb_overlay_images[cam_name] = torch.as_tensor(img, device=self.device)
            self.overlay_sources[cam_name] = source

    def _green_screen_rgb(self, rgb: torch.Tensor, segmentation: torch.Tensor, overlay_img: torch.Tensor):
        """The simulated rgb (B, H, W, 3) uint8 where the segmentation
        (B, H, W, 1) id is kept, the overlay (H, W, 3) uint8 elsewhere."""
        seg = torch.clamp(segmentation[..., 0].long(), 0, self._keep_lut.shape[0] - 1)
        keep = self._keep_lut[seg][..., None]
        if self.rgb_overlay_mode == "debug":
            return (rgb.float() * 0.5 + overlay_img[None].float() * 0.5).to(torch.uint8)
        return torch.where(keep, rgb, overlay_img[None])

    def _get_obs_with_sensor_data(self, info: dict):
        obs = super()._get_obs_with_sensor_data(info)
        if self.rgb_overlay_mode == "none" or not self._rgb_overlay_images or self._keep_lut is None:
            return obs
        for cam_name, overlay in self._rgb_overlay_images.items():
            cam = obs["sensor_data"].get(cam_name)
            if cam is None or "rgb" not in cam or "segmentation" not in cam:
                continue
            cam["rgb"] = self._green_screen_rgb(cam["rgb"], cam["segmentation"], overlay)
        return obs
