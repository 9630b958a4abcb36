"""Obs-mode parsing and the pointcloud conversion (counterpart of
maniskill_tpu/envs/utils/observations.py).

Obs modes compose with '+' (e.g. "rgb+depth+segmentation"); "rgbd" is an
alias for "rgb+depth".
"""
from __future__ import annotations

from typing import Dict

import torch

MODALITIES = ("rgb", "depth", "segmentation", "position", "normal", "albedo")


def parse_obs_mode_to_struct(obs_mode: str) -> Dict[str, bool]:
    struct = {m: False for m in MODALITIES}
    struct["state"] = False
    struct["state_dict"] = False
    if obs_mode in ("state", "state_dict", "none"):
        struct[obs_mode if obs_mode != "none" else "state"] = obs_mode != "none"
        struct["use_state"] = obs_mode in ("state", "state_dict")
        return struct
    if obs_mode == "rgbd":
        obs_mode = "rgb+depth"
    if obs_mode == "pointcloud":
        struct["position"] = True
        struct["rgb"] = True
        struct["segmentation"] = True
        struct["use_state"] = False
        return struct
    for part in obs_mode.split("+"):
        part = part.strip()
        if part == "state":
            struct["state"] = True
        elif part in MODALITIES:
            struct[part] = True
        else:
            raise ValueError(f"unknown obs modality {part!r} in {obs_mode!r}")
    struct["use_state"] = struct["state"]
    return struct


def sensor_data_to_pointcloud(obs: dict, sensors: dict = None) -> dict:
    """Merge every camera's position map into one world-frame pointcloud:
    millimetres to metres, the camera-to-world (OpenGL) transform, then the
    cameras concatenated. ``xyzw``'s w is 1 on geometry and 0 on the
    background; rgb and segmentation ride along per point. ``sensors`` is
    taken for the JAX package's signature and, as there, not read."""
    sensor_data = obs.pop("sensor_data")
    params = obs.pop("sensor_param")
    pcds = {"xyzw": [], "rgb": [], "segmentation": []}
    for name, data in sensor_data.items():
        pos = data["position"].to(torch.float32) / 1000.0
        B = pos.shape[0]
        valid = data.get("position_valid")
        if valid is None:
            valid = torch.ones(pos.shape[:3], dtype=torch.bool, device=pos.device)
        c2w = params[name]["cam2world_gl"]  # (B, 4, 4)
        pw = torch.einsum("bij,bnj->bni", c2w[:, :3, :3], pos.reshape(B, -1, 3)) + c2w[:, None, :3, 3]
        pcds["xyzw"].append(torch.cat([pw, valid.reshape(B, -1, 1).to(torch.float32)], -1))
        if "rgb" in data:
            pcds["rgb"].append(data["rgb"].reshape(B, -1, 3))
        if "segmentation" in data:
            pcds["segmentation"].append(data["segmentation"].reshape(B, -1, 1))
    obs["pointcloud"] = {k: torch.cat(v, 1) for k, v in pcds.items() if v}
    return obs
