"""The least time of the rasterize stage, worked out from its inputs alone.

The stage takes each face's three screen corners, 1/z, validity, flat
colour and segmentation id, and yields per pixel the nearest face's depth,
segmentation id and colour. Whatever implements it, a frame needs:

- work: one coverage test for every pixel centre inside each valid face's
  screen bounding box (clipped to the image), of ``FLOP_PER_TEST``
  operations: three edge functions and the 1/z plane, each two fused
  multiply-adds;
- bytes: the inputs read once and, for each pixel, what the observation
  keeps of it written once (``OBS_BYTES_PER_PIXEL``: the camera's texture
  contract, rgb uint8, depth and segmentation int16). The stage's own
  float32 buffers are a choice of the present kernels: a design that keeps
  depth in registers and writes the obs's bytes directly writes no more.

The least time is the larger of work over the peak FP32 rate and bytes over
the peak memory bandwidth (``peaks.json``); a share of it is that least time
over the device time the stage took.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional

import torch

from .spec import load_json

FLOP_PER_TEST = 4 * 2 * 2  # four affine planes, each two FMAs of two operations
# bytes a pixel of each texture the observation keeps (rgbd: rgb and depth)
OBS_BYTES_PER_PIXEL = {"rgb": 3, "depth": 2, "segmentation": 2}


def obs_bytes_per_pixel(obs_mode: str) -> int:
    """Bytes a pixel of the textures an rgb obs mode (``rgb``, ``rgbd``,
    ``rgb+depth+segmentation``, ...) keeps."""
    parts = obs_mode.replace("rgbd", "rgb+depth").split("+")
    return sum(OBS_BYTES_PER_PIXEL[p] for p in parts)


def peaks(device_kind: str) -> Optional[Dict]:
    """The published peaks of a device by its name, None if not listed."""
    table = load_json(Path(__file__).resolve().parent / "peaks.json")
    return table.get(device_kind)


def coverage_tests(fx: torch.Tensor, fy: torch.Tensor, ok: torch.Tensor, height: int, width: int) -> int:
    """Pixel centres (x + 0.5, y + 0.5) inside each valid face's bounding
    box, clipped to the image, summed over the batch."""
    def span(lo, hi, n):
        first = torch.clamp(torch.ceil(lo - 0.5), min=0)
        last = torch.clamp(torch.floor(hi - 0.5), max=n - 1)
        return torch.clamp(last - first + 1, min=0)

    fx64, fy64 = fx.to(torch.float64), fy.to(torch.float64)
    nx = span(fx64.amin(-1), fx64.amax(-1), width)
    ny = span(fy64.amin(-1), fy64.amax(-1), height)
    valid = (ok != 0) & torch.isfinite(nx) & torch.isfinite(ny)
    return int(torch.where(valid, nx * ny, 0.0).sum().item())


def stage_bytes(fx: torch.Tensor, face_seg: torch.Tensor, height: int, width: int, pixel_bytes: int) -> int:
    """Inputs read once (corners x, y and 1/z, validity, colour: per face;
    the segmentation ids once) and ``pixel_bytes`` a pixel written once."""
    B, F = fx.shape[0], fx.shape[1]
    per_face = 3 * 4 + 3 * 4 + 3 * 4 + 4 + 3 * 4
    return B * F * per_face + face_seg.numel() * 4 + B * height * width * pixel_bytes


def least_seconds(tests: int, nbytes: int, peak: Dict):
    """(seconds, bound) with bound "compute" or "memory"."""
    t_flop = tests * FLOP_PER_TEST / peak["fp32_flops"]
    t_mem = nbytes / peak["hbm_bytes_per_s"]
    return (t_flop, "compute") if t_flop > t_mem else (t_mem, "memory")


def stage_least(calls, peak: Dict, obs_mode: str):
    """(seconds, bound) of the rasterize stage over the arguments of its
    calls, ``(fx, fy, inv_z, ok, face_rgb, face_seg, height, width)`` each,
    for a camera of ``obs_mode``; the bound names the longer side of the
    calls' sum."""
    tests = nbytes = 0
    for fx, fy, _, ok, _, face_seg, height, width in calls:
        tests += coverage_tests(fx, fy, ok, height, width)
        nbytes += stage_bytes(fx, face_seg, height, width, obs_bytes_per_pixel(obs_mode))
    return least_seconds(tests, nbytes, peak)


def brute_force_tests(fx, fy, ok, height: int, width: int) -> int:
    """The same count by visiting every pixel centre (for tests)."""
    n = 0
    for b in range(fx.shape[0]):
        for f in range(fx.shape[1]):
            if not ok[b, f]:
                continue
            x0, x1 = float(fx[b, f].min()), float(fx[b, f].max())
            y0, y1 = float(fy[b, f].min()), float(fy[b, f].max())
            if not all(map(math.isfinite, (x0, x1, y0, y1))):
                continue
            cols = sum(1 for x in range(width) if x0 <= x + 0.5 <= x1)
            rows = sum(1 for y in range(height) if y0 <= y + 0.5 <= y1)
            n += cols * rows
    return n
