"""Baked texturing for the rasterizer (counterpart of
maniskill_tpu/render/textures.py; numpy, build time only).

Textures are baked to geometry at load time: a textured surface becomes a
tessellated mesh whose per-face colours sample the texture at each face
centroid, so the rasterizer kernel stays flat-shaded. Only the procedural
wood texture and the bake helpers that the table scene uses are here.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def wood(size: int = 64, base=(0.585, 0.437, 0.296), seed: int = 0) -> np.ndarray:
    """(size, size, 3) float32 plank-style wood grain: long-wavelength rings +
    fine streaks."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    rings = 0.5 + 0.5 * np.sin(2 * np.pi * (6.0 * y + 1.5 * np.sin(2 * np.pi * x)))
    streak = np.zeros((size, size), np.float32)
    for f, a in ((23, 0.4), (47, 0.25), (89, 0.15)):
        ph = rng.uniform(0, 2 * np.pi)
        streak += a * np.sin(2 * np.pi * f * y + ph + 3.0 * x)
    tone = 0.82 + 0.18 * rings + 0.08 * streak
    img = np.asarray(base, np.float32)[None, None] * tone[..., None]
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def sample_bilinear(image: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Bilinear sample image (H, W, 3) at uv (..., 2) in [0, 1] (wrapping)."""
    H, W = image.shape[:2]
    u = np.mod(uv[..., 0], 1.0) * (W - 1)
    # v up -> row down: v=0 samples the bottom row, v=1 the top (OBJ/GL)
    v = (1.0 - np.mod(uv[..., 1], 1.0)) * (H - 1)
    x0 = np.floor(u).astype(np.int64)
    y0 = np.floor(v).astype(np.int64)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    c = (
        image[y0, x0] * (1 - fx) * (1 - fy)
        + image[y0, x1] * fx * (1 - fy)
        + image[y1, x0] * (1 - fx) * fy
        + image[y1, x1] * fx * fy
    )
    return c.astype(np.float32)


def bake_face_colors(faces: np.ndarray, uv: np.ndarray, image: np.ndarray,
                     shade: float = 1.0) -> np.ndarray:
    """Per-face colours = texture sampled at each face's UV centroid."""
    fuv = uv[np.asarray(faces, np.int64)].mean(axis=1)  # (F, 2)
    return np.clip(sample_bilinear(image, fuv) * shade, 0.0, 1.0)


def textured_quad_grid(
    half_x: float,
    half_y: float,
    image: np.ndarray,
    res: int = 12,
    z: float = 0.0,
    uv_tiles: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A z-up quad tessellated res x res with baked per-face texture colours.

    Returns (verts (V, 3), faces (F, 3), face_colors (F, 3)); F = 2*res^2.
    """
    xs = np.linspace(-half_x, half_x, res + 1, dtype=np.float32)
    ys = np.linspace(-half_y, half_y, res + 1, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([gx, gy, np.full_like(gx, z)], axis=-1).reshape(-1, 3)
    uv = np.stack(
        [(gx / (2 * half_x) + 0.5) * uv_tiles, (gy / (2 * half_y) + 0.5) * uv_tiles], axis=-1
    ).reshape(-1, 2)
    idx = np.arange((res + 1) * (res + 1)).reshape(res + 1, res + 1)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[1:, 1:].ravel()
    d = idx[:-1, 1:].ravel()
    # ccw seen from +z
    faces = np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)], axis=0).astype(np.int32)
    return verts, faces, bake_face_colors(faces, uv, image)
