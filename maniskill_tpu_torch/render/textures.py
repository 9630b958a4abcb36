"""Baked texturing for the rasterizer (counterpart of
maniskill_tpu/render/textures.py; numpy, build time only).

Textures are baked to geometry at load time: a textured surface becomes a
tessellated mesh whose per-face colours sample the texture at each face
centroid, so the rasterizer kernel stays flat-shaded. Procedural images
(checker, wood, speckle), UV-OBJ + MTL loading for real textured assets (YCB
``textured.obj``) and the bake helpers. ``load_image`` reads PNG with the
standard library's zlib (``read_png``); other formats need Pillow.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def checker(size: int = 64, tiles: int = 8, c1=(0.82, 0.80, 0.76), c2=(0.35, 0.33, 0.30)) -> np.ndarray:
    """(size, size, 3) float32 checkerboard of ``tiles`` x ``tiles`` squares."""
    y, x = np.mgrid[0:size, 0:size]
    m = ((x * tiles // size) + (y * tiles // size)) % 2
    img = np.where(m[..., None] == 0, np.asarray(c1, np.float32), np.asarray(c2, np.float32))
    return img.astype(np.float32)


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


def speckle(size: int = 64, base=(0.5, 0.5, 0.5), amp: float = 0.12, seed: int = 0) -> np.ndarray:
    """(size, size, 3) float32 blocky speckle: ``base`` scaled by uniform
    noise in 4x4 blocks."""
    rng = np.random.RandomState(seed)
    n = rng.uniform(-1.0, 1.0, (size // 4, size // 4, 1)).astype(np.float32)
    n = np.kron(n, np.ones((4, 4, 1), np.float32))
    img = np.asarray(base, np.float32)[None, None] * (1.0 + amp * n)
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


# ---------------------------------------------------------------------------
# real textured assets: OBJ with vt / f v/vt and the MTL's map_Kd
# ---------------------------------------------------------------------------
def load_obj_with_uv(path: str):
    """Parse an OBJ keeping UVs: (verts, faces, uv_per_corner (F, 3, 2),
    texture image or None). Handles 'f v/vt' indices (polygons fanned into
    triangles) and the MTL's map_Kd."""
    verts, vts, faces, fuv = [], [], [], []
    mtl_file = None
    base = Path(path).parent
    for line in Path(path).read_text(errors="ignore").splitlines():
        if line.startswith("v "):
            verts.append([float(x) for x in line.split()[1:4]])
        elif line.startswith("vt "):
            vals = line.split()[1:3]
            vts.append([float(vals[0]), float(vals[1])])
        elif line.startswith("mtllib "):
            mtl_file = line.split(None, 1)[1].strip()
        elif line.startswith("f "):
            vi, ti = [], []
            for p in line.split()[1:]:
                comps = p.split("/")
                vi.append(int(comps[0]) - 1)
                ti.append(int(comps[1]) - 1 if len(comps) > 1 and comps[1] else -1)
            for k in range(1, len(vi) - 1):
                faces.append([vi[0], vi[k], vi[k + 1]])
                fuv.append([ti[0], ti[k], ti[k + 1]])
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    vts = np.asarray(vts, np.float32) if vts else np.zeros((1, 2), np.float32)
    uv_corner = vts[np.maximum(np.asarray(fuv, np.int64), 0)]  # (F, 3, 2)

    image = None
    if mtl_file is not None and (base / mtl_file).exists():
        for line in (base / mtl_file).read_text(errors="ignore").splitlines():
            if line.strip().startswith("map_Kd"):
                tp = base / line.split(None, 1)[1].strip()
                if tp.exists():
                    image = load_image(str(tp))
                break
    return verts, faces, uv_corner, image


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}  # colour type -> samples per pixel


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five scanline filters (None, Sub, Up, Average, Paeth)."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:  # Up
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: pixel by pixel, the channels at once
            cur = np.zeros(stride, np.int64)
            left = np.zeros(bpp, np.int64)
            upleft = np.zeros(bpp, np.int64)
            for x in range(0, stride, bpp):
                up = prev[x:x + bpp]
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - upleft
                    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
                    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
                left = (line[x:x + bpp] + pred) & 0xFF
                cur[x:x + bpp] = left
                upleft = up
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced PNG of colour type 0 (grey), 2 (RGB), 3
    (palette) or 6 (RGBA) as an (H, W, 3) uint8 RGB array, with the standard
    library's zlib (alpha dropped, grey replicated, palette looked up, as
    Pillow's ``convert("RGB")`` gives). Raises ``ValueError`` for other PNGs
    and for a file that is not a PNG."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG")
    pos, idat, palette, header = 8, [], None, None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace != 0 or ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: unsupported PNG, bit depth {depth}, colour type {ctype}, interlace {interlace}")
    bpp = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, height, width * bpp, bpp).reshape(height, width, bpp)
    if ctype == 0:
        return np.repeat(px, 3, axis=-1)
    if ctype == 3:
        return palette[px[..., 0]]
    return np.ascontiguousarray(px[..., :3])


def load_image(path: str) -> Optional[np.ndarray]:
    """An image file as (H, W, 3) float32 RGB in [0, 1], or None where it
    cannot be read: PNG through ``read_png``, anything else (and PNGs it does
    not decode) through Pillow where Pillow is installed."""
    try:
        return read_png(path).astype(np.float32) / 255.0
    except (OSError, ValueError, zlib.error, struct.error):
        pass
    try:
        from PIL import Image
    except ImportError:
        return None
    try:
        return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    except (OSError, ValueError):
        return None


def bake_obj_face_colors(path: str, fallback=(0.7, 0.7, 0.7)):
    """Load a textured OBJ and bake per-face centroid-UV colours: (verts,
    faces, face_colors); a flat ``fallback`` tone where the texture is
    missing."""
    verts, faces, uv_corner, image = load_obj_with_uv(path)
    if image is not None and len(faces):
        face_colors = sample_bilinear(image, uv_corner.mean(axis=1))
    else:
        face_colors = np.tile(np.asarray(fallback, np.float32), (len(faces), 1))
    return verts, faces, face_colors
