# Frozen copy of maniskill_tpu_torch/render/rasterizer.py (without SceneMesh.build) at the benchmark's first version:
# the benchmark's plain reference. It imports nothing of the program and is
# never edited to follow it.
"""Batched triangle rasterizer on torch tensors (counterpart of
maniskill_tpu/render/rasterizer.py).

All (num_envs x num_cams) views render in one batched pass reading the body
poses the physics step just wrote. Colour/depth/segmentation go through the
tiled rasterizer (``tiled_rasterizer.rasterize_tiles``: two CUDA kernels on
the card); the normal/albedo extra textures go through the face-chunked
coverage pass and ``_shade``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .types import HULL
from . import rotation_conversions as rc
from .tiled_raster import rasterize_tiles_ref as rasterize_tiles

FACE_CHUNK = 64


def _spread3(x: np.ndarray) -> np.ndarray:
    """Spread 10 bits of x so consecutive bits land 3 apart (Morton)."""
    x = x.astype(np.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _spatial_face_order(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Morton order of face centroids (local coords): spatially sorted faces
    keep each band's face list a few tight surface patches."""
    cen = np.asarray(verts, np.float64)[np.asarray(faces)].mean(axis=1)
    lo = cen.min(axis=0)
    ext = np.maximum(cen.max(axis=0) - lo, 1e-9)
    q = np.clip(((cen - lo) / ext) * 1023.0, 0, 1023).astype(np.int64)
    code = (_spread3(q[:, 0]) << 2) | (_spread3(q[:, 1]) << 1) | _spread3(q[:, 2])
    return np.argsort(code, kind="stable")


class SceneMesh:
    """Static scene geometry compiled for rendering.

    Per-geom meshes are concatenated; verts are stored in geom-local coords
    with a per-vertex geom index, so the world transform is one gather +
    quaternion rotate per frame. Where geometry differs between envs
    (per-env hulls or primitive sizes) the local table is per env,
    (B, V, 3), over one face table shared by every env.
    """

    def __init__(self, verts, faces, vert_geom, face_geom, face_color, face_seg, device):
        # (V, 3) shared local verts, or (B, V, 3) per env
        self.verts = torch.as_tensor(np.asarray(verts, np.float32), device=device)
        self.faces = np.asarray(faces, np.int64)  # (F, 3) vertex ids (static)
        self.vert_geom = np.asarray(vert_geom)  # (V,) geom id (static)
        self.face_geom = np.asarray(face_geom)  # (F,)
        self.face_color = torch.as_tensor(np.asarray(face_color, np.float32), device=device)
        self.face_seg = torch.as_tensor(np.asarray(face_seg, np.int32), device=device)
        self.num_faces = int(self.faces.shape[0])
        self._faces_t = torch.as_tensor(self.faces, device=device)
        self._vert_geom_t = torch.as_tensor(self.vert_geom.astype(np.int64), device=device)
        self._all_faces = torch.ones(self.num_faces, dtype=torch.bool, device=device)
        self._light_cache: Dict[int, tuple] = {}

    def world_vertices(self, gpos: torch.Tensor, gquat: torch.Tensor) -> torch.Tensor:
        """Local verts to world: gpos/gquat (B, ngeom, ...) -> (B, V, 3)."""
        vp = gpos[:, self._vert_geom_t]
        vq = gquat[:, self._vert_geom_t]
        return vp + rc.quaternion_apply(vq, self.verts if self.verts.ndim == 3 else self.verts[None])

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Per-vertex (B, V, ...) -> per-face corner (B, F, 3, ...)."""
        return x[:, self._faces_t]


def look_at_matrix(eye, target, up=(0, 0, 1)) -> np.ndarray:
    """World->camera (OpenGL convention: -z forward) 4x4 view matrix."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(fwd, [0, 1, 0])
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = right, true_up, -fwd
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def perspective_matrix(fov: float, aspect: float, near: float, far: float) -> np.ndarray:
    f = 1.0 / np.tan(fov / 2)
    m = np.zeros((4, 4))
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def _screen_faces(mesh: SceneMesh, world_verts, view, proj, height: int, width: int):
    """Per-face corner screen x/y, camera depth and in-front flags, each
    (B, F, 3)."""
    vh = torch.cat([world_verts, torch.ones_like(world_verts[..., :1])], -1)
    cam = torch.einsum("bij,bvj->bvi", view, vh)
    clip = torch.einsum("ij,bvj->bvi" if proj.ndim == 2 else "bij,bvj->bvi", proj, cam)
    w = clip[..., 3:4]
    ndc = clip[..., :3] / torch.where(torch.abs(w) < 1e-6, 1e-6, w)
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[..., 1] * 0.5) * height
    zcam = -cam[..., 2]
    return mesh.gather(sx), mesh.gather(sy), mesh.gather(zcam), mesh.gather(zcam > 1e-4)


def _face_mask(mesh: SceneMesh, face_mask, device) -> torch.Tensor:
    if face_mask is None:
        return mesh._all_faces
    return torch.as_tensor(np.asarray(face_mask, bool), device=device)


def tiled_inputs(
    mesh: SceneMesh,
    world_verts: torch.Tensor,
    view: torch.Tensor,
    proj: torch.Tensor,
    height: int,
    width: int,
    face_mask: Optional[np.ndarray] = None,
    lights: Optional[List[dict]] = None,
):
    """The arguments ``rasterize`` hands to ``rasterize_tiles``: (fx, fy,
    inv_z, ok, face_rgb, face_seg), with back faces culled."""
    fx, fy, fz, ffront = _screen_faces(mesh, world_verts, view, proj, height, width)
    fmask = _face_mask(mesh, face_mask, world_verts.device)
    # backface culling: consistent outward winding means front faces have
    # negative signed area in (y-down) screen coords
    area2 = (fx[..., 1] - fx[..., 0]) * (fy[..., 2] - fy[..., 0]) - (
        fx[..., 2] - fx[..., 0]
    ) * (fy[..., 1] - fy[..., 0])
    ok = (ffront.all(-1) & fmask[None] & (area2 < 0.0)).to(torch.int32)
    inv_z = 1.0 / torch.clamp(fz, min=1e-6)
    return fx, fy, inv_z, ok, _face_rgb(mesh, world_verts, lights), mesh.face_seg


def rasterize(
    mesh: SceneMesh,
    world_verts: torch.Tensor,  # (B, V, 3)
    view: torch.Tensor,  # (B, 4, 4) world->camera (GL)
    proj: torch.Tensor,  # (4, 4) or (B, 4, 4)
    height: int,
    width: int,
    face_mask: Optional[np.ndarray] = None,  # (F,) static visibility
    lights: Optional[List[dict]] = None,
    want_normal: bool = False,
    want_albedo: bool = False,
) -> Dict[str, torch.Tensor]:
    """Render colour/depth/segmentation buffers for B views.

    Returns dict with depth (B, H, W) camera-space metres (0 = background),
    seg (B, H, W) int32 (0 = background), valid (B, H, W) bool, color
    (B, H, W, 3) in [0, 1], dropped () int32, always 0 (the tiled path
    walks every band's whole face list).
    """
    if not (want_normal or want_albedo):
        zbuf, seg, rgb, dropped = rasterize_tiles(
            *tiled_inputs(mesh, world_verts, view, proj, height, width, face_mask, lights),
            height, width,
        )
        valid = seg >= 0
        return dict(
            depth=torch.where(valid, zbuf, 0.0),
            seg=torch.where(valid, seg, 0),
            valid=valid,
            color=rgb,
            dropped=dropped,
        )

    # face-chunked coverage with a running z-buffer (both sides rendered);
    # the chunk keeps the (B, chunk, H, W) intermediates bounded
    B, F = world_verts.shape[0], mesh.num_faces
    fx, fy, fz, ffront = _screen_faces(mesh, world_verts, view, proj, height, width)
    fmask = _face_mask(mesh, face_mask, world_verts.device)
    dev = world_verts.device
    py = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[:, None]
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :]
    big = 1e9
    zbuf = torch.full((B, height, width), big, device=dev)
    fbuf = torch.full((B, height, width), -1, dtype=torch.int32, device=dev)
    fmask_np = fmask.cpu().numpy()
    chunk = max(4, min(FACE_CHUNK, (64 * 1024 * 1024) // max(1, B * height * width)))
    for lo in range(0, F, chunk):
        hi = min(lo + chunk, F)
        if not fmask_np[lo:hi].any():
            continue
        x0, x1, x2 = (fx[:, lo:hi, k][..., None, None] for k in range(3))
        y0, y1, y2 = (fy[:, lo:hi, k][..., None, None] for k in range(3))
        z0, z1, z2 = (fz[:, lo:hi, k][..., None, None] for k in range(3))
        ok = ffront[:, lo:hi].all(-1) & fmask[None, lo:hi]

        def edge(ax, ay, bx, by):
            return (bx - ax) * (py - ay) - (by - ay) * (px - ax)

        e01 = edge(x0, y0, x1, y1)
        e12 = edge(x1, y1, x2, y2)
        e20 = edge(x2, y2, x0, y0)
        area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        area_safe = torch.where(torch.abs(area) < 1e-9, 1e-9, area)
        s = torch.sign(area_safe)
        inside = (e01 * s >= 0) & (e12 * s >= 0) & (e20 * s >= 0)
        inside = inside & ok[..., None, None] & (torch.abs(area) > 1e-9)
        inv_z = e12 / area_safe / z0 + e20 / area_safe / z1 + e01 / area_safe / z2
        z = torch.where(inside, 1.0 / torch.clamp(inv_z, min=1e-9), big)
        zmin, amin = torch.min(z, dim=1)
        better = zmin < zbuf
        zbuf = torch.where(better, zmin, zbuf)
        fbuf = torch.where(better, amin.to(torch.int32) + lo, fbuf)
    return _shade(mesh, world_verts, zbuf, fbuf, lights, want_normal, want_albedo)


def _face_normals(mesh: SceneMesh, world_verts: torch.Tensor) -> torch.Tensor:
    v = mesh.gather(world_verts)  # (B, F, 3, 3)
    fn = rc.cross(v[:, :, 1] - v[:, :, 0], v[:, :, 2] - v[:, :, 0])
    return fn / torch.clamp(torch.linalg.vector_norm(fn, dim=-1, keepdim=True), min=1e-9)


def _light_tensors(mesh: SceneMesh, lights, device):
    """(ambient (3,), [(direction (3,), colour (3,)), ...]) on ``device``,
    copied once per mesh and light list."""
    key = id(lights)
    cached = mesh._light_cache.get(key)
    if cached is not None and cached[0] is lights:
        return cached[1]
    ambient = np.array([0.35, 0.35, 0.35], np.float32)
    light_dirs, light_cols = [], []
    for light in lights or ():
        if light["kind"] == "ambient":
            ambient = np.asarray(light["color"], np.float32)
        elif light["kind"] == "directional":
            d = np.asarray(light["direction"], np.float32)
            light_dirs.append(-d / max(np.linalg.norm(d), 1e-9))
            light_cols.append(np.asarray(light["color"], np.float32))
    if not light_dirs:
        light_dirs = [np.array([0.4, 0.3, 0.85], np.float32)]
        light_cols = [np.array([0.7, 0.7, 0.7], np.float32)]

    def t(x):
        return torch.as_tensor(x, device=device)

    out = (t(ambient), [(t(d), t(c)) for d, c in zip(light_dirs, light_cols)])
    mesh._light_cache[key] = (lights, out)
    return out


def _face_rgb(mesh: SceneMesh, world_verts: torch.Tensor, lights) -> torch.Tensor:
    """Per-face flat two-sided lambertian colour (B, F, 3)."""
    fn = _face_normals(mesh, world_verts)
    ambient, directional = _light_tensors(mesh, lights, fn.device)
    shade = ambient.expand(fn.shape)
    for d, col in directional:
        shade = shade + torch.abs(fn @ d)[..., None] * col
    return torch.clamp(mesh.face_color[None] * shade, 0.0, 1.0)


def _shade(mesh, world_verts, zbuf, fbuf, lights, want_normal=False, want_albedo=False):
    """Shading tail of the face-chunked path: flat colour + segmentation
    (+ world-space normals and unlit albedo) gathered from the face-id
    buffer."""
    B, H, W = fbuf.shape
    background = fbuf < 0
    fidx = torch.clamp(fbuf, min=0).reshape(B, -1).long()
    attrs = [_face_rgb(mesh, world_verts, lights),
             mesh.face_seg.to(torch.float32)[None, :, None].expand(B, -1, 1)]
    if want_normal or want_albedo:
        attrs.append(_face_normals(mesh, world_verts))
        attrs.append(mesh.face_color[None].expand(B, -1, 3))
    attr = torch.cat(attrs, -1)  # (B, F, 4[+6])
    pix = torch.gather(attr, 1, fidx[..., None].expand(-1, -1, attr.shape[-1]))
    pix = pix.reshape(B, H, W, -1)
    out = dict(
        depth=torch.where(background, 0.0, zbuf),
        seg=torch.where(background, 0, pix[..., 3].to(torch.int32)),
        valid=~background,
        color=torch.where(background[..., None], 0.0, pix[..., :3]),
        dropped=torch.zeros((), dtype=torch.int32, device=zbuf.device),
    )
    if want_normal or want_albedo:
        out["normal"] = torch.where(background[..., None], 0.0, pix[..., 4:7])
        out["albedo"] = torch.where(background[..., None], 0.0, pix[..., 7:10])
    return out
