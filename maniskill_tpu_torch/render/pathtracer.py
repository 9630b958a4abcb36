"""Monte-Carlo path tracer, the "rt" shader packs (counterpart of
maniskill_tpu/render/pathtracer.py).

Rays batch over (env, pixel) and intersect the same ``SceneMesh`` the
rasterizer draws, by Möller-Trumbore over chunks of ``FACE_CHUNK`` faces.
Eager torch materialises every (B, rays, faces) temporary, so the rays are
chunked too: a chunk holds as many rays as keep one (B, rays, FACE_CHUNK)
float32 temporary within ``RAY_CHUNK_BYTES``, and peak memory does not grow
with the batch. Each ray's arithmetic is the same in every chunking, so a
chunked frame is bit-equal to an unchunked one.

Packs (names from the reference):
  rt       spp=32, bounces=2 (one cosine-weighted indirect ray is traced)
  rt-med   spp=4,  bounces=1
  rt-fast  spp=2,  direct lighting only
A 3x3 box filter stands in for the hardware denoiser at spp <= 4.

The random draws (pixel jitter and bounce directions) are arguments, so a
test can hand over another package's draws; by default they come from a
counter hash of the render seed on the device (``render_draws``), with no
host sync and no host-to-device copy.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..envs.utils.randomization.batched_rng import _hash32

FACE_CHUNK = 512
RAY_CHUNK_BYTES = 256 << 20  # bytes of one (B, rays, FACE_CHUNK) float32 temporary

RT_PACKS = {
    "rt": dict(spp=32, bounces=2, denoise=False),
    "rt-med": dict(spp=4, bounces=1, denoise=True),
    "rt-fast": dict(spp=2, bounces=0, denoise=True),
}


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _norm(a):
    return torch.sqrt(_dot(a, a))


def ray_chunk_size(num_envs: int) -> int:
    """Rays per chunk: one (B, rays, FACE_CHUNK) float32 temporary fits in
    ``RAY_CHUNK_BYTES``."""
    return max(1, RAY_CHUNK_BYTES // (4 * num_envs * FACE_CHUNK))


def ray_mesh(origins, dirs, tri0, e1, e2, t_max: float = 1e9):
    """Closest hit of each ray. origins, dirs: (B, R, 3), either of them
    (B, 1, 3) or (1, 1, 3) when all rays share it (a camera's rays share
    their origin, a light's shadow rays their direction): what does not
    depend on the ray is then computed once per face, with the same
    arithmetic. tri0, e1, e2: (B, F, 3), first vertex and edges. Returns
    (t (B, R), face (B, R) int32) with t = inf and face -1 on a miss.

    Inside a face chunk the first index of the least t wins; across chunks
    only a strictly smaller t replaces the hit (the reference's tie rule).
    A near-parallel face (|a| <= 1e-8) gets inv = 0, so t = 0 and it fails
    the ``t > 1e-4`` test, as the reference's separate |a| test fails it."""
    B, F = tri0.shape[:2]
    R = max(origins.shape[1], dirs.shape[1])
    dev = tri0.device
    best_t = torch.full((B, R), math.inf, device=dev)
    best_f = torch.full((B, R), -1, dtype=torch.int32, device=dev)
    # per-ray components (B, R, 1), per-face components (B, 1, C)
    ox, oy, oz = (origins[..., i, None] for i in range(3))
    dx, dy, dz = (dirs[..., i, None] for i in range(3))
    for f0 in range(0, F, FACE_CHUNK):
        c0, c1, c2 = (x[:, None, f0:f0 + FACE_CHUNK] for x in (tri0, e1, e2))
        e1x, e1y, e1z = c1[..., 0], c1[..., 1], c1[..., 2]
        e2x, e2y, e2z = c2[..., 0], c2[..., 1], c2[..., 2]
        hx = dy * e2z - dz * e2y
        hy = dz * e2x - dx * e2z
        hz = dx * e2y - dy * e2x
        a = e1x * hx + e1y * hy + e1z * hz
        inv = torch.where(torch.abs(a) > 1e-8, 1.0 / a, 0.0)
        sx, sy, sz = ox - c0[..., 0], oy - c0[..., 1], oz - c0[..., 2]
        u = (sx * hx + sy * hy + sz * hz) * inv
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
        hit = (torch.minimum(u, v) >= 0) & (u + v <= 1) & (t > 1e-4) & (t < t_max)
        t = torch.where(hit, t, math.inf)
        ct, ci = torch.min(t, dim=-1)
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_f = torch.where(better, ci.to(torch.int32) + f0, best_f)
    return best_t, best_f


def render_seed(qpos: torch.Tensor) -> torch.Tensor:
    """The render seed of a physics state: the 32-bit wrapped sum of the bits
    of ``qpos[:, 0]`` (the bits the reference's render key folds in), as a
    0-dim int64 tensor on qpos's device."""
    return qpos[:, 0].contiguous().view(torch.int32).to(torch.int64).sum() & 0xFFFFFFFF


def _uniform(key: torch.Tensor, stream: int, shape, device) -> torch.Tensor:
    """Uniform [0, 1) float32 draws of ``shape``: 24 bits of a counter hash
    of (key, stream, element index)."""
    n = math.prod(shape)
    s = _hash32(key ^ _hash32(torch.full((), stream, dtype=torch.int64, device=device)))
    idx = _hash32(torch.arange(n, dtype=torch.int64, device=device) ^ 0x68E31DA4)
    bits = _hash32(s ^ idx)
    return ((bits >> 8).to(torch.float32) * (1.0 / (1 << 24))).reshape(shape)


def render_draws(seed: torch.Tensor, sample: int, num_envs: int, num_rays: int, bounce: bool):
    """Sample ``sample``'s draws from the render seed: the pixel jitter
    (R, 2) and, where ``bounce``, the indirect ray's (B, R, 2)."""
    key = _hash32(seed ^ 0x9E3779B9)
    dev = seed.device
    jitter = _uniform(key, 2 * sample, (num_rays, 2), dev)
    u = _uniform(key, 2 * sample + 1, (num_envs, num_rays, 2), dev) if bounce else None
    return jitter, u


def _light_tensors(lights, device):
    ambient = np.asarray([0.35, 0.35, 0.35], np.float32)
    dir_lights = []
    for l in lights or []:
        if l["kind"] == "ambient":
            ambient = np.asarray(l["color"], np.float32)
        elif l["kind"] == "directional":
            d = np.asarray(l["direction"], np.float32)
            d = d / (np.linalg.norm(d) + 1e-9)
            dir_lights.append((-d, np.asarray(l["color"], np.float32)))
    if not dir_lights:
        dir_lights = [(np.array([0.0, 0.0, 1.0], np.float32), np.array([0.6, 0.6, 0.6], np.float32))]

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return t(ambient), [(t(d), t(c)) for d, c in dir_lights]


def _constants(mesh, lights, height, width, device):
    """The lights and the pixel grid, copied to the device once per mesh."""
    cache = mesh.__dict__.setdefault("_rt_cache", {})
    key = (repr(lights), height, width, str(device))
    if key not in cache:
        ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32),
                                torch.arange(width, dtype=torch.float32), indexing="ij")
        pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(device)
        cache[key] = (*_light_tensors(lights, device), pix)
    return cache[key]


def pathtrace(
    mesh,
    world_verts: torch.Tensor,  # (B, V, 3)
    cam_pos: torch.Tensor,  # (B, 3)
    cam_rot: torch.Tensor,  # (B, 3, 3) camera -> world (GL: x right, y up, -z forward)
    fx: float, fy: float, cx: float, cy: float,
    height: int, width: int,
    spp: int = 2,
    bounces: int = 0,
    denoise: bool = True,
    lights: Optional[List[dict]] = None,
    seed: Optional[torch.Tensor] = None,
    jitter: Optional[torch.Tensor] = None,
    bounce_draws: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Render color/depth/seg/valid/normal/albedo buffers by path tracing.

    ``jitter`` (spp, R, 2) and ``bounce_draws`` (spp, B, R, 2) are the
    samples' draws (R = height x width, row-major); those not given come from
    ``render_draws`` of ``seed`` (a 0-dim int64 tensor, 0 if None). seg,
    normal and albedo are the last sample's."""
    B = world_verts.shape[0]
    dev = world_verts.device
    R = height * width
    faces = mesh._faces_t
    tri = world_verts[:, faces]  # (B, F, 3, 3)
    tri0 = tri[:, :, 0]
    e1 = tri[:, :, 1] - tri0
    e2 = tri[:, :, 2] - tri0
    fn = _cross(e1, e2)
    fn = fn / (_norm(fn)[..., None] + 1e-9)
    sky, dir_lights, pix = _constants(mesh, lights, height, width, dev)
    face_color, face_seg = mesh.face_color, mesh.face_seg
    if seed is None:
        seed = torch.zeros((), dtype=torch.int64, device=dev)
    chunk = ray_chunk_size(B)

    acc = torch.zeros(B, R, 5, device=dev)
    last_f = torch.zeros(B, R, dtype=torch.int64, device=dev)
    last_n = torch.zeros(B, R, 3, device=dev)
    for s in range(spp):
        jit = u_all = None
        if jitter is None or (bounces > 0 and bounce_draws is None):
            jit, u_all = render_draws(seed, s, B, R, bounces > 0)
        if jitter is not None:
            jit = jitter[s]
        if bounce_draws is not None:
            u_all = bounce_draws[s]
        if spp <= 1:
            jit = torch.full((R, 2), 0.5, device=dev)
        for r0 in range(0, R, chunk):
            r1 = min(R, r0 + chunk)
            px = pix[r0:r1] + jit[r0:r1]
            # GL camera ray directions
            ddx = (px[:, 0] - cx) / fx
            ddy = -(px[:, 1] - cy) / fy
            d_cam = torch.stack([ddx, ddy, -torch.ones_like(ddx)], -1)
            cosz = 1.0 / _norm(d_cam)  # z-depth = ray length x cos(angle to the view axis)
            d_world = torch.einsum("bij,rj->bri", cam_rot, d_cam)
            d_world = d_world / _norm(d_world)[..., None]
            o = cam_pos[:, None]  # (B, 1, 3): the rays share their origin

            t, f = ray_mesh(o, d_world, tri0, e1, e2)
            hit = f >= 0
            f_safe = torch.clamp(f, min=0).to(torch.int64)
            p = o + d_world * torch.where(hit, t, 0.0)[..., None]
            n = torch.gather(fn, 1, f_safe[..., None].expand(B, r1 - r0, 3))
            n = torch.where((_dot(n, d_world) > 0)[..., None], -n, n)  # toward the viewer
            alb = face_color[f_safe]

            # direct light with one shadow ray per directional light
            radiance = (sky * 0.5).expand(alb.shape)
            for ldir, lcol in dir_lights:
                cos = torch.clamp(_dot(n, ldir), min=0.0)
                ts, _ = ray_mesh(p + n * 1e-3, ldir[None, None], tri0, e1, e2)
                occluded = ts < 1e3
                radiance = radiance + lcol * (cos * (1.0 - occluded.to(torch.float32)))[..., None]
            radiance = radiance + sky

            if bounces > 0:
                # one cosine-weighted indirect ray
                u = u_all[:, r0:r1]
                low = torch.abs(n[..., 2]) < 0.9
                zero = torch.zeros_like(n[..., 0])
                axis = torch.stack([torch.where(low, 0.0, 1.0), zero, torch.where(low, 1.0, 0.0)], -1)
                tang = _cross(n, axis)
                tang = tang / (_norm(tang)[..., None] + 1e-9)
                bit = _cross(n, tang)
                phi = 2 * math.pi * u[..., 0]
                r2 = u[..., 1]
                sq = torch.sqrt(torch.clamp(1 - r2, min=0.0))
                bd = (tang * (torch.cos(phi) * sq)[..., None] + bit * (torch.sin(phi) * sq)[..., None]
                      + n * torch.sqrt(r2)[..., None])
                _, f2 = ray_mesh(p + n * 1e-3, bd, tri0, e1, e2)
                alb2 = face_color[torch.clamp(f2, min=0).to(torch.int64)]
                indirect = torch.where((f2 >= 0)[..., None], alb2 * 0.5, sky.expand(alb.shape))
                radiance = radiance + indirect * 0.5

            color = torch.where(hit[..., None], alb * radiance, 0.0)  # a miss is black
            hitf = hit.to(torch.float32)
            acc[:, r0:r1] = acc[:, r0:r1] + torch.cat(
                [color, torch.where(hit, t * cosz[None, :], 0.0)[..., None], hitf[..., None]], -1)
            if s == spp - 1:
                last_f[:, r0:r1] = f_safe
                last_n[:, r0:r1] = n

    color = acc[..., :3] / spp
    tmean = acc[..., 3] / torch.clamp(acc[..., 4], min=1.0)
    hit_frac = acc[..., 4] / spp
    valid = hit_frac > 0.5

    img = color.reshape(B, height, width, 3)
    if denoise:
        # 3x3 box filter with zero padding, the stand-in for the denoiser
        k = torch.full((1, 1, 3, 3), 1.0 / 9.0, device=dev)
        planes = img.permute(0, 3, 1, 2).reshape(B * 3, 1, height, width)
        img = torch.nn.functional.conv2d(planes, k, padding=1).reshape(B, 3, height, width).permute(0, 2, 3, 1)

    depth = (tmean * hit_frac).reshape(B, height, width)
    seg = torch.where(valid, face_seg[last_f], 0).reshape(B, height, width).to(torch.int32)
    normal = torch.where(valid[..., None], last_n, 0.0).reshape(B, height, width, 3)
    albedo = torch.where(valid[..., None], face_color[last_f], 0.0).reshape(B, height, width, 3)
    return dict(
        color=torch.clamp(img, 0.0, 1.0),
        depth=depth,
        seg=seg,
        valid=valid.reshape(B, height, width),
        normal=normal,
        albedo=albedo,
        dropped=torch.zeros((), dtype=torch.int32, device=dev),
    )
