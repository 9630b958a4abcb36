# Frozen copy of maniskill_tpu_torch/render/tiled_rasterizer.py (the plain versions) at the benchmark's first version:
# the benchmark's plain reference. It imports nothing of the program and is
# never edited to follow it.
"""Tiled rasterizer with per-band face binning and in-kernel flat shading
(counterpart of maniskill_tpu/render/pallas_rasterizer.py).

A vertex stage turns each face into a 16-float record — three sign-folded
edge planes and an affine 1/z plane, plus segmentation id and pre-shaded
colour — so the per-pixel work is 4 affine evaluations and compares, with
depth compared in 1/z space. Faces are binned into 16-row bands (a stable
compaction of the overlapping faces to the front of each band's list). A
band's list is never cut: the reference's Pallas kernel caps it at 1,024
faces (its SMEM block), and the reference never takes that path where a band
could overflow (its dense path draws every face), so the port walks every
band's whole list in one launch and drops nothing. The per-pixel loop walks
only its band's list.

``rasterize_tiles`` runs on a CUDA tensor two hand-written CUDA kernels:
``csrc/raster_setup.cu`` (the vertex stage and the binning: ``SETUP``) and
``csrc/raster_tiles.cu`` (the per-pixel loop over 16 x 32 tiles, each warp
culling its band's list to its 8 x 32 strip: ``KERNEL``). On a CPU tensor it
runs their plain torch versions ``face_records``, ``bin_faces`` and
``raster_bands_ref``, whose outputs the kernels equal bit for bit. It never falls back: on CUDA
the kernels build and launch, or the call raises. ``rasterize_tiles_ref`` is
the plain version end to end, for tests and for comparing with the kernels.
``cull_tiles_ref`` is the tile kernel's culling rule in plain torch (for
tests), and ``raster_work`` counts the tests and bytes a frame needs (for
the kernels' bounds).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

TILE_H = 16
TILE_W = 32  # columns of the CUDA kernel's tile (csrc/raster_tiles.cu)
STRIP_H = 8  # rows of a warp's strip of that tile
REC = 16
MAX_SETUP_FACES = 800_000  # raster_setup keeps 8 bytes per 32 faces in shared memory



# ---------------------------------------------------------------------------
# vertex stage and binning (plain torch on either device)
# ---------------------------------------------------------------------------
def face_records(fx, fy, inv_z, ok, face_rgb, face_seg):
    """(B, F, 3) screen x/y and 1/z per corner, (B, F) validity, (B, F, 3)
    flat colour, (F,) segmentation id -> (records (B, F, 16), valid (B, F))."""
    x0, x1, x2 = fx.unbind(-1)
    y0, y1, y2 = fy.unbind(-1)
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    degenerate = torch.abs(area) < 1e-9
    safe_area = torch.where(degenerate, 1e-9, area)
    s = torch.sign(safe_area)
    valid = (ok > 0) & ~degenerate

    def edge(xa, ya, xb, yb):
        # e(p) = (xb-xa)*(py-ya) - (yb-ya)*(px-xa), premultiplied by s;
        # invalid faces get a = b = 0, c = -1 so they never pass
        a = -s * (yb - ya)
        b = s * (xb - xa)
        c = s * ((yb - ya) * xa - (xb - xa) * ya)
        return (
            torch.where(valid, a, 0.0),
            torch.where(valid, b, 0.0),
            torch.where(valid, c, -1.0),
        )

    e01 = edge(x0, y0, x1, y1)
    e12 = edge(x1, y1, x2, y2)
    e20 = edge(x2, y2, x0, y0)
    # affine 1/z: (e12(p)*iz0 + e20(p)*iz1 + e01(p)*iz2) / area, combined
    # coefficient-wise from the raw (unsigned) edge planes
    inv_area = 1.0 / safe_area
    iz0, iz1, iz2 = inv_z.unbind(-1)

    def zc(k):
        return (e12[k] * iz0 + e20[k] * iz1 + e01[k] * iz2) * s * inv_area

    seg = face_seg.to(torch.float32)[None].expand(area.shape)
    rec = torch.stack(
        [
            e01[0], e01[1], e01[2],
            e12[0], e12[1], e12[2],
            e20[0], e20[1], e20[2],
            zc(0), zc(1), zc(2),
            seg, face_rgb[..., 0], face_rgb[..., 1], face_rgb[..., 2],
        ],
        dim=-1,
    )
    return rec.contiguous(), valid


def bin_faces(fx, fy, valid, height: int, width: int):
    """Per 16-row band, the overlapping face ids in stable list order.

    Returns (idx (B, T, F) i32: each band's whole list, then unused entries;
    counts (B, T) i32: live entries; dropped () i32: always 0, nothing is
    cut). The (B, T, F) argsort's int64 order is the largest intermediate:
    ~2 GB at B=512, T=15, F=32,000.
    """
    F = fx.shape[1]
    T = -(-height // TILE_H)
    ymin, ymax = fy.amin(-1), fy.amax(-1)
    xmin, xmax = fx.amin(-1), fx.amax(-1)
    on_screen = valid & (xmax >= 0) & (xmin < width) & (ymax >= 0) & (ymin < height)
    bands = torch.arange(T, dtype=torch.float32, device=fx.device)[None, :, None] * TILE_H
    overlap = (
        on_screen[:, None, :]
        & (ymax[:, None, :] >= bands)
        & (ymin[:, None, :] < bands + TILE_H)
    )  # (B, T, F)
    order = torch.argsort((~overlap).to(torch.uint8), dim=-1, stable=True)
    idx = order.to(torch.int32).contiguous()
    counts = overlap.sum(-1, dtype=torch.int32).contiguous()
    return idx, counts, torch.zeros((), dtype=torch.int32, device=fx.device)


# ---------------------------------------------------------------------------
# the per-pixel loop: plain torch version
# ---------------------------------------------------------------------------
_PLAIN_BUDGET = 1 << 22  # elements per (B, T, chunk, 16, W) intermediate


def raster_bands_ref(table, idx, counts, height: int, width: int):
    """Plain torch version of the kernel: same inputs, same outputs
    (iz (B,H,W) f32, seg (B,H,W) i32, rgb (B,H,W,3) f32).

    Walks each band's list in face chunks. Within a chunk the winner of a
    pixel is its largest covering 1/z, the first in list order on a tie; a
    chunk winner replaces the running best only if strictly greater — the
    same result as the kernel's face-by-face strict ``>`` from 0.
    """
    B, T, Kc = idx.shape
    dev = table.device
    rows = torch.arange(TILE_H, dtype=torch.float32, device=dev)
    row0 = torch.arange(T, dtype=torch.float32, device=dev) * TILE_H
    py = ((rows[None, :] + row0[:, None]) + 0.5)[None, :, None, :, None]  # (1,T,1,16,1)
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, None, None, None, :]

    shape = (B, T, TILE_H, width)
    iz = torch.zeros(shape, device=dev)
    seg = torch.full(shape, -1, dtype=torch.int32, device=dev)
    rgb = torch.zeros(shape + (3,), device=dev)
    n_max = int(counts.max()) if counts.numel() else 0
    chunk = max(1, _PLAIN_BUDGET // max(1, B * T * TILE_H * width))
    benv = torch.arange(B, device=dev)[:, None, None]
    for j0 in range(0, n_max, chunk):
        j1 = min(j0 + chunk, n_max)
        rec = table[benv, idx[:, :, j0:j1].long()]  # (B, T, c, 16)
        live = (torch.arange(j0, j1, device=dev)[None, None, :] < counts[..., None])
        c = [rec[..., k][..., None, None] for k in range(REC)]  # (B,T,c,1,1)
        e01 = c[0] * px + c[1] * py + c[2]
        e12 = c[3] * px + c[4] * py + c[5]
        e20 = c[6] * px + c[7] * py + c[8]
        z = c[9] * px + c[10] * py + c[11]
        # a face with 1/z <= 0 (or NaN) never beats the running best, which
        # starts at 0
        cand = (e01 >= 0) & (e12 >= 0) & (e20 >= 0) & (z > 0) & live[..., None, None]
        v = torch.where(cand, z, float("-inf"))
        vmax = v.amax(2)  # (B, T, 16, W)
        first = torch.argmax((cand & (v == vmax[:, :, None])).to(torch.int32), dim=2)
        better = vmax > iz
        win = torch.gather(rec, 2, first.reshape(B, T, -1, 1).expand(-1, -1, -1, REC))
        win = win.reshape(B, T, TILE_H, width, REC)
        iz = torch.where(better, vmax, iz)
        seg = torch.where(better, win[..., 12].to(torch.int32), seg)
        rgb = torch.where(better[..., None], win[..., 13:16], rgb)
    H = height
    return (
        iz.reshape(B, -1, width)[:, :H],
        seg.reshape(B, -1, width)[:, :H],
        rgb.reshape(B, -1, width, 3)[:, :H],
    )


# ---------------------------------------------------------------------------
# the tile kernel's culling rule and the work a frame needs (plain torch)
# ---------------------------------------------------------------------------
def _plane_max(a, b, c, px_lo, px_hi, py_lo, py_hi):
    """The largest rounded ``(a*px + b*py) + c`` over a rectangle of pixel
    centres: rounding is monotone, so it lies at the corner that the signs
    of a and b pick."""
    px = torch.where(a > 0, px_hi, px_lo)
    py = torch.where(b > 0, py_hi, py_lo)
    return a * px + b * py + c


def cull_tiles_ref(table, idx, counts, height: int, width: int):
    """The culling of ``csrc/raster_tiles.cu`` in plain torch (the tests use
    it; the main path does not). For each band, each TILE_W-column tile and
    each STRIP_H-row strip of it (one warp's pixels), the band's live entries
    whose record may cover a pixel centre of the strip with 1/z > 0, in list
    order: no edge plane < 0 and a 1/z plane > 0 at the plane's largest
    corner of the strip's pixel centres.

    Returns (idx (B, T, S, NT, K) i32: each strip's kept entries first, in
    list order; counts (B, T, S, NT) i32), S = TILE_H // STRIP_H strips and
    NT = ceil(width / TILE_W) tiles."""
    B, T, K = idx.shape
    S, NT = TILE_H // STRIP_H, -(-width // TILE_W)
    dev = table.device
    f32 = dict(dtype=torch.float32, device=dev)
    rec = table[torch.arange(B, device=dev)[:, None, None], idx.long()]  # (B, T, K, 16)
    rec = rec[:, :, None, None]  # (B, T, 1, 1, K, 16)
    c0 = torch.arange(NT, **f32) * TILE_W
    px_lo = (c0 + 0.5)[:, None]  # (NT, 1)
    px_hi = (c0 + (TILE_W - 1) + 0.5)[:, None]
    r0 = torch.arange(T, **f32)[:, None] * TILE_H + torch.arange(S, **f32) * STRIP_H  # (T, S)
    py_lo = (r0 + 0.5)[:, :, None, None]  # (T, S, 1, 1)
    py_hi = (r0 + (STRIP_H - 1) + 0.5)[:, :, None, None]
    m = [_plane_max(rec[..., 3 * k], rec[..., 3 * k + 1], rec[..., 3 * k + 2], px_lo, px_hi, py_lo, py_hi)
         for k in range(4)]  # (B, T, S, NT, K) each
    keep = ~(m[0] < 0) & ~(m[1] < 0) & ~(m[2] < 0) & ~(m[3] <= 0)
    keep &= (torch.arange(K, device=dev) < counts[..., None])[:, :, None, None, :]
    order = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)
    kept_idx = torch.gather(idx[:, :, None, None, :].expand(-1, -1, S, NT, -1), 4, order)
    return kept_idx.to(torch.int32).contiguous(), keep.sum(-1, dtype=torch.int32)


def _finish(iz, seg, rgb, dropped):
    zbuf = torch.where(seg >= 0, 1.0 / torch.clamp(iz, min=1e-9), 1e9)
    return zbuf, seg, rgb, dropped


def rasterize_tiles_ref(fx, fy, inv_z, ok, face_rgb, face_seg, height: int, width: int):
    """``rasterize_tiles`` with the plain versions on any device."""
    table, valid = face_records(fx, fy, inv_z, ok, face_rgb, face_seg)
    idx, counts, dropped = bin_faces(fx, fy, valid, height, width)
    return _finish(*raster_bands_ref(table, idx, counts, height, width), dropped)
