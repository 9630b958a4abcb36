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

``rasterize_tiles`` runs that loop as the hand-written CUDA kernel in
``csrc/raster_tiles.cu`` on a CUDA tensor, and as the plain torch version
``raster_bands_ref`` on a CPU tensor. It never falls back: on CUDA the kernel
builds and launches, or the call raises. ``rasterize_tiles_ref`` is the
plain version end to end, for tests and for comparing with the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

TILE_H = 16
REC = 16

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "raster_tiles.cu"
_BUILD_DIR = _PKG / "_build"


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
# the per-pixel loop: CUDA kernel
# ---------------------------------------------------------------------------
class RasterTilesKernel:
    """The CUDA kernel of ``csrc/raster_tiles.cu``, which replaces the Pallas
    kernel ``_raster_kernel`` (maniskill_tpu/render/pallas_rasterizer.py).

    It is bound by the coverage tests (B*H*W*faces-per-band, ~20 FP32 ops
    each), not by bytes: each block reads its band's records once and streams
    them through shared memory in 256-face chunks, and each thread keeps 8
    pixels' state in registers. Built with nvcc at first use into ``_build/``
    (keyed by the source's hash), loaded with ctypes, launched on torch's
    current stream. ``launches`` counts launches."""

    def __init__(self):
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._lib = None

    def build(self):
        """Compile (if needed) and load the shared library."""
        if self._lib is not None:
            return self._lib
        src = _SRC.read_bytes()
        so = _BUILD_DIR / f"libraster_tiles_{hashlib.sha256(src).hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        if not so.exists():
            nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
            if not os.path.exists(nvcc):
                nvcc = shutil.which("nvcc")
            if nvcc is None:
                raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
            _BUILD_DIR.mkdir(exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [
                nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                "-o", str(tmp), str(_SRC),
            ]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
            self.build_log = res.stderr
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.raster_tiles_launch.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        lib.raster_tiles_launch.restype = i32
        lib.raster_tiles_error_string.argtypes = [i32]
        lib.raster_tiles_error_string.restype = ctypes.c_char_p
        self.build_seconds = time.perf_counter() - t0
        self._lib = lib
        return lib

    def __call__(self, table, idx, counts, height: int, width: int):
        B, F, rec = table.shape
        _, T, K = idx.shape
        dev = table.device
        if dev.type != "cuda":
            raise ValueError(f"raster_tiles kernel needs CUDA tensors, got {dev}")
        if torch.cuda.get_device_capability(dev) != (9, 0):
            raise RuntimeError(
                f"raster_tiles is built for sm_90a; {torch.cuda.get_device_name(dev)} "
                f"is sm_{''.join(map(str, torch.cuda.get_device_capability(dev)))}"
            )
        if rec != REC or table.dtype != torch.float32 or not table.is_contiguous():
            raise ValueError("table must be a contiguous (B, F, 16) float32 tensor")
        if table.data_ptr() % 16:
            raise ValueError("table must be 16-byte aligned")
        if idx.dtype != torch.int32 or not idx.is_contiguous() or idx.shape[0] != B:
            raise ValueError("idx must be a contiguous (B, T, K) int32 tensor")
        if counts.dtype != torch.int32 or not counts.is_contiguous() or tuple(counts.shape) != (B, T):
            raise ValueError("counts must be a contiguous (B, T) int32 tensor")
        if T != -(-height // TILE_H) or idx.device != dev or counts.device != dev:
            raise ValueError("idx/counts do not match the image height or device")
        lib = self.build()
        iz = torch.empty(B, height, width, device=dev)
        seg = torch.empty(B, height, width, dtype=torch.int32, device=dev)
        rgb = torch.empty(B, height, width, 3, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.raster_tiles_launch(
                table.data_ptr(), idx.data_ptr(), counts.data_ptr(),
                iz.data_ptr(), seg.data_ptr(), rgb.data_ptr(),
                B, F, T, K, height, width, stream,
            )
        if err != 0:
            raise RuntimeError(
                f"raster_tiles launch failed: {lib.raster_tiles_error_string(err).decode()}"
            )
        self.launches += 1
        return iz, seg, rgb


KERNEL = RasterTilesKernel()


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def _finish(iz, seg, rgb, dropped):
    zbuf = torch.where(seg >= 0, 1.0 / torch.clamp(iz, min=1e-9), 1e9)
    return zbuf, seg, rgb, dropped


def rasterize_tiles(
    fx: torch.Tensor,  # (B, F, 3) screen x per corner
    fy: torch.Tensor,  # (B, F, 3)
    inv_z: torch.Tensor,  # (B, F, 3) 1/z per corner
    ok: torch.Tensor,  # (B, F) validity
    face_rgb: torch.Tensor,  # (B, F, 3) pre-shaded flat colour
    face_seg: torch.Tensor,  # (F,) int32 segmentation ids
    height: int,
    width: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (zbuf (B,H,W) f32 metres [1e9 = background], seg (B,H,W) i32
    [-1 = background], rgb (B,H,W,3) f32, dropped () i32 overflowed faces).

    CUDA tensors go through the CUDA kernel, CPU tensors through the plain
    version."""
    table, valid = face_records(fx, fy, inv_z, ok, face_rgb, face_seg)
    idx, counts, dropped = bin_faces(fx, fy, valid, height, width)
    if fx.device.type == "cuda":
        iz, seg, rgb = KERNEL(table, idx, counts, height, width)
    elif fx.device.type == "cpu":
        iz, seg, rgb = raster_bands_ref(table, idx, counts, height, width)
    else:
        raise ValueError(f"no rasterizer for device {fx.device}")
    return _finish(iz, seg, rgb, dropped)


def rasterize_tiles_ref(fx, fy, inv_z, ok, face_rgb, face_seg, height: int, width: int):
    """``rasterize_tiles`` with the plain per-pixel loop on any device."""
    table, valid = face_records(fx, fy, inv_z, ok, face_rgb, face_seg)
    idx, counts, dropped = bin_faces(fx, fy, valid, height, width)
    return _finish(*raster_bands_ref(table, idx, counts, height, width), dropped)
