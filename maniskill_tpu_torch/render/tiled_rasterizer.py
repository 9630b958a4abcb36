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
TILE_W = 32  # columns of the CUDA kernel's tile (csrc/raster_tiles.cu)
STRIP_H = 8  # rows of a warp's strip of that tile
REC = 16
MAX_SETUP_FACES = 800_000  # raster_setup keeps 8 bytes per 32 faces in shared memory

_PKG = Path(__file__).resolve().parents[1]
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


def raster_work(fx, idx, counts, height: int, width: int):
    """What a frame needs of the two kernels, from these inputs:

    - ``tests``: the pixel-face coverage tests: for each live band entry,
      the band's rows inside ``height`` times the pixel columns whose centre
      lies in the face's x-range [min fx, max fx], clipped to [0, width);
    - ``full_width_tests``: live entries x 16 rows x ``width``, every entry
      against every column of its band, as the TPU kernel's layout tests;
    - ``setup_bytes``: raster_setup's inputs read once (fx, fy, inv_z, ok,
      face_rgb, face_seg) and its outputs written once (table, valid, idx,
      counts);
    - ``tiles_bytes``: raster_tiles' inputs read once (the records of the
      faces some live entry names, the live entries, counts) and its outputs
      written once (iz, seg, rgb);
    - ``live``: live band entries.
    Python ints."""
    B, F, _ = fx.shape
    T = idx.shape[1]
    rows = torch.clamp(height - torch.arange(T, device=fx.device) * TILE_H, max=TILE_H).to(torch.int64)
    x = fx.double()
    lo = torch.clamp(torch.ceil(x.amin(-1) - 0.5), min=0)
    hi = torch.clamp(torch.floor(x.amax(-1) - 0.5), max=width - 1)
    cols = torch.nan_to_num(torch.clamp(hi - lo + 1, min=0), nan=0.0).to(torch.int64)  # (B, F)
    n_max = int(counts.max()) if counts.numel() else 0
    tests, listed = 0, 0
    step = max(1, (1 << 24) // max(1, T * n_max))
    for b0 in range(0, B, step):
        ids = idx[b0:b0 + step, :, :n_max].long()
        live = torch.arange(n_max, device=fx.device) < counts[b0:b0 + step, :, None]
        per_face = torch.gather(cols[b0:b0 + step, None, :].expand(-1, T, -1), 2, ids)
        tests += int((torch.where(live, per_face, 0).sum(-1) * rows).sum())
        hits = torch.zeros(ids.shape[0], F + 1, dtype=torch.int32, device=fx.device)
        hits.scatter_add_(1, torch.where(live, ids, F).flatten(1), torch.ones_like(ids, dtype=torch.int32).flatten(1))
        listed += int((hits[:, :F] > 0).sum())
    live = int(counts.sum())
    pixels = B * height * width
    return dict(
        tests=tests,
        full_width_tests=live * TILE_H * width,
        setup_bytes=B * F * (3 * 12 + 4 + 12) + F * 4 + B * F * (REC * 4 + 1) + B * T * (F + 1) * 4,
        tiles_bytes=listed * REC * 4 + live * 4 + B * T * 4 + pixels * (4 + 4 + 12),
        live=live,
    )


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------
class _CudaSource:
    """A CUDA source of ``csrc/`` with a plain C interface, built with nvcc
    at first use into ``_build/`` (keyed by the source's hash), loaded with
    ctypes and launched on torch's current stream. ``launches`` counts
    launches."""

    name = ""  # csrc/<name>.cu, C symbols <name>_launch and <name>_error_string
    argtypes: list = []

    def __init__(self):
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._lib = None
        self._job = None

    def _so(self) -> Path:
        src = (_PKG / "csrc" / f"{self.name}.cu").read_bytes()
        return _BUILD_DIR / f"lib{self.name}_{hashlib.sha256(src).hexdigest()[:16]}.so"

    def start_build(self):
        """Start nvcc in the background unless the library is built."""
        if self._lib is not None or self._job is not None:
            return
        so = self._so()
        t0 = time.perf_counter()
        if so.exists():
            self._job = (None, so, None, t0)
            return
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        if not os.path.exists(nvcc):
            nvcc = shutil.which("nvcc")
        if nvcc is None:
            raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
        _BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(tmp), str(_PKG / "csrc" / f"{self.name}.cu"),
        ]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._job = (proc, so, tmp, t0)

    def build(self):
        """Compile (if needed) and load the shared library."""
        if self._lib is not None:
            return self._lib
        self.start_build()
        proc, so, tmp, t0 = self._job
        self._job = None
        if proc is not None:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.name}.cu ({proc.returncode}):\n{err}")
            self.build_log = err
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        launch = getattr(lib, f"{self.name}_launch")
        launch.argtypes = self.argtypes
        launch.restype = ctypes.c_int
        error_string = getattr(lib, f"{self.name}_error_string")
        error_string.argtypes = [ctypes.c_int]
        error_string.restype = ctypes.c_char_p
        self.build_seconds = time.perf_counter() - t0
        self._lib = lib
        return lib

    def _check_device(self, dev):
        if dev.type != "cuda":
            raise ValueError(f"{self.name} kernel needs CUDA tensors, got {dev}")
        if torch.cuda.get_device_capability(dev) != (9, 0):
            raise RuntimeError(
                f"{self.name} is built for sm_90a; {torch.cuda.get_device_name(dev)} "
                f"is sm_{''.join(map(str, torch.cuda.get_device_capability(dev)))}"
            )

    def _launch(self, dev, *args):
        lib = self.build()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, f"{self.name}_launch")(*args, stream)
        if err != 0:
            msg = getattr(lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{self.name} launch failed: {msg}")
        self.launches += 1


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int


class RasterSetupKernel(_CudaSource):
    """The CUDA kernel of ``csrc/raster_setup.cu``: ``face_records`` and
    ``bin_faces`` in one launch, bit-equal to them. It replaces the vertex
    stage and the binning of the TPU kernel's function
    ``pallas_rasterize_tiles`` (maniskill_tpu/render/pallas_rasterizer.py).

    Bound by bytes (the records and the (B, T, F) lists): one block per
    (env, band) packs the band's overlap bits with warp ballots, takes a
    block prefix sum of their popcounts and writes the stable partition,
    with no sort."""

    name = "raster_setup"
    argtypes = [_PTR] * 10 + [_I32] * 5 + [_PTR]

    def __call__(self, fx, fy, inv_z, ok, face_rgb, face_seg, height: int, width: int):
        """-> (table (B, F, 16) f32, valid (B, F) bool, idx (B, T, F) i32,
        counts (B, T) i32), as ``face_records`` and ``bin_faces`` give them."""
        dev = fx.device
        self._check_device(dev)
        B, F, _ = fx.shape
        T = -(-height // TILE_H)
        for name, x, shape in (("fx", fx, (B, F, 3)), ("fy", fy, (B, F, 3)), ("inv_z", inv_z, (B, F, 3)),
                               ("face_rgb", face_rgb, (B, F, 3))):
            if tuple(x.shape) != shape or x.dtype != torch.float32 or x.device != dev:
                raise ValueError(f"{name} must be a {shape} float32 tensor on {dev}")
        for name, x, shape in (("ok", ok, (B, F)), ("face_seg", face_seg, (F,))):
            if tuple(x.shape) != shape or x.dtype != torch.int32 or x.device != dev:
                raise ValueError(f"{name} must be a {shape} int32 tensor on {dev}")
        if not 0 < F <= MAX_SETUP_FACES:
            raise ValueError(f"raster_setup takes 1-{MAX_SETUP_FACES} faces, got {F}")
        fx, fy, inv_z, ok, face_rgb, face_seg = (x.contiguous() for x in (fx, fy, inv_z, ok, face_rgb, face_seg))
        table = torch.empty(B, F, REC, device=dev)
        valid = torch.empty(B, F, dtype=torch.bool, device=dev)
        idx = torch.empty(B, T, F, dtype=torch.int32, device=dev)
        counts = torch.empty(B, T, dtype=torch.int32, device=dev)
        self._launch(
            dev, fx.data_ptr(), fy.data_ptr(), inv_z.data_ptr(), ok.data_ptr(), face_rgb.data_ptr(),
            face_seg.data_ptr(), table.data_ptr(), valid.data_ptr(), idx.data_ptr(), counts.data_ptr(),
            B, F, T, height, width,
        )
        return table, valid, idx, counts


class RasterTilesKernel(_CudaSource):
    """The CUDA kernel of ``csrc/raster_tiles.cu``, which replaces the Pallas
    kernel ``_raster_kernel`` (maniskill_tpu/render/pallas_rasterizer.py).

    Bound by the coverage tests (~21 FP32 instructions each) of the faces
    that reach each warp's 8 x 32 strip of a 16 x 32 tile: a block culls its
    band's list against both strips (exactly: ``cull_tiles_ref``), staging
    the records through a two-slot shared-memory ring with ``cp.async``, and
    each thread keeps 8 pixels' state in registers."""

    name = "raster_tiles"
    argtypes = [_PTR] * 6 + [_I32] * 6 + [_PTR]

    def __call__(self, table, idx, counts, height: int, width: int):
        B, F, rec = table.shape
        _, T, K = idx.shape
        dev = table.device
        self._check_device(dev)
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
        iz = torch.empty(B, height, width, device=dev)
        seg = torch.empty(B, height, width, dtype=torch.int32, device=dev)
        rgb = torch.empty(B, height, width, 3, device=dev)
        self._launch(
            dev, table.data_ptr(), idx.data_ptr(), counts.data_ptr(),
            iz.data_ptr(), seg.data_ptr(), rgb.data_ptr(), B, F, T, K, height, width,
        )
        return iz, seg, rgb


SETUP = RasterSetupKernel()
KERNEL = RasterTilesKernel()


def build_kernels():
    """Build both kernels, their nvcc runs side by side."""
    for k in (SETUP, KERNEL):
        k.start_build()
    for k in (SETUP, KERNEL):
        k.build()


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

    CUDA tensors go through the two CUDA kernels, CPU tensors through their
    plain versions."""
    if fx.device.type == "cuda":
        table, _, idx, counts = SETUP(fx, fy, inv_z, ok, face_rgb, face_seg, height, width)
        iz, seg, rgb = KERNEL(table, idx, counts, height, width)
        dropped = torch.zeros((), dtype=torch.int32, device=fx.device)
    elif fx.device.type == "cpu":
        table, valid = face_records(fx, fy, inv_z, ok, face_rgb, face_seg)
        idx, counts, dropped = bin_faces(fx, fy, valid, height, width)
        iz, seg, rgb = raster_bands_ref(table, idx, counts, height, width)
    else:
        raise ValueError(f"no rasterizer for device {fx.device}")
    return _finish(iz, seg, rgb, dropped)


def rasterize_tiles_ref(fx, fy, inv_z, ok, face_rgb, face_seg, height: int, width: int):
    """``rasterize_tiles`` with the plain versions on any device."""
    table, valid = face_records(fx, fy, inv_z, ok, face_rgb, face_seg)
    idx, counts, dropped = bin_faces(fx, fy, valid, height, width)
    return _finish(*raster_bands_ref(table, idx, counts, height, width), dropped)
