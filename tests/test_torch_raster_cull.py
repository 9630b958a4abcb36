"""The CUDA tile kernel's culling rule and the rasterizer's work count, on
the CPU (maniskill_tpu_torch/render/tiled_rasterizer.py).

- ``cull_tiles_ref`` (the rule of ``csrc/raster_tiles.cu`` in plain torch):
  each 8-row strip of a 32-column tile walks only the entries of its band's
  list whose record may cover a pixel centre of the strip with 1/z > 0.
  Rendered strip by strip through ``raster_bands_ref`` over the culled
  lists, every frame is
  bit-equal to ``raster_bands_ref`` over the uncut lists: on PickCube-v1,
  RotateValveLevel2-v1 and DrawTriangle-v1 camera frames at 2 envs, and on
  hypothesis-drawn adversarial faces (corners on pixel centres and tile
  edges, slivers, faces larger than the frame, corners off screen).
- A rule that keeps a face where its x-range [min x, max x] reaches within
  one pixel of the tile is not exact: a needle whose tip half-angle is a
  few micro-radians is drawn ten pixels past its x-range, into the next
  tile, by the plain version, because both long edge planes round to >= 0
  beyond the tip. The corner rule keeps it there.
- ``raster_work`` against a brute-force count of the pixel-face tests and
  of the bytes.
"""
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make
from maniskill_tpu_torch.physics.kinematics import geom_poses
from maniskill_tpu_torch.render import tiled_rasterizer as tr
from maniskill_tpu_torch.render.rasterizer import tiled_inputs

from test_torch_common import one_torch_thread  # noqa: F401


def _bits(x):
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def assert_culled_equals_uncut(table, idx, counts, H, W):
    """Strip by strip, ``raster_bands_ref`` over the culled lists equals it
    over the uncut lists on the strip's pixels (a frame cut at the tile's
    right edge computes those columns with the same pixel centres)."""
    ref = tr.raster_bands_ref(table, idx, counts, H, W)
    kept_idx, kept = tr.cull_tiles_ref(table, idx, counts, H, W)
    assert bool((kept <= counts[..., None, None]).all())
    strip_of_row = (torch.arange(H) % tr.TILE_H) // tr.STRIP_H
    for r in range(kept_idx.shape[2]):
        rows = strip_of_row == r
        for j in range(kept_idx.shape[3]):
            c0, c1 = tr.TILE_W * j, min(W, tr.TILE_W * (j + 1))
            out = tr.raster_bands_ref(table, kept_idx[:, :, r, j], kept[:, :, r, j], H, c1)
            for a, b in zip(ref, out):
                assert torch.equal(_bits(a[:, rows, c0:c1]), _bits(b[:, rows, c0:c1])), f"strip {r} of tile {j}"
    return ref, kept


@pytest.mark.parametrize("uid,kwargs", [
    ("PickCube-v1", {}),
    ("RotateValveLevel2-v1", {}),
    ("DrawTriangle-v1", dict(max_dots=10)),
])
def test_culled_tiles_equal_uncut_on_env_frames(uid, kwargs):
    env = make(uid, num_envs=2, obs_mode="state", device="cpu", **kwargs)
    base = env.unwrapped
    env.reset(seed=0)
    cam = base._sensors["base_camera"]
    H, W = cam.config.height, cam.config.width
    mesh = cam._get_mesh(tuple(base._hidden_objects))
    gpos, gquat = geom_poses(base.scene.model, base.scene.data)
    inputs = tiled_inputs(mesh, mesh.world_vertices(gpos, gquat), cam._view_matrix(), cam.proj, H, W,
                          lights=base.scene.lights)
    table, valid = tr.face_records(*inputs)
    idx, counts, _ = tr.bin_faces(inputs[0], inputs[1], valid, H, W)
    ref, kept = assert_culled_equals_uncut(table, idx, counts, H, W)
    assert (ref[1] >= 0).any()
    n_strips = kept.shape[2] * kept.shape[3]
    assert 0 < int(kept.sum()) < int(counts.sum()) * n_strips  # the rule drops entries, and keeps some


def random_faces(rng, B, F, H, W):
    """Well-shaped random triangles (rotated, jittered equilateral) in
    screen space, as tests/test_torch_render.py draws them."""
    cx = rng.uniform(-5, W + 5, (B, F, 1))
    cy = rng.uniform(0, H, (B, F, 1))
    r = rng.uniform(2.0, 30.0, (B, F, 1))
    ang = rng.uniform(0, 2 * np.pi, (B, F, 1)) + np.array([0, 2.1, 4.2]) + rng.uniform(-0.3, 0.3, (B, F, 3))
    return [torch.as_tensor(a) for a in (
        (cx + r * np.cos(ang)).astype(np.float32),
        (cy + r * np.sin(ang)).astype(np.float32),
        rng.uniform(0.2, 2.0, (B, F, 3)).astype(np.float32),
        (rng.uniform(size=(B, F)) < 0.9).astype(np.int32),
        rng.uniform(size=(B, F, 3)).astype(np.float32),
        rng.integers(0, 50, F).astype(np.int32),
    )]


def _face_arrays(faces, H, W, rng):
    F = len(faces)
    fx = np.array([[[p[0] for p in f] for f in faces]], np.float32)
    fy = np.array([[[p[1] for p in f] for f in faces]], np.float32)
    inv_z = rng.uniform(0.2, 2.0, (1, F, 3)).astype(np.float32)
    ok = np.ones((1, F), np.int32)
    rgb = rng.uniform(size=(1, F, 3)).astype(np.float32)
    seg = np.arange(F, dtype=np.int32)
    return [torch.as_tensor(a) for a in (fx, fy, inv_z, ok, rgb, seg)]


H_ADV, W_ADV = 40, 96
_centre = st.integers(-2, W_ADV + 2).map(lambda c: c + 0.5)
_tile_edge = st.sampled_from([0.0, 32.0, 64.0, 96.0]).flatmap(
    lambda e: st.sampled_from([e, float(np.nextafter(np.float32(e), np.float32(-1e9))),
                               float(np.nextafter(np.float32(e), np.float32(1e9)))]))
_coord = st.one_of(_centre, _tile_edge, st.floats(-5, W_ADV + 5, width=32),
                   st.floats(-1e4, 1e4, width=32))
_row = st.one_of(st.integers(-2, H_ADV + 2).map(lambda r: r + 0.5), st.sampled_from([0.0, 16.0, 32.0]),
                 st.floats(-5, H_ADV + 5, width=32), st.floats(-1e4, 1e4, width=32))
_point = st.tuples(_coord, _row)


@st.composite
def _sliver(draw):
    """Three nearly collinear corners: a thin face whose edge planes are
    small against their rounding."""
    (x0, y0), (x1, y1) = draw(_point), draw(_point)
    t = draw(st.floats(0.0, 1.0))
    off = draw(st.sampled_from([1e-6, -1e-6, 1e-4, -1e-4, 1e-2]))
    return ((x0, y0), (x1, y1), (x0 + t * (x1 - x0) + off, y0 + t * (y1 - y0) - off))


_face = st.one_of(st.tuples(_point, _point, _point), _sliver())


@settings(max_examples=40, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
@given(st.lists(_face, min_size=1, max_size=24))
def test_culled_tiles_equal_uncut_on_adversarial_faces(faces):
    rng = np.random.default_rng(len(faces))
    args = _face_arrays(faces, H_ADV, W_ADV, rng)
    # both windings: one of the two draws every face
    for flip in (False, True):
        a = [x.flip(-1) if flip and k < 3 else x for k, x in enumerate(args)]
        table, valid = tr.face_records(*a)
        idx, counts, _ = tr.bin_faces(a[0], a[1], valid, H_ADV, W_ADV)
        assert_culled_equals_uncut(table, idx, counts, H_ADV, W_ADV)


# a needle along +x with its tip on the pixel row y = 8.5, 3.3 px left of a
# tile edge: half-width 1e-6 at the base, 19.8 px long (found by a search
# over such needles)
NEEDLE = ([40.875244140625, 60.71351623535156, 40.875244140625],
          [8.500000953674316, 8.5, 8.499999046325684])


def test_x_range_margin_is_not_exact_and_the_corner_rule_is():
    H, W = 16, 96
    args = _face_arrays([tuple(zip(*NEEDLE))], H, W, np.random.default_rng(0))
    table, valid = tr.face_records(*args)
    idx, counts, _ = tr.bin_faces(args[0], args[1], valid, H, W)
    ref, kept = assert_culled_equals_uncut(table, idx, counts, H, W)
    drawn = torch.nonzero((ref[1][0] >= 0).any(0)).flatten()
    x_max = max(NEEDLE[0])
    assert float(drawn.max()) + 0.5 > x_max + 1.0, "the needle is drawn past its x-range"
    # the pixel centres of the tile right of the tip's lie more than a pixel
    # past the x-range, and the plain version draws in it: a margin rule
    # drops the needle there, the corner rule keeps it
    tip_tile = int(x_max // tr.TILE_W)
    assert (tip_tile + 1) * tr.TILE_W + 0.5 > x_max + 1.0 and int(drawn.max()) >= (tip_tile + 1) * tr.TILE_W
    assert int(kept[0, 0, 1, tip_tile + 1]) == 1  # the tip's row, 8.5, is in the band's second strip


def _brute_work(fx, idx, counts, H, W):
    fx, idx, counts = fx.numpy().astype(np.float64), idx.numpy(), counts.numpy()
    B, F, _ = fx.shape
    T = idx.shape[1]
    tests, listed = 0, set()
    centres = np.arange(W) + 0.5
    for b in range(B):
        for t in range(T):
            rows = len(range(t * 16, min(t * 16 + 16, H)))
            for j in range(counts[b, t]):
                f = idx[b, t, j]
                listed.add((b, f))
                lo, hi = fx[b, f].min(), fx[b, f].max()
                tests += rows * int(((centres >= lo) & (centres <= hi)).sum())
    live = int(counts.sum())
    setup = (3 * B * F * 3 * 4 + B * F * 4 + B * F * 3 * 4 + F * 4  # fx, fy, inv_z, ok, face_rgb, face_seg
             + B * F * 16 * 4 + B * F + B * T * F * 4 + B * T * 4)  # table, valid, idx, counts
    tiles = len(listed) * 64 + live * 4 + B * T * 4 + B * H * W * (4 + 4 + 12)
    return dict(tests=tests, full_width_tests=live * 16 * W, setup_bytes=setup, tiles_bytes=tiles, live=live)


@pytest.mark.parametrize("B,F,H,W", [(2, 120, 32, 128), (3, 90, 40, 100)], ids=["aligned", "ragged"])
def test_raster_work_counts_what_the_frame_needs(B, F, H, W):
    args = random_faces(np.random.default_rng(F), B, F, H, W)
    args[0][0, :4] *= 60.0  # faces wider than the frame, clipped to [0, W)
    table, valid = tr.face_records(*args)
    idx, counts, _ = tr.bin_faces(args[0], args[1], valid, H, W)
    work = tr.raster_work(args[0], idx, counts, H, W)
    assert work == _brute_work(args[0], idx, counts, H, W)
    assert 0 < work["tests"] < work["full_width_tests"]


def test_setup_kernel_refuses_cpu_tensors():
    """Neither kernel runs a plain path in its place: CPU tensors raise (the
    tile kernel's refusal: tests/test_torch_render.py)."""
    args = random_faces(np.random.default_rng(1), 1, 10, 16, 64)
    launches = tr.SETUP.launches
    with pytest.raises(ValueError, match="CUDA"):
        tr.SETUP(*args, 16, 64)
    assert tr.SETUP.launches == launches
