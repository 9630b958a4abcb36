"""The yardstick's arithmetic against brute force: the rasterize stage's
coverage tests and the union of device intervals behind the idle share."""
import random

import pytest
import torch

from simbench import roofline, trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coverage_tests_match_a_brute_force_count(seed):
    g = torch.Generator().manual_seed(seed)
    B, F, H, W = 2, 40, 13, 17
    fx = torch.rand(B, F, 3, generator=g) * (W + 10) - 5
    fy = torch.rand(B, F, 3, generator=g) * (H + 10) - 5
    # faces on pixel centres, degenerate ones, and some off the image
    fx[0, :5] = torch.tensor([0.5, 3.5, 3.5])
    fy[0, :5] = torch.tensor([0.5, 0.5, 2.5])
    fx[1, :3] = 1e6
    ok = (torch.rand(B, F, generator=g) > 0.2).to(torch.int32)
    assert roofline.coverage_tests(fx, fy, ok, H, W) == roofline.brute_force_tests(fx, fy, ok, H, W)


def test_least_time_names_its_bound():
    peak = {"fp32_flops": 1e12, "hbm_bytes_per_s": 1e9}
    assert roofline.least_seconds(10, 10**9, peak) == (1.0, "memory")
    t, bound = roofline.least_seconds(10**12, 1, peak)
    assert bound == "compute" and t == pytest.approx(roofline.FLOP_PER_TEST)


def test_stage_bytes_count_inputs_once_and_frames_once():
    fx = torch.zeros(3, 5, 3)
    seg = torch.zeros(5, dtype=torch.int32)
    assert roofline.stage_bytes(fx, seg, 4, 6, 3) == 3 * 5 * 52 + 5 * 4 + 3 * 4 * 6 * 3


@pytest.mark.parametrize("mode,nbytes", [("rgb", 3), ("rgbd", 5), ("rgb+depth+segmentation", 7)])
def test_a_pixel_counts_the_textures_the_obs_keeps(mode, nbytes):
    assert roofline.obs_bytes_per_pixel(mode) == nbytes


@pytest.mark.parametrize("seed", range(4))
def test_union_of_intervals_counts_overlaps_once(seed):
    rng = random.Random(seed)
    iv = [(s, s + rng.randint(1, 30)) for s in (rng.randint(0, 200) for _ in range(40))]
    covered = set()
    for s, e in iv:
        covered.update(range(s, e))
    assert sum(e - s for s, e in trace.merged(iv)) == len(covered)


def test_reduce_trace_attributes_kernels_to_spans():
    ev = lambda cat, name, ts, dur, **kw: dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=1, args=kw)  # noqa: E731
    events = [
        ev("user_annotation", "simbench.window", 0, 100),
        ev("user_annotation", "simbench.step", 0, 90),
        ev("user_annotation", "physics.step", 10, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 40, 1, correlation=2),
        ev("kernel", "k1", 20, 10, correlation=1),
        ev("kernel", "k2", 25, 10, correlation=2),
        ev("gpu_memcpy", "Memcpy", 50, 5, correlation=3),
    ]
    rec = trace.reduce_trace({"traceEvents": events}, 1, {})
    assert rec["busy_s"] == pytest.approx(20e-6)  # [20, 35] and [50, 55]
    assert rec["window_s"] == pytest.approx(100e-6)
    assert rec["span_device_s"]["physics.step"] == pytest.approx(10e-6)
    assert rec["span_launches"] == {"simbench.window": 2, "simbench.step": 2, "physics.step": 1}
    assert sum(rec["idle_by_span"].values()) == pytest.approx(80e-6)
