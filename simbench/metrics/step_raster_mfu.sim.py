"""The control step's share of the card's peak FP32 rate, in %, counting the
one part of a simulated step that has a work model: the rasterize stage's
coverage tests (``roofline.coverage_tests``) of the profiled steps, per
step, over the mean host-clock step time of the traced run's window times
the peak (``peaks.json``). Physics and the rest of the step count nothing,
so it bounds the whole step's share from below. It stays when a later
change takes the raster kernels off the path and their roofline falls
silent."""
from simbench import roofline


def read(rec):
    calls = rec.get("calls", {}).get("raster.rasterize_tiles")
    steps = rec.get("step_s") or []
    peak = roofline.peaks(rec.get("device_kind", ""))
    if rec.get("platform") != "gpu" or not calls or not steps or not rec.get("steps") or peak is None:
        return None
    ops = sum(roofline.coverage_tests(fx, fy, ok, h, w) * roofline.FLOP_PER_TEST
              for fx, fy, _, ok, _, _, h, w in calls) / rec["steps"]
    return 100.0 * ops / (sum(steps) / len(steps) * peak["fp32_flops"])
