"""The rasterize stage's share of its roofline, in %: the least time its
inputs need (``simbench/roofline.py``: coverage tests over the peak FP32
rate, or the inputs and the obs's bytes over the peak bandwidth, whichever
is longer) over the device time of the kernels launched inside its spans,
summed over the profiled calls."""
from simbench import roofline


def read(rec):
    calls = rec.get("calls", {}).get("raster.rasterize_tiles")
    device_s = rec.get("span_device_s", {}).get("raster.rasterize_tiles")
    peak = roofline.peaks(rec.get("device_kind", ""))
    if rec.get("platform") != "gpu" or not calls or not device_s or peak is None:
        return None
    return 100.0 * roofline.stage_least(calls, peak, rec["obs_mode"])[0] / device_s
