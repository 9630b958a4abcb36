"""Run one cell of the benchmark once.

    python3 -m simbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell (``workloads/<cell>.json``) and its configuration
(``configs/<config>.json``), makes the inputs from the seed, warms up, runs
the window, checks what the window's steps produced against the plain
reference, and prints one JSON object as the last line of standard output.
With ``--trace 0`` its metrics are the cell's end-to-end metrics; with
``--trace 1`` a short stretch after the window runs under the profiler and
the metrics are the cell's per-layer metrics (``metrics/<metric>.py``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from simbench import spec  # noqa: E402

# build and kernel caches at fixed paths inside the checkout
CACHE = spec.ROOT / ".simbench_cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
# one process with few threads: the host's work is one Python thread that
# launches kernels, and CPU thread pools only contend with it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")


class Context:
    """What a driver is handed: the cell, its configuration, the seed, the
    window's length, whether to trace, the device and a temporary directory."""

    def __init__(self, cell, config, seed, seconds, trace, device, tmpdir):
        self.cell, self.config, self.seed = cell, config, seed
        self.seconds, self.trace, self.device, self.tmpdir = seconds, trace, device, tmpdir

    def sync(self):
        import torch

        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def memory_peak(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated()) if self.device.startswith("cuda") else 0


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _quarters(step_s) -> str:
    """The mean step time of each quarter of the window, in ms."""
    if len(step_s) < 4:
        return ""
    q = len(step_s) // 4
    parts = [step_s[i * q:(i + 1) * q if i < 3 else None] for i in range(4)]
    return "; step ms by quarter " + " ".join(f"{1e3 * sum(p) / len(p):.1f}" for p in parts)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict = None, t_start: float = None):
    """One run; returns (result line as a dict, lines for standard error)."""
    import torch

    from simbench import check, roofline, trace as tracing

    t_start = T_START if t_start is None else t_start
    cell = _merge(spec.workload(workload), overrides or {})
    cfg = spec.config(cell["config"])
    driver = importlib.import_module(f"simbench.drivers.{cell['driver']}")
    bench = spec.benchmark()
    wanted = spec.cell_metrics(cell["name"], list(driver.REPORTS), bench)
    tmpdir = tempfile.mkdtemp(prefix="simbench-")
    try:
        ctx = Context(cell, cfg, seed, seconds, trace, device, tmpdir)
        if device.startswith("cuda"):
            torch.cuda.reset_peak_memory_stats()
        out = driver.run(ctx)
        setup_s = out["setup_end"] - t_start
        records = out.pop("records")
        gc.collect()
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
        read, failed = getattr(check, cell["driver"])(cell, cfg, records, device)
        correct, table = check.judge(read, cell["check"].get("limits") or {})
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    kind = torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu"
    dev = dict(platform="gpu" if device.startswith("cuda") else "cpu", kind=kind,
               count=int(cell.get("chips", 1)), memory_peak_bytes=out["memory_peak_bytes"])
    metrics, lines = {}, []
    if not trace:
        values = dict(out["metrics"], setup_s=setup_s)
        units = {m["name"]: m.get("unit") for m in (bench or {}).get("end_to_end", [])}
        for m in wanted["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = dict(value=values[m["name"]], unit=units.get(m["name"]))
        result_extra = {}
    else:
        rec = dict(out["trace_records"], driver=cell["driver"], device_kind=kind, platform=dev["platform"])
        for m in wanted["per_layer"]:
            value = spec.metric_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m.get("unit"))
        dev.update(busy_s=rec.get("busy_s", 0.0), window_s=rec.get("window_s", 0.0))
        result_extra = dict(breakdown=tracing.breakdown(rec))
        lines.append(f"trace: {rec.get('steps')} steps profiled, busy {rec.get('busy_s')} s of "
                     f"{rec.get('window_s')} s; card {power_limit() if device.startswith('cuda') else 'cpu'}")
        peak = roofline.peaks(kind)
        if peak and rec.get("calls", {}).get("raster.rasterize_tiles"):
            least, bound = roofline.stage_least(rec["calls"]["raster.rasterize_tiles"], peak, rec["obs_mode"])
            lines.append(f"raster stage: least {least} s, {bound}-bound, against {peak['fp32_flops']} FLOP/s "
                         f"and {peak['hbm_bytes_per_s']} B/s ({peak['source']})")
    lines.append(f"window: {out.get('steps')} steps in {out.get('window_s')} s, setup {setup_s} s"
                 + _quarters(out["trace_records"].get("step_s") or []))
    for name, row in table.items():
        lines.append(f"check {name}: {row['value']!r} limit {row['limit']!r}")
    result = dict(correct=bool(correct), attempted=int(out["attempted"]), failed=int(failed),
                  metrics=metrics, device=dev, **result_extra)
    result["checks"] = table
    return result, lines


def pin_to_one_core() -> None:
    """Keep this process, and the threads it starts, on the last core of
    those it may use: the host's work is one thread that launches kernels,
    and a thread that moves between cores runs slower and less evenly."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cores[-1]})


def main(argv=None) -> int:
    pin_to_one_core()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = spec.workload(args.workload)
    import torch

    torch.set_num_threads(1)
    need = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"simbench: this cell needs {need} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = spec.loaded_forbidden(sys.modules)
    if found:
        print(f"simbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
