"""Readings that set a cell's limits: for each seed, a short window at the
cell's own size, then the check's numbers twice, once against the reference
as the configuration states it (the program's reading) and once against the
reference one precision below, with TF32 matmuls (the control's reading).
With ``--fault`` the program runs with that fault planted (``faults.py``)
and only the program's reading is taken. The benchmark's own runs never run
this.

    python3 -m simbench.control --workload <cell> --seconds 3 --seeds 1 2 3 [--fault NAME] [--out FILE]

Each seed's readings are printed as one JSON line (and appended to FILE).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import sys
import tempfile
import time

from simbench import check, faults, spec
from simbench.run import Context


def readings(workload: str, seed: int, seconds: float, device: str = "cuda", overrides: dict = None,
             fault: str = None) -> dict:
    import torch

    from simbench.run import _merge

    cell = _merge(spec.workload(workload), overrides or {})
    cfg = spec.config(cell["config"])
    driver = importlib.import_module(f"simbench.drivers.{cell['driver']}")
    plant = faults.planted(cell["driver"], fault) if fault else contextlib.nullcontext()
    with tempfile.TemporaryDirectory(prefix="simbench-") as tmp, plant:
        out = driver.run(Context(cell, cfg, seed, seconds, False, device, tmp))
    records = out.pop("records")
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    t = time.perf_counter()
    sound, _ = getattr(check, cell["driver"])(cell, cfg, records, device, control=False)
    t_check = time.perf_counter() - t
    row = dict(workload=workload, seed=seed, steps=out["steps"], fault=fault, program=sound, check_s=t_check)
    if not fault:
        row["control"] = getattr(check, cell["driver"])(cell, cfg, records, device, control=True)[0]
    if cell["driver"] == "ppo":
        row["left_out"] = check.ppo_left_out(cell, cfg, records, device)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    for seed in args.seeds:
        row = readings(args.workload, seed, args.seconds, fault=args.fault)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
