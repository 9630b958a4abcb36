#!/usr/bin/env python3
"""Host time of the port's BatchedRNG calls at a reset's batch size, on a
CUDA card.

    python scripts/time_batched_rng.py [--root DIR]

Imports ``maniskill_tpu_torch`` from ``--root`` (default: this checkout), so
two checkouts, for example a parent commit unpacked beside this one, can be
timed in one call. At NUM_ENVS envs, for ``from_seeds`` with host seeds (a
numpy array) and with device seeds (an int64 tensor on the card), and for
each draw a PickCube reset makes (``uniform(size=(2,))``, ``uniform()``, ``normal(size=(9,))``,
``quaternions(lock_x, lock_y)``), prints the mean ms per call over REPS calls
on the host clock with the device synchronized before and after each call,
beside the card's name and power limit; the last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPS = 20
NUM_ENVS = 4096  # the PickCube state cells' batch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_batched_rng.py needs a CUDA card")
    from maniskill_tpu_torch.envs.utils.randomization.batched_rng import BatchedRNG

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    seeds = np.arange(NUM_ENVS, dtype=np.int64)
    dev_seeds = torch.as_tensor(seeds, device="cuda")
    rng = BatchedRNG.from_seeds(seeds, "cuda")
    calls = {
        "from_seeds(host seeds)": lambda: BatchedRNG.from_seeds(seeds, "cuda"),
        "from_seeds(device seeds)": lambda: BatchedRNG.from_seeds(dev_seeds, "cuda"),
        "uniform(size=(2,))": lambda: rng.uniform(-0.1, 0.1, (2,)),
        "uniform()": lambda: rng.uniform(0.0, 0.3),
        "normal(size=(9,))": lambda: rng.normal(0.0, 0.02, size=(9,)),
        "quaternions(lock_x, lock_y)": lambda: rng.quaternions(lock_x=True, lock_y=True),
    }
    out = {}
    for name, fn in calls.items():
        fn()
        total = 0.0
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            total += time.perf_counter() - t0
        out[name] = total / REPS * 1e3
    print(card)
    for name, ms in out.items():
        print(f"{name:30s} {ms:9.4f} ms per call at {NUM_ENVS} envs ({args.root})")
    print(json.dumps(dict(root=os.path.abspath(args.root), num_envs=NUM_ENVS, card=card, ms_per_call=out)))


if __name__ == "__main__":
    main()
