#!/usr/bin/env python3
"""How often torch.profiler loses device-side records of a profiled step on
a CUDA card shared with other busy processes.

    python scripts/profiler_record_loss.py --seconds 300 --load-procs 2

Starts --load-procs processes that step PickCube-v1 x4096 (state) and
profile one step in four, as chip_smoke.py's side processes do beside its
SB3 phase. Meanwhile it profiles one SB3-adapter step of PickCube-v1 x256
(numpy actions, one device-to-host copy) after another for --seconds, each
with ``profile_calls``, and prints, beside the card's name and power limit:
- the samples, and how many kept every kernel record (kernel records equal
  to launches);
- the device-to-host copy records counted in the samples that kept every
  kernel record, and in those that did not;
- each sample that lost records: launches, kernel records, copy records.
The last line is one JSON object with the counts.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LOAD_ENVS = 4096
SB3_ENVS = 256


def load(seconds: float):
    """Step PickCube-v1 x LOAD_ENVS for ``seconds``, one step in four profiled."""
    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.utils.timing import profile_calls

    env = make("PickCube-v1", num_envs=LOAD_ENVS, obs_mode="state", device="cuda")
    env.reset(seed=0)
    action = torch.zeros((LOAD_ENVS,) + env.unwrapped.single_action_space.shape, device="cuda")
    t0 = time.time()
    while time.time() - t0 < seconds:
        profile_calls(lambda: env.step(action), 1)
        for _ in range(3):
            env.step(action)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--load-procs", type=int, default=2)
    ap.add_argument("--load", type=float, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.load is not None:
        load(args.load)
        return

    import numpy as np
    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.utils.timing import profile_calls
    from maniskill_tpu_torch.vector.sb3 import ManiSkillSB3VectorEnv

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--load", str(args.seconds + 30)])
             for _ in range(args.load_procs)]
    try:
        vec = ManiSkillSB3VectorEnv(make("PickCube-v1", num_envs=SB3_ENVS, obs_mode="state", device="cuda"))
        vec.reset()
        actions = np.random.default_rng(0).uniform(-1, 1, (SB3_ENVS,) + vec.action_space.shape).astype(np.float32)
        for _ in range(3):
            vec.step(actions)
        samples = []
        t0 = time.time()
        while time.time() - t0 < args.seconds:
            prof, step = profile_calls(lambda: vec.step(actions), 1)
            d2h = sum(e.count for e in prof.key_averages() if e.key.startswith("Memcpy DtoH"))
            samples.append((int(step["launches"]), int(step["kernel_records"]), d2h))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    whole = [s for s in samples if s[0] == s[1]]
    lost = [s for s in samples if s[0] != s[1]]
    out = dict(samples=len(samples), whole=len(whole), lost=len(lost),
               d2h_whole=dict(collections.Counter(s[2] for s in whole)),
               d2h_lost=dict(collections.Counter(s[2] for s in lost)),
               lost_samples=[dict(launches=a, kernel_records=b, d2h=c) for a, b, c in lost])
    print(f"{len(samples)} profiled SB3 steps (PickCube-v1 x{SB3_ENVS}) beside {args.load_procs} processes stepping "
          f"x{LOAD_ENVS}: {len(whole)} kept every kernel record, {len(lost)} lost some; device-to-host copy "
          f"records {out['d2h_whole']} in the whole ones, {out['d2h_lost']} in the others [{card}]")
    for s in out["lost_samples"]:
        print(f"  lost: {s['kernel_records']} kernel records of {s['launches']} launches, {s['d2h']} "
              f"device-to-host copy records")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
