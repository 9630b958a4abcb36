#!/usr/bin/env python3
"""Where the time of one env.step of the PyTorch port goes, on a CUDA card.

    python scripts/profile_torch_step.py --env PickCube-v1 --num-envs 4096 \
        --obs-mode state --out profile_out/pickcube_state

Prints, beside the card's name and power limit:
- ms per env.step over STEPS steps (host clock, synchronized at both ends,
  zero actions);
- ms of the parts of one physics substep on the env's own state (forward
  kinematics, smooth dynamics, collide, solve, the whole substep), each timed
  with CUDA events over repeated calls;
- from a torch.profiler run over PROFILE_STEPS steps: kernel launches, host syncs
  (stream and event synchronizes), memcpy calls and device kernel time per
  step, the device's idle share, and the top kernels by device time.
The profiler's tables and its chrome trace go to --out. The last line is one
JSON object with the numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# timed steps, and steps under the profiler (the PERF.md breakdowns use these)
STEPS = 20
PROFILE_STEPS = 2


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--env", default="PickCube-v1")
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--obs-mode", default="state")
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_step.py needs a CUDA card")
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.physics import collision, dynamics, kinematics, solver
    from maniskill_tpu_torch.physics.step import step as physics_step
    from maniskill_tpu_torch.utils.timing import cuda_ms, profile_calls, timed_steps

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    env = make(args.env, num_envs=args.num_envs, obs_mode=args.obs_mode,
               control_mode="pd_joint_delta_pos", device=dev)
    base = env.unwrapped
    action = torch.zeros((args.num_envs,) + tuple(base.single_action_space.shape), device=dev)
    env.reset(seed=0)
    for _ in range(3):
        env.step(action)

    step_ms = timed_steps(env, action, STEPS) / STEPS * 1e3

    # parts of one substep on the env's current state
    m, d = base.scene.model, base.scene.data
    kin = kinematics.forward_kinematics_raw(m, d.qpos, d.qvel)
    Minv, qvel_pred, _ = dynamics.smooth_dynamics(m, d, kin)
    contact = collision.collide(m, d, kin)
    parts = {
        "forward_kinematics": cuda_ms(lambda: kinematics.forward_kinematics_raw(m, d.qpos, d.qvel), 10),
        "smooth_dynamics": cuda_ms(lambda: dynamics.smooth_dynamics(m, d, kin), 10),
        "collide": cuda_ms(lambda: collision.collide(m, d, kin), 10),
        "solve": cuda_ms(lambda: solver.solve(m, d, Minv, qvel_pred, contact, kin), 10),
        "substep": cuda_ms(lambda: physics_step(m, d), 10),
    }
    n_sub = base.sim_config.sim_steps_per_control

    prof, prof_sum = profile_calls(lambda: env.step(action), PROFILE_STEPS, cpu_ops=True)
    events = prof.key_averages()
    summary = dict(
        env=args.env, num_envs=args.num_envs, obs_mode=args.obs_mode, card=card,
        step_ms=step_ms, env_steps_per_s=args.num_envs / step_ms * 1e3,
        substeps_per_step=n_sub, substep_parts_ms=parts,
        launches_per_step=prof_sum["launches"],
        # a sync inside the step shows as a stream or event sync
        syncs_per_step=prof_sum["syncs"],
        memcpy_per_step=prof_sum["memcpy"],
        h2d_copies_per_step=prof_sum["h2d_copies"],
        device_kernel_ms_per_step=prof_sum["device_kernel_ms"],
        profiled_wall_ms_per_step=prof_sum["wall_ms"],
        device_idle_share=prof_sum["device_idle_share"],
        top_kernels_ms_per_step=prof_sum["top_kernels_ms"],
    )
    with open(os.path.join(args.out, "key_averages.txt"), "w") as f:
        sort = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
        f.write(events.table(sort_by=sort, row_limit=60))
    prof.export_chrome_trace(os.path.join(args.out, "trace.json.gz"))

    print(card)
    print(f"{args.env} {args.obs_mode} x{args.num_envs}: {step_ms:.3f} ms/step "
          f"({summary['env_steps_per_s']:.1f} env-steps/s), {n_sub} substeps")
    for k, v in parts.items():
        print(f"  {k:20s} {v:8.3f} ms")
    print(f"  per step: {summary['launches_per_step']:.0f} launches, {summary['syncs_per_step']:.0f} syncs, "
          f"{summary['memcpy_per_step']:.0f} memcpys, device kernels {summary['device_kernel_ms_per_step']:.3f} ms "
          f"of {summary['profiled_wall_ms_per_step']:.3f} ms (idle {summary['device_idle_share']:.3f})")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
