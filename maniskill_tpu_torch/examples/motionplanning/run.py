"""Motion-planning demo CLI (counterpart of
maniskill_tpu/examples/motionplanning/run.py): solves a batch of episodes
at once with the scripted solution of ``--env-id`` and prints each batch's
success rate, wall time, control steps and env-steps/s. With
``--save-traj`` every episode is recorded through ``RecordEpisode`` into
``--output-dir/mp_<env-id>.h5`` and ``.json`` (the JSON marks each
episode's success). Runs on the card unless ``--device cpu`` is given.

Usage:
    python -m maniskill_tpu_torch.examples.motionplanning.run --env-id StackCube-v1 \\
        --num-envs 4096 [--episodes N] [--seed S] [--save-traj --output-dir out/]
"""
from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--env-id", default="PickCube-v1")
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-traj", action="store_true")
    p.add_argument("--output-dir", default="out")
    p.add_argument("--episodes", type=int, default=None,
                   help="run batches with fresh seeds until this many episodes succeeded")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Returns dict(success=[the (num_envs,) bool tensor of each batch],
    wall_s=[each batch's seconds], flush=the recorder's flush_stats or
    None)."""
    args = parse_args(argv)

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.examples.motionplanning.solutions import SOLUTIONS

    if args.env_id not in SOLUTIONS:
        raise SystemExit(f"no scripted solution for {args.env_id}; have {sorted(SOLUTIONS)}")
    env = make(args.env_id, num_envs=args.num_envs, obs_mode="state",
               control_mode="pd_joint_pos", device=args.device)
    if args.save_traj:
        from maniskill_tpu_torch.wrappers.record import RecordEpisode

        env = RecordEpisode(env, args.output_dir, save_trajectory=True, save_video=False,
                            trajectory_name=f"mp_{args.env_id}")
    total_succ, total_ep, batch = 0, 0, 0
    result = dict(success=[], wall_s=[], flush=None)
    while True:
        env.reset(seed=args.seed + batch)
        t0 = time.perf_counter()
        info = SOLUTIONS[args.env_id](env)[-1]
        success = info["success"]
        n_succ = int(success.sum())
        total_succ += n_succ
        total_ep += success.shape[0]
        wall = time.perf_counter() - t0
        steps = int(env.unwrapped.elapsed_steps[0])
        result["success"].append(success)
        result["wall_s"].append(wall)
        print(f"{args.env_id} batch {batch}: success {n_succ / success.shape[0]:.4f} "
              f"({total_succ}/{total_ep} cumulative) in {wall:.2f} s, {steps} control steps, "
              f"{success.shape[0] * steps / wall:.1f} env-steps/s", flush=True)
        batch += 1
        if args.episodes is None or total_succ >= args.episodes:
            break
    env.close()
    if args.save_traj:
        result["flush"] = env.flush_stats
        print(f"trajectories in {args.output_dir} (the JSON marks each episode's success; load with "
              "success_only=True to filter)")
    return result


if __name__ == "__main__":
    main()
