"""RFCL baseline CLI (counterpart of maniskill_tpu/examples/baselines/rfcl.py).

Reverse-forward curriculum SAC from a handful of demos
(maniskill_tpu_torch/parallel/rfcl.py). The actor is saved as the JAX
package's CLI saves it: a pickled flax parameter tree of numpy arrays. Runs
on the card unless ``--device cpu`` is given.

Usage:
    python -m maniskill_tpu_torch.examples.baselines.rfcl --env-id PickCube-v1 \\
        --demos demos/PickCube-v1/mp_PickCube-v1.h5 --num-demos 5 --num-envs 64 [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import pickle
import tempfile
import time

EVAL_STEPS = 60  # the reference CLI's greedy evaluation


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--env-id", default="PickCube-v1")
    p.add_argument("--demos", required=True, help="RecordEpisode .h5 file")
    p.add_argument("--num-demos", type=int, default=None)
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--rollout-steps", type=int, default=4)
    p.add_argument("--buffer-steps", type=int, default=512)
    p.add_argument("--total-steps", type=int, default=1_000_000)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--utd", type=int, default=4)
    p.add_argument("--gamma", type=float, default=0.95)
    p.add_argument("--reverse-step-size", type=int, default=4)
    p.add_argument("--success-threshold", type=float, default=0.75)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup-steps", type=int, default=40)
    p.add_argument("--eval-every", type=int, default=200)
    p.add_argument("--save-path", default=os.path.join(tempfile.gettempdir(), "rfcl_params.pkl"))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Returns dict(trainer, obs, elapsed, env_steps_per_s, metrics,
    eval_success) for a caller that goes on with the trainer."""
    args = parse_args(argv)

    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.parallel.rfcl import RFCLConfig, RFCLTrainer, load_demo_states
    from maniskill_tpu_torch.parallel.sac import SACConfig, actor_params_to_flax, evaluate

    demo_states, demo_lens, demos = load_demo_states(args.demos, args.num_demos, device=args.device)
    print(f"loaded {len(demo_lens)} demos, lengths {demo_lens.tolist()}")

    env = make(args.env_id, num_envs=args.num_envs, obs_mode="state", device=args.device)
    obs, _ = env.reset(seed=args.seed)
    obs_dim = obs.shape[-1]
    if demos is not None and demos["obs"].shape[-1] != obs_dim:
        print("demo obs dim mismatch -> replay mixing disabled")
        demos = None

    config = RFCLConfig(
        sac=SACConfig(rollout_steps=args.rollout_steps, buffer_steps=args.buffer_steps, batch_size=args.batch_size,
                      utd=args.utd, gamma=args.gamma),
        reverse_step_size=args.reverse_step_size,
        success_threshold=args.success_threshold,
    )
    trainer = RFCLTrainer(env, demo_states, demo_lens, config, obs_dim, seed=args.seed, demos=demos)
    elapsed = torch.zeros(args.num_envs, dtype=torch.int32, device=trainer.device)

    steps_per_iter = args.num_envs * args.rollout_steps
    iters = args.total_steps // steps_per_iter
    t0 = time.time()
    metrics = {}
    for it in range(iters):
        obs, elapsed, metrics = trainer.train_step(obs, elapsed, learn=it >= args.warmup_steps)
        if it % args.eval_every == 0 or it == iters - 1:
            m = {k: float(v) for k, v in metrics.items()}
            sps = steps_per_iter * (it + 1) / (time.time() - t0)
            print(f"iter {it}/{iters} q_loss {m['q_loss']:.4f} mean_k {m['mean_k']:.1f} "
                  f"reverse_done {m['reverse_done']:.0f} env_steps/s {sps:,.0f}", flush=True)
    sps = steps_per_iter * iters / max(time.time() - t0, 1e-9)

    with open(args.save_path, "wb") as f:
        pickle.dump(actor_params_to_flax(trainer.actor.state_dict()), f)
    print(f"saved actor params to {args.save_path}")

    # greedy eval from standard resets (the forward-phase criterion)
    success, _ = evaluate(env, trainer.actor, seed=args.seed + 1000, steps=EVAL_STEPS)
    rate = float(success.float().mean())
    print(f"final eval success(any): {rate:.3f}")
    return dict(trainer=trainer, obs=obs, elapsed=elapsed, env_steps_per_s=sps, eval_success=rate,
                metrics={k: float(v) for k, v in metrics.items()})


if __name__ == "__main__":
    main()
