"""PPO training: whole ``PPOTrainer`` iterations (``rollout`` then ``update``)
on the configuration's env in state mode. The window's last iteration keeps
what the check compares: the state it started from (the policy, the
optimizer's moments, the generator, the obs and elapsed counters), the env's
state before each rollout step and after the rollout, the trajectory, and
the first minibatch steps of its update."""
from __future__ import annotations

import time
from typing import Dict

import torch

from .. import state
from ..trace import Tracer

REPORTS = ("train_env_steps_per_s", "setup_s")
CHECK_STEPS = 3  # minibatch steps of the checked update that the reference follows


def _moments(opt, params, key: str):
    """Copies of Adam's ``key`` moment of each parameter (zeros before its
    first step)."""
    return [opt.state[p][key].clone() if key in opt.state.get(p, {}) else torch.zeros_like(p) for p in params]


def _watch(trainer, base, n: int):
    """Hooks on the next iteration: the env's state before each rollout step,
    and of the update's first ``n`` minibatch steps each loss, Adam's first
    moments after the first and the parameters after the ``n``-th."""
    import maniskill_tpu_torch.parallel.train as train

    opt, params = trainer.optimizer, list(trainer.model.parameters())
    kept = dict(pre=[], losses=[], adam1=None, params_n=None)
    done_steps = [0]
    step_fn, orig_loss = trainer.step_fn, train.ppo_loss

    def watched_step(action):
        kept["pre"].append(state.snapshot(base.scene.data))
        return step_fn(action)

    def loss(model, mb, cfg):
        value = orig_loss(model, mb, cfg)
        if len(kept["losses"]) < n:
            kept["losses"].append(value.detach().clone())
        return value

    def after_step(o, args, kwargs):
        done_steps[0] += 1
        if done_steps[0] == 1:
            kept["adam1"] = _moments(opt, params, "exp_avg")
        if done_steps[0] == n:
            kept["params_n"] = [p.detach().clone() for p in params]

    trainer.step_fn = watched_step
    train.ppo_loss = loss
    handle = opt.register_step_post_hook(after_step)

    def remove():
        trainer.step_fn = step_fn
        train.ppo_loss = orig_loss
        handle.remove()

    return kept, remove


def run(ctx) -> Dict:
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch.parallel.train import PPOConfig, PPOTrainer
    from maniskill_tpu_torch.utils.registration import make

    cell, cfg, device = ctx.cell, ctx.config, ctx.device
    traffic = cell["traffic"]
    B = traffic["num_envs"]
    env = make(cfg["env_id"], num_envs=B, obs_mode="state", control_mode=cfg["control_mode"],
               reward_mode=cfg["reward_mode"], device=device, **cfg.get("make_kwargs", {}))
    base = env.unwrapped
    if (base.sim_freq, base.control_freq) != (cfg["sim_freq"], cfg["control_freq"]):
        raise ValueError("the env's frequencies differ from the configuration's")
    obs, _ = env.reset(seed=ctx.seed % (2 ** 32))
    pc = PPOConfig(**traffic["ppo"])
    iters = max(1, traffic["total_steps"] // (B * pc.rollout_steps))
    trainer = PPOTrainer(env, pc, obs, seed=ctx.seed % (2 ** 63), total_updates=iters)
    obs = trainer.obs_tf(obs)
    gen = torch.Generator(device=device)
    gen.manual_seed(ctx.seed)
    T = env.max_episode_steps
    # episodes spread over their length, as in a rollout's steady state
    elapsed = torch.randint(0, T, (B,), generator=gen, device=device, dtype=torch.int32)
    params = list(trainer.model.parameters())
    names = [k for k, _ in trainer.model.named_parameters()]
    updates = 0  # updates run so far

    def iteration(timed: bool, watch: bool):
        nonlocal obs, elapsed, updates
        rec = kept = None
        if watch:
            opt = trainer.optimizer
            rec = dict(obs=obs.clone(), elapsed=elapsed.clone(), params=[p.detach().clone() for p in params],
                       names=names, generator=trainer.generator.get_state(), config=pc._asdict(),
                       total_updates=iters, updates_before=updates, max_episode_steps=trainer.max_steps,
                       adam_m=_moments(opt, params, "exp_avg"), adam_v=_moments(opt, params, "exp_avg_sq"))
            kept, remove = _watch(trainer, base, CHECK_STEPS)
        try:
            if timed:
                ctx.sync()
                t = time.perf_counter()
            obs, elapsed, traj = trainer.rollout(obs, elapsed)
            if watch:
                kept["pre"].append(state.snapshot(base.scene.data))
                rec.update(traj=tuple(x.clone() for x in traj), obs_after=obs.clone(),
                           elapsed_after=elapsed.clone())
            if timed:
                ctx.sync()
                t1 = time.perf_counter()
                rollout_s.append(t1 - t)
            trainer.update(obs, traj)
            if timed:
                ctx.sync()
                update_s.append(time.perf_counter() - t1)
        finally:
            if watch:
                remove()
        updates += 1
        if watch:
            rec.update(pre=kept["pre"], losses=[float(x) for x in kept["losses"]], adam1=kept["adam1"],
                       params_n=kept["params_n"])
        return rec

    # set-up: the first iteration, on the object the window then drives
    rollout_s, update_s = [], []
    iteration(False, False)
    ctx.sync()
    setup_end = time.perf_counter()

    # the window: whole iterations until --seconds have passed; the first and
    # those that may close it keep what the check compares, and the last of
    # them is checked
    record, last = None, 0.0
    t0 = time.perf_counter()
    k = 0
    while True:
        t_it = time.perf_counter()
        rec = iteration(ctx.trace, k == 0 or t_it - t0 + 2 * last >= ctx.seconds)
        record = rec or record
        k += 1
        last = time.perf_counter() - t_it
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    steps = k * B * pc.rollout_steps
    out = dict(setup_end=setup_end, metrics=dict(train_env_steps_per_s=steps / window_s),
               attempted=steps, records=[record], steps=k, window_s=window_s,
               trace_records=dict(rollout_s=rollout_s, update_s=update_s))
    if ctx.trace:
        tracer = Tracer(ctx.tmpdir)
        with tracer.profile():
            iteration(False, False)
        out["trace_records"].update(tracer.records(steps=1))
    out["memory_peak_bytes"] = ctx.memory_peak()
    return out
