"""The stepped simulation: ``ManiSkillVectorEnv.step`` with auto-reset, under
actions drawn uniformly from the action space on the device from the seed."""
from __future__ import annotations

import time
from typing import Dict

import torch

from .. import state
from ..trace import Tracer

REPORTS = ("env_steps_per_s", "setup_s")
WARMUP_STEPS = 3  # set-up steps before the window, on the window's shapes
TRACE_STEPS = 2  # profiled steps after the window, with --trace 1


def make_env(cfg: dict, cell: dict, device: str):
    """The vector env of a configuration and a cell, through the program's
    ``make``; the configuration's frequencies are checked against the env's."""
    import maniskill_tpu_torch.envs  # noqa: F401  (registers the tasks)
    from maniskill_tpu_torch.utils.registration import make
    from maniskill_tpu_torch.vector import ManiSkillVectorEnv

    env = make(cfg["env_id"], num_envs=cell["traffic"]["num_envs"], obs_mode=cell["traffic"]["obs_mode"],
               control_mode=cfg["control_mode"], reward_mode=cfg["reward_mode"], device=device,
               **cfg.get("make_kwargs", {}))
    base = env.unwrapped
    got = dict(sim_freq=base.sim_freq, control_freq=base.control_freq,
               max_episode_steps=env.max_episode_steps, robot_uids=base.robot_uids
               if isinstance(base.robot_uids, str) else getattr(base.robot_uids, "uid", None))
    for key, value in got.items():
        if key in cfg and cfg[key] != value:
            raise ValueError(f"{cfg['env_id']} runs {key}={value}, the configuration states {cfg[key]}")
    return ManiSkillVectorEnv(env, auto_reset=True, ignore_terminations=False)


def _obs_parts(obs):
    """(state columns (B, D), {camera: rgb (B, H, W, 3)}) of an observation."""
    if isinstance(obs, torch.Tensor):
        return obs, {}
    leaves = []

    def visit(d):
        for v in d.values():
            if isinstance(v, dict):
                visit(v)
            elif v.ndim >= 1:
                leaves.append(v[:, None].to(torch.float32) if v.ndim == 1
                              else v.reshape(v.shape[0], -1).to(torch.float32))

    visit({"agent": obs["agent"], "extra": obs["extra"]})
    frames = {cam: d["rgb"] for cam, d in obs.get("sensor_data", {}).items() if "rgb" in d}
    return torch.cat(leaves, -1), frames


def run(ctx) -> Dict:
    cell, cfg, device = ctx.cell, ctx.config, ctx.device
    traffic = cell["traffic"]
    seed = ctx.seed
    venv = make_env(cfg, cell, device)
    base = venv.base_env
    B = venv.num_envs
    venv.reset(seed=seed % (2 ** 32))

    # the traffic's draws, on the device from the seed
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if traffic.get("stagger_episodes"):
        # episodes spread over their length, so ~1/T of the envs end (and are
        # partially reset) in each step, as in a rollout's steady state
        T = venv.max_episode_steps
        base._elapsed_steps = torch.randint(0, T, (B,), generator=gen, device=device, dtype=torch.int32)
    space = base.single_action_space
    low = torch.as_tensor(space.low, dtype=torch.float32, device=device)
    high = torch.as_tensor(space.high, dtype=torch.float32, device=device)
    rows = torch.randperm(B, generator=gen, device=device)[: cell["check"]["sample_envs"]]

    def action():
        return low + (high - low) * torch.rand((B,) + tuple(space.shape), generator=gen, device=device)

    def step(record: bool):
        a = action()
        rec = None
        if record:
            rec = dict(pre=state.snapshot(base.scene.data), elapsed=base.elapsed_steps.clone(), action=a)
        obs, reward, terminated, truncated, info = venv.step(a)
        if record:
            done = terminated | truncated
            final = info.get("final_observation", obs)
            cols, frames = _obs_parts(final)
            rec.update(obs=cols.clone(), reset_obs=_obs_parts(obs)[0].clone(),
                       seeds=base._episode_seeds.clone(),
                       reward=reward.clone(), terminated=terminated.clone(),
                       truncated=truncated.clone(), done=done.clone(),
                       post_qpos=base.scene.data.qpos.clone(), post_qvel=base.scene.data.qvel.clone(),
                       frames={k: v[rows].clone() for k, v in frames.items()}, rows=rows)
        return rec

    for _ in range(WARMUP_STEPS):
        step(False)
    ctx.sync()
    setup_end = time.perf_counter()

    # the window: whole steps until --seconds have passed; the first step and
    # the last ones (those that may close it) keep what the check compares
    records, step_s = [], []
    t0 = t_prev = time.perf_counter()
    n = 0
    while True:
        elapsed = t_prev - t0
        last_dt = step_s[-1] if step_s else 0.0
        rec = step(n == 0 or elapsed + 2 * last_dt >= ctx.seconds)
        if rec is not None:
            records = (records[:1] + records[1:][-2:] + [rec]) if records else [rec]
        n += 1
        t = time.perf_counter()
        step_s.append(t - t_prev)
        t_prev = t
        if t - t0 >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0

    out = dict(
        setup_end=setup_end,
        metrics=dict(env_steps_per_s=B * n / window_s),
        attempted=B * n,
        records=records,
        steps=n,
        window_s=window_s,
        trace_records=dict(step_s=step_s, obs_mode=traffic["obs_mode"]),
    )
    if ctx.trace:
        tracer = Tracer(ctx.tmpdir)
        with tracer.profile():
            for _ in range(TRACE_STEPS):
                with torch.profiler.record_function("simbench.step"):
                    step(False)
                    ctx.sync()
        out["trace_records"].update(tracer.records(steps=TRACE_STEPS))
    out["memory_peak_bytes"] = ctx.memory_peak()
    return out
