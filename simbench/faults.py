"""Faults planted in the program's timed path, each a context manager that
patches the program and undoes the patch on exit. The benchmark's runs never
plant one: the check's tests do, to see ``correct`` come out false, and
``simbench.control --fault`` reads the check's numbers under one on the card.

vector_env cells: ``state_unchanged`` (a physics step returns its state),
``half_batch`` (half the envs left unstepped), ``reward_altered`` (PickCube's
reward moved by 0.01 where it is made), ``frame_altered`` (one pixel column of
every frame altered where the rasterizer writes it).

ppo cells: ``state_unchanged`` (the optimizer's step leaves the parameters
and its moments as they were), ``half_batch`` (each minibatch's loss over
its first half, the mean taken over it), ``loss_altered`` (each loss scaled
by 1.001 where it is made), ``bootstrap_dropped`` (the rollout leaves out the
discounted value of an ended episode's final obs), ``stale_obs`` (the
rollout hands on an ended episode's final obs in place of its reset obs).
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = {
    "vector_env": ("state_unchanged", "half_batch", "reward_altered", "frame_altered"),
    "ppo": ("state_unchanged", "half_batch", "loss_altered", "bootstrap_dropped", "stale_obs"),
}


@contextlib.contextmanager
def _patched(owner, attr, value):
    old = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, old)


def _half_stepped(orig):
    def step(model, data):
        new = orig(model, data)
        h = data.qpos.shape[0] // 2
        qpos, qvel = new.qpos.clone(), new.qvel.clone()
        qpos[h:], qvel[h:] = data.qpos[h:], data.qvel[h:]
        return new.replace(qpos=qpos, qvel=qvel)
    return step


def _rollout_without_bootstrap(self, obs, elapsed):
    """``PPOTrainer.rollout`` with the bootstrap of ended episodes left out."""
    from maniskill_tpu_torch.parallel.train import gaussian_logp

    cfg, model, g = self.config, self.model, self.generator
    steps = []
    with torch.no_grad():
        for _ in range(cfg.rollout_steps):
            mean, log_std, value = model(obs)
            noise = torch.randn(mean.shape, generator=g, device=self.device)
            action = mean + torch.exp(log_std) * noise
            logp = gaussian_logp(action, mean, log_std)
            new_obs, reward, terminated = self.step_fn(action)
            elapsed = elapsed + 1
            done = terminated | (elapsed >= self.max_steps)
            model(new_obs)  # the value pass runs as in the program; its value is dropped
            seeds = torch.randint(0, 2**31, (self.num_envs,), generator=g, device=self.device)
            reset_obs = self.reset_fn(done, seeds)
            elapsed = torch.where(done, 0, elapsed)
            steps.append((obs, action, logp, reward, done, value, terminated))
            obs = reset_obs
    return obs, elapsed, tuple(torch.stack([s[i] for s in steps]) for i in range(7))


def _stale_after_reset(make):
    """``make_env_step_fns`` whose reset hands back the step's obs."""
    def make_fns(env, obs_tf=lambda o: o):
        step_fn, reset_fn = make(env, obs_tf)
        last = {}

        def step(action):
            out = step_fn(action)
            last["obs"] = out[0]
            return out

        def reset(mask, seeds):
            reset_fn(mask, seeds)
            return last["obs"]

        return step, reset
    return make_fns


def planted(driver: str, name: str):
    """The context manager that plants fault ``name`` of a ``driver``'s cells."""
    if name not in FAULTS[driver]:
        raise ValueError(f"no fault {name!r} for {driver} cells: {FAULTS[driver]}")
    if driver == "vector_env":
        import maniskill_tpu_torch.physics as phys

        if name == "state_unchanged":
            return _patched(phys, "step", lambda model, data: data)
        if name == "half_batch":
            return _patched(phys, "step", _half_stepped(phys.step))
        if name == "reward_altered":
            from maniskill_tpu_torch.envs.tasks.tabletop.pick_cube import PickCubeEnv

            orig = PickCubeEnv.compute_dense_reward
            return _patched(PickCubeEnv, "compute_dense_reward", lambda self, **kw: orig(self, **kw) + 0.01)
        import maniskill_tpu_torch.render.rasterizer as rasterizer

        orig = rasterizer.rasterize_tiles

        def altered(*args):
            zbuf, seg, rgb, dropped = orig(*args)
            col = torch.arange(rgb.shape[2], device=rgb.device)[None, None, :, None] == 7
            return zbuf, seg, torch.where(col, 0.5, rgb), dropped

        return _patched(rasterizer, "rasterize_tiles", altered)

    import maniskill_tpu_torch.parallel.train as train

    if name == "state_unchanged":
        return _patched(torch.optim.Adam, "step", lambda self, closure=None: None)
    if name == "bootstrap_dropped":
        return _patched(train.PPOTrainer, "rollout", _rollout_without_bootstrap)
    if name == "stale_obs":
        return _patched(train, "make_env_step_fns", _stale_after_reset(train.make_env_step_fns))
    orig = train.ppo_loss
    if name == "half_batch":
        def loss(model, mb, cfg):
            h = mb[1].shape[0] // 2
            return orig(model, tuple(x[:h] for x in mb), cfg)
    else:
        def loss(model, mb, cfg):
            return orig(model, mb, cfg) * 1.001
    return _patched(train, "ppo_loss", loss)
