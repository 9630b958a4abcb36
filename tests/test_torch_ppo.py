"""The port's PPO trainer (maniskill_tpu_torch/parallel/train.py) against the
JAX package's (maniskill_tpu/parallel/train.py), on the CPU.

- ``compute_gae`` on random (T=4, B=8) trajectories at 1e-6.
- ``ppo_loss`` and its gradients against ``jax.value_and_grad`` on the same
  params and minibatch at 1e-5 relative to the largest entry.
- Two clip + Adam updates under the linear learning-rate decay against the
  reference's optax chain at 1e-5 (the port clips as optax does, with no
  epsilon added to the norm; Adam's algebra is the same, rounding differs).
- The repo's state checkpoint carried into the port's ``ActorCritic``: mean,
  log std and value at 1e-5; the rgb checkpoint into ``VisualActorCritic``
  at 1e-4 relative (bf16, measured in its test); both round-trip exactly.
- A rollout of the port's trainer replayed through the JAX env and policy
  (rewards, values, log-probs at 1e-3 relative to their magnitude, dones
  equal), and the state checkpoint in closed loop in both packages
  (actions at 1e-3).
- One whole ``train_step`` in the state branch on the CPU.

The JAX inner functions are closures of ``train_step``; the reference solver
runs with its bf16 matvec cast made an identity (tests/test_torch_common.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.parallel import train as jtrain
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.parallel import train as ttrain

from test_torch_common import f32_reference_solver, one_torch_thread, tree  # noqa: F401

B = 8
STATE_CKPT = "examples_checkpoints/ppo_pickcube_state.pkl"
RGB_CKPT = "examples_checkpoints/ppo_pushcube_rgb.pkl"
CFG = dict(gamma=0.8, gae_lambda=0.9, update_epochs=1, num_minibatches=1)


def _closures(fn):
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def _close_rel(a, b, tol, what=""):
    """|b - a| <= tol * max(1, max|a|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(b, a, rtol=0, atol=tol * max(1.0, float(np.abs(a).max())), err_msg=what)


@pytest.fixture(scope="module")
def envs(f32_reference_solver):
    """(JAX env, port env), PickCube-v1 state, the JAX solver in f32."""
    je = jmake("PickCube-v1", num_envs=B, obs_mode="state")
    te = tmake("PickCube-v1", num_envs=B, obs_mode="state", device="cpu")
    return je, te


@pytest.fixture(scope="module")
def jax_ppo(envs):
    """The reference's model, init_state and train_step closures (with
    ppo_loss's value and gradient jitted: eager JAX is far slower)."""
    model, init_state, train_step = jtrain.make_train_step(envs[0], jtrain.PPOConfig(**CFG))
    inner = _closures(train_step)
    inner["loss_and_grad"] = jax.jit(jax.value_and_grad(inner["ppo_loss"]))
    return model, init_state, inner


def _port_trainer(te, obs, **cfg):
    return ttrain.PPOTrainer(te, ttrain.PPOConfig(**{**CFG, **cfg}), obs, seed=0)


def test_compute_gae_matches_reference(jax_ppo):
    _, _, inner = jax_ppo
    rng = np.random.default_rng(0)
    T = 4
    rew = rng.normal(size=(T, B)).astype(np.float32)
    done = rng.uniform(size=(T, B)) < 0.3
    val = rng.normal(size=(T, B)).astype(np.float32)
    last = rng.normal(size=B).astype(np.float32)
    traj = (None, None, None, jnp.asarray(rew), jnp.asarray(done), jnp.asarray(val), None)
    jadv, jret = inner["compute_gae"](traj, jnp.asarray(last))
    tadv, tret = ttrain.compute_gae(torch.as_tensor(rew), torch.as_tensor(done), torch.as_tensor(val),
                                    torch.as_tensor(last), CFG["gamma"], CFG["gae_lambda"])
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), rtol=0, atol=1e-6)


def _batch(rng, n, obs_dim=51, act_dim=8):
    return (rng.normal(size=(n, obs_dim)).astype(np.float32),
            rng.uniform(-1.5, 1.5, (n, act_dim)).astype(np.float32),
            rng.normal(-8, 1, n).astype(np.float32),
            rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


def _grads_as_flax(model):
    return ttrain.params_to_flax({k: p.grad for k, p in model.named_parameters()})


def _assert_trees_close(jtree, ttree, tol, what):
    jflat = jax.tree_util.tree_leaves_with_path(jtree)
    for path, jv in jflat:
        tv = ttree
        for p in path:
            tv = tv[p.key]
        _close_rel(jv, tv, tol, f"{what}{jax.tree_util.keystr(path)}")


def test_ppo_loss_and_grads_match_reference(envs, jax_ppo):
    _, init_state, inner = jax_ppo
    params, _, _ = init_state(jax.random.PRNGKey(3), 51)
    te = envs[1]
    trainer = _port_trainer(te, torch.zeros(B, 51))
    trainer.model.load_state_dict(ttrain.params_from_flax(jax.device_get(params)))
    batch = _batch(np.random.default_rng(1), 64)

    jloss, jgrads = inner["loss_and_grad"](params, tuple(map(jnp.asarray, batch)))
    tloss = ttrain.ppo_loss(trainer.model, tuple(map(torch.as_tensor, batch)), trainer.config)
    tloss.backward()
    _close_rel(float(jloss), float(tloss.detach()), 1e-5, "loss")
    _assert_trees_close(jgrads, _grads_as_flax(trainer.model), 1e-5, "grad")


def test_clip_and_adam_updates_match_reference(envs, jax_ppo):
    """Two updates with large gradients (the clip engages) under the linear
    decay over 2 updates x 1 epoch x 1 minibatch."""
    _, init_state, inner = jax_ppo
    params, opt_state, tx = init_state(jax.random.PRNGKey(4), 51, total_updates=2)
    trainer = ttrain.PPOTrainer(envs[1], ttrain.PPOConfig(**CFG), torch.zeros(B, 51), total_updates=2)
    trainer.model.load_state_dict(ttrain.params_from_flax(jax.device_get(params)))
    rng = np.random.default_rng(2)
    tparams = list(trainer.model.parameters())
    for _ in range(2):
        batch = _batch(rng, 64)
        _, grads = inner["loss_and_grad"](params, tuple(map(jnp.asarray, batch)))
        grads = jax.tree_util.tree_map(lambda g: 50.0 * g, grads)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        tgrads = ttrain.params_from_flax(jax.device_get(grads))
        for name, p in trainer.model.named_parameters():
            p.grad = tgrads[name].clone()
        ttrain.clip_by_global_norm_(tparams, trainer.config.max_grad_norm)
        trainer.optimizer.step()
        trainer.scheduler.step()
    _assert_trees_close(params, ttrain.params_to_flax(trainer.model.state_dict()), 1e-5, "params")


def test_state_checkpoint_carries_across():
    tree = ttrain.load_jax_checkpoint(STATE_CKPT)
    model = ttrain.ActorCritic(51, 8)
    model.load_state_dict(ttrain.params_from_flax(tree))
    obs = np.random.default_rng(5).normal(size=(64, 51)).astype(np.float32)
    jm, jls, jv = jtrain.ActorCritic(8).apply(tree, jnp.asarray(obs))
    with torch.no_grad():
        tm, tls, tv = model(torch.as_tensor(obs))
    for what, a, b in (("mean", jm, tm), ("log_std", jls, tls), ("value", jv, tv)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5, err_msg=what)


def test_rgb_checkpoint_carries_across():
    """bf16 convolutions on both sides, rounded at other places by XLA's CPU
    convolution and torch's: on these 8 random frames the mean differs by at
    most 1.6e-4 (|mean| up to 11.6) and the value by 2.0e-4 (|value| up to
    19.2); other seeds gave up to 6.1e-4. The bound is 1e-4 relative to the
    largest magnitude; the log std is equal."""
    tree = ttrain.load_jax_checkpoint(RGB_CKPT)
    model = ttrain.VisualActorCritic((128, 128, 3), 34, 8)
    model.load_state_dict(ttrain.params_from_flax(tree))
    rng = np.random.default_rng(6)
    rgb = rng.integers(0, 256, (8, 128, 128, 3), dtype=np.uint8)
    state = rng.normal(size=(8, 34)).astype(np.float32)
    jm, jls, jv = jtrain.VisualActorCritic(8).apply(tree, dict(rgb=jnp.asarray(rgb), state=jnp.asarray(state)))
    with torch.no_grad():
        tm, tls, tv = model(dict(rgb=torch.as_tensor(rgb), state=torch.as_tensor(state)))
    _close_rel(jm, tm.numpy(), 1e-4, "mean")
    np.testing.assert_array_equal(tls.numpy(), np.asarray(jls))
    _close_rel(jv, tv.numpy(), 1e-4, "value")


@pytest.mark.parametrize("path", [STATE_CKPT, RGB_CKPT])
def test_params_round_trip_exactly(path):
    tree = ttrain.load_jax_checkpoint(path)
    back = ttrain.params_to_flax(ttrain.params_from_flax(tree))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path_
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path_))


def _same_start(je, te, seed):
    """Both envs at the JAX env's reset state for ``seed``; returns the
    port's obs."""
    je.reset(seed=seed)
    state = tree(je.unwrapped.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))
    obs, _ = te.reset(seed=seed, options=dict(reset_to_env_states=state))
    return obs


def test_rollout_replays_through_the_reference(envs):
    """4 rollout steps of the port's trainer (the state checkpoint's policy,
    no episode boundary in the window) replayed through the JAX env and the
    carried-over params. Each quantity at 1e-3 relative to its largest
    magnitude: the trained policy's std is ~0.03, so the log-probs (~19)
    scale the 1e-4 obs differences of the two solvers up to 1.8e-3."""
    je, te = envs
    tree = ttrain.load_jax_checkpoint(STATE_CKPT)
    obs = _same_start(je, te, 11)
    trainer = _port_trainer(te, obs, rollout_steps=4)
    trainer.model.load_state_dict(ttrain.params_from_flax(tree))
    _, _, (t_obs, t_act, t_logp, t_rew, t_done, t_val, _) = trainer.rollout(
        obs, torch.zeros(B, dtype=torch.int32))
    assert not t_done.any()

    model = jtrain.ActorCritic(8)
    jobs = jnp.asarray(obs.numpy())
    for t in range(4):
        np.testing.assert_allclose(t_obs[t].numpy(), np.asarray(jobs), rtol=0, atol=1e-3, err_msg=f"obs {t}")
        mean, log_std, value = model.apply(tree, jobs)
        act = jnp.asarray(t_act[t].numpy())
        logp = -0.5 * jnp.sum(((act - mean) / jnp.exp(log_std)) ** 2 + 2 * log_std + jnp.log(2 * jnp.pi), -1)
        _close_rel(value, t_val[t].numpy(), 1e-3, f"value {t}")
        _close_rel(logp, t_logp[t].numpy(), 1e-3, f"logp {t}")
        jobs, rew, term, _, _ = je.step(act)
        _close_rel(rew, t_rew[t].numpy(), 1e-3, f"reward {t}")
        assert not np.asarray(term).any()


def test_state_checkpoint_closed_loop_matches_reference(envs):
    """5 greedy steps of the state checkpoint in both packages from the same
    reset state: the actions agree at 1e-3."""
    je, te = envs
    tree = ttrain.load_jax_checkpoint(STATE_CKPT)
    model = ttrain.ActorCritic(51, 8)
    model.load_state_dict(ttrain.params_from_flax(tree))
    jmodel = jtrain.ActorCritic(8)
    tobs = _same_start(je, te, 21)
    jobs = jnp.asarray(tobs.numpy())
    for t in range(5):
        jact = jmodel.apply(tree, jobs)[0]
        with torch.no_grad():
            tact = model(tobs)[0]
        np.testing.assert_allclose(tact.numpy(), np.asarray(jact), rtol=0, atol=1e-3, err_msg=f"action {t}")
        jobs, *_ = je.step(jact)
        tobs, *_ = te.step(tact)


def test_state_train_step(envs):
    """One whole iteration (rollout 2, 2 epochs x 2 minibatches) on the CPU."""
    te = envs[1]
    obs, _ = te.reset(seed=0)
    trainer = _port_trainer(te, obs, rollout_steps=2, update_epochs=2, num_minibatches=2)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    obs, elapsed, metrics = trainer.train_step(obs, torch.zeros(B, dtype=torch.int32))
    assert np.isfinite(float(metrics["loss"]))
    for k in ("bad_params", "bad_obs", "bad_rewards"):
        assert int(metrics[k]) == 0, k
    assert elapsed.tolist() == [2] * B and obs.shape == (B, 51)
    assert any(not torch.equal(a, b) for a, b in zip(before, trainer.model.parameters()))

