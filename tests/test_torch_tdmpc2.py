"""The port's TD-MPC2 (maniskill_tpu_torch/parallel/tdmpc2.py) against the
JAX package's (maniskill_tpu/parallel/tdmpc2.py), on the CPU, at small
widths (latent and mlp 32, 3 Q heads, horizon 2, 16 samples) on
MS-CartpoleBalance-v1 at 2 envs.

The two RNGs draw different numbers, so every JAX draw is recomputed here
with the same ``jax.random`` calls on the same keys and fed to the port
(``plan(draws=)``, ``update_once(draws)``). The JAX inner functions are
closures of ``train_step`` and ``act``. Tolerances:
- ``symlog``, ``symexp``, ``two_hot`` (with its wrap at ``vmax``) and
  ``soft_ce`` at 1e-6; ``two_hot_inv`` at 2e-6 relative: ``torch.linspace``
  and XLA round 82 of the 101 bins apart (by up to 1.2e-6 in symlog
  space), and ``symexp`` scales a symlog error e by (1 + |x|), so the
  decoded value parts by up to ~1.2e-6 x (1 + |x|) / |x| relative (1.43e-6
  measured on these logits).
- Each network from carried params at 1e-5; the params round-trip exactly.
- ``plan`` (the action and the new mean) at 1e-5.
- ``model_loss``, ``pi_loss`` and their gradients (``dropout=0.0`` on both
  sides) at 1e-5 relative to the largest magnitude.
- Two ``update_once`` calls: losses and the Q scale at 1e-5 relative;
  params and the EMA target within 2 x lr per update of the reference (an
  Adam step moves each entry by about lr x sign(g), so an entry whose
  gradient the packages round to opposite signs parts by up to 2 x lr; the
  gradients are held at 1e-5 above) and within 1e-5 on at least 0.999 of
  the entries (measured: the model's params part by up to 3.6e-5, and
  0.99993 of the entries by under 1e-6, after each update).
- One whole ``train_step`` and the CLI at ``--device cpu`` (``--no-mpc``:
  the planner at the CLI's 512-wide defaults is hours of CPU time).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.parallel import tdmpc2 as jt
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.examples.baselines import tdmpc2 as tdmpc2_cli
from maniskill_tpu_torch.parallel import tdmpc2 as tt
from maniskill_tpu_torch.parallel.train import load_jax_checkpoint, params_from_flax, params_to_flax

from test_torch_common import (  # noqa: F401
    assert_adam_params_close, assert_trees_equal, close_rel, closures, one_torch_thread, tree_leaves,
)

B = 2
EP_LEN = 1000  # MS-CartpoleBalance-v1
CFG = dict(horizon=2, num_samples=16, num_elites=4, num_pi_trajs=2, iterations=2, latent_dim=32, simnorm_dim=8,
           enc_dim=32, mlp_dim=32, num_q=3, batch_size=8, rollout_steps=2, buffer_steps=EP_LEN, num_updates=1,
           dropout=0.0)
TOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    """The JAX package's TD-MPC2 at CFG: its config, initial state, and its
    inner functions jitted."""
    env = jmake("MS-CartpoleBalance-v1", num_envs=B, obs_mode="state")
    obs, _ = env.reset(seed=0)
    cfg = jt.TDMPC2Config(**CFG)
    init_state, train_step, act = jt.make_tdmpc2_step(env, cfg)
    upd = closures(closures(train_step)["update_once"])
    acts = closures(act)
    return dict(
        cfg=cfg, obs_dim=obs.shape[-1], act_dim=1, state=init_state(jax.random.PRNGKey(0), obs.shape[-1]),
        encoder=acts["encoder"], policy=acts["policy"],
        plan=jax.jit(acts["plan"], static_argnames=("eval_mode",)),
        update_once=jax.jit(closures(train_step)["update_once"]),
        model_loss=jax.jit(jax.value_and_grad(upd["model_loss"], has_aux=True)),
        pi_loss=jax.jit(jax.value_and_grad(upd["pi_loss_fn"], has_aux=True)),
    )


@pytest.fixture(scope="module")
def port_env():
    return tmake("MS-CartpoleBalance-v1", num_envs=B, obs_mode="state", device="cpu")


def _port(port_env, ref, state):
    """A port trainer holding the JAX state's params, target, scale, ring
    and warm start."""
    tr = tt.TDMPC2Trainer(port_env, tt.TDMPC2Config(**CFG), ref["obs_dim"])
    state = jax.device_get(state)
    tr.model.load_state_dict(tt.model_params_from_flax(state.model_params))
    tr.pi.load_state_dict(tt.pi_params_from_flax(state.pi_params))
    tr.q_target.load_state_dict(params_from_flax(state.q_target, tt.MLP_NAMES))
    tr.q_scale = torch.tensor(float(state.q_scale))
    for k in ("buf_obs", "buf_act", "buf_rew", "prev_mean"):
        setattr(tr, k, torch.as_tensor(np.array(getattr(state, k))))
    tr.ptr, tr.filled = int(state.ptr), int(state.filled)
    return tr


def _filled_state(ref, seed):
    """The reference's state with a whole episode of random transitions in
    its ring."""
    rng = np.random.default_rng(seed)
    S = CFG["buffer_steps"]
    return ref["state"]._replace(
        buf_obs=jnp.asarray(rng.normal(size=(S, B, ref["obs_dim"])).astype(np.float32)),
        buf_act=jnp.asarray(rng.uniform(-1, 1, (S, B, ref["act_dim"])).astype(np.float32)),
        buf_rew=jnp.asarray(rng.uniform(0, 1, (S, B)).astype(np.float32)),
        filled=jnp.int32(S),
        prev_mean=jnp.asarray(rng.uniform(-1, 1, (B, CFG["horizon"], ref["act_dim"])).astype(np.float32)))


def _t(x):
    return torch.as_tensor(np.array(x))


# -- math ---------------------------------------------------------------------

def test_math_matches_reference():
    cfg = jt.TDMPC2Config()
    rng = np.random.default_rng(0)
    # values across the bins, both clip edges, and symlog(x) == vmax exactly
    # (the upper bin wraps to bin 0 with weight 0)
    x = np.concatenate([rng.normal(0, 30, 64), [-1e6, 1e6, 0.0, float(np.expm1(10.0))]]).astype(np.float32)
    for f in ("symlog", "symexp"):
        arg = x if f == "symlog" else np.clip(x, -10, 10)
        close_rel(getattr(jt, f)(jnp.asarray(arg)), getattr(tt, f)(torch.as_tensor(arg)).numpy(), 1e-6, f)
    np.testing.assert_allclose(tt.two_hot(torch.as_tensor(x), cfg).numpy(),
                               np.asarray(jt.two_hot(jnp.asarray(x), cfg)), rtol=0, atol=1e-6)
    logits = rng.normal(0, 3, (16, cfg.num_bins)).astype(np.float32)
    ref_inv = np.asarray(jt.two_hot_inv(jnp.asarray(logits), cfg))
    port_inv = tt.two_hot_inv(torch.as_tensor(logits), cfg).numpy()
    np.testing.assert_allclose(port_inv, ref_inv, rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(tt.soft_ce(torch.as_tensor(logits), torch.as_tensor(x[:16]), cfg).numpy(),
                               np.asarray(jt.soft_ce(jnp.asarray(logits), jnp.asarray(x[:16]), cfg)),
                               rtol=1e-6, atol=1e-6)


# -- networks -----------------------------------------------------------------

def test_networks_match_reference(ref, port_env):
    state, cfg = ref["state"], ref["cfg"]
    tr = _port(port_env, ref, state)
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(6, ref["obs_dim"])).astype(np.float32)
    z = rng.uniform(0, 1, (6, CFG["latent_dim"])).astype(np.float32)
    a = rng.uniform(-1, 1, (6, ref["act_dim"])).astype(np.float32)
    mp = state.model_params
    jz, ja, jobs = jnp.asarray(z), jnp.asarray(a), jnp.asarray(obs)
    tz, ta, tobs = map(torch.as_tensor, (z, a, obs))
    with torch.no_grad():
        pairs = [
            ("enc", jt.Encoder(cfg).apply(mp["enc"], jobs), tr.model.enc(tobs)),
            ("dyn", jt.Dynamics(cfg).apply(mp["dyn"], jz, ja), tr.model.dyn(tz, ta)),
            ("rew", jt.RewardHead(cfg).apply(mp["rew"], jz, ja), tr.model.rew(tz, ta)),
            ("q", jt.QEnsemble(cfg).apply(mp["q"], jz, ja), tr.model.q(tz, ta)),
        ]
        (jmu, jls), (tmu, tls) = jt.PolicyPrior(cfg, 1).apply(state.pi_params, jz), tr.pi(tz)
    pairs += [("pi mu", jmu, tmu), ("pi log_std", jls, tls)]
    for what, j, t in pairs:
        close_rel(j, t.numpy(), TOL, what)


def test_params_round_trip_exactly(ref):
    state = jax.device_get(ref["state"])
    assert_trees_equal(state.model_params, tt.model_params_to_flax(tt.model_params_from_flax(state.model_params)))
    assert_trees_equal(state.pi_params, tt.pi_params_to_flax(tt.pi_params_from_flax(state.pi_params)))


# -- planner ------------------------------------------------------------------

def _plan_draws(key, cfg, iterations):
    """The reference plan's draws from ``key`` (tdmpc2.py:347-411)."""
    kpi, kiter, kfinal, knoise = jax.random.split(key, 4)
    H, N, P, E, A = cfg.horizon, cfg.num_samples, cfg.num_pi_trajs, cfg.num_elites, 1
    return dict(
        pi_eps=_t(jnp.stack([jax.random.normal(k, (B, P, A)) for k in jax.random.split(kpi, H)])),
        noise=_t(jnp.stack([jax.random.normal(jax.random.fold_in(kiter, i), (B, H, N - P, A))
                            for i in range(iterations)])),
        gumbel=_t(jax.random.gumbel(kfinal, (B, E))),
        explore=_t(jax.random.normal(knoise, (B, A))),
    )


@pytest.mark.parametrize("eval_mode", [False, True])
def test_plan_matches_reference(ref, port_env, eval_mode):
    state = _filled_state(ref, 2)
    tr = _port(port_env, ref, state)
    z = np.array(jt.Encoder(ref["cfg"]).apply(state.model_params["enc"],
                                                jnp.asarray(np.random.default_rng(3).normal(size=(B, ref["obs_dim"])),
                                                            jnp.float32)))
    t0 = np.array([True, False])
    key = jax.random.PRNGKey(4)
    ja, jmean = ref["plan"](state, jnp.asarray(z), jnp.asarray(t0), key, eval_mode=eval_mode)
    ta, tmean = tr.plan(torch.as_tensor(z), torch.as_tensor(t0), tr.prev_mean, eval_mode=eval_mode,
                        draws=_plan_draws(key, ref["cfg"], tr.iterations))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=TOL)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=0, atol=TOL)
    assert (ta.abs() <= 1).all()


# -- losses and updates -------------------------------------------------------

def _update_draws(key, state):
    """The reference update_once's draws from ``key`` (tdmpc2.py:464-549)."""
    H, b = CFG["horizon"], CFG["batch_size"]
    k1, k2, k3 = jax.random.split(key, 3)
    ka, kb, kc = jax.random.split(k1, 3)
    kpi, _ = jax.random.split(k2)
    n_ep = max(int(state.filled) // EP_LEN, 1)
    return dict(ep=_t(jax.random.randint(ka, (b,), 0, n_ep)).long(),
                off=_t(jax.random.randint(kb, (b,), 0, EP_LEN - H)).long(),
                env=_t(jax.random.randint(kc, (b,), 0, B)).long(),
                td_eps=_t(jax.random.normal(kpi, (H, b, 1))),
                pi_eps=_t(jax.random.normal(k3, (H + 1, b, 1))))


def _grads(module, to_flax):
    return to_flax({k: p.grad for k, p in module.named_parameters()})


def test_model_and_pi_losses_and_grads_match_reference(ref, port_env):
    state = _filled_state(ref, 5)
    tr = _port(port_env, ref, state)
    key = jax.random.PRNGKey(6)
    d = _update_draws(key, state)
    _, k2, k3 = jax.random.split(key, 3)
    jbatch = tuple(jnp.asarray(x.numpy()) for x in tr.sample_seq(d))
    (jtotal, jaux), jgrads = ref["model_loss"](state.model_params, state, jbatch, k2)
    total, aux = tr.model_loss(tr.sample_seq(d), d)
    total.backward()
    for what, j, t in zip(("total", "consistency", "reward", "value", "zs"), (jtotal,) + jaux, (total,) + aux):
        close_rel(j, t.detach().numpy(), TOL, what)
    for path, j, t in tree_leaves(jgrads, _grads(tr.model, tt.model_params_to_flax)):
        close_rel(j, t, TOL, f"model grad {path}")

    zs = jaux[3]
    (jpl, jqs), jpg = ref["pi_loss"](state.pi_params, state, zs, k3)
    pl, qs = tr.pi_loss(torch.as_tensor(np.array(zs)), d["pi_eps"])
    pl.backward()
    close_rel(jpl, pl.detach().numpy(), TOL, "pi loss")
    close_rel(jqs, qs.detach().numpy(), TOL, "pi qs")
    for path, j, t in tree_leaves(jpg, _grads(tr.pi, tt.pi_params_to_flax)):
        close_rel(j, t, TOL, f"pi grad {path}")


def test_two_updates_match_reference(ref, port_env):
    state = _filled_state(ref, 7)
    tr = _port(port_env, ref, state)
    for n, seed in enumerate((8, 9), 1):
        key = jax.random.PRNGKey(seed)
        d = _update_draws(key, state)
        state, jl = ref["update_once"](state, key)
        tl = tr.update_once(d)
        for what, j, t in zip(("consistency", "reward", "value", "pi", "total"), jl, tl):
            close_rel(j, t.numpy(), TOL, f"{what} loss, update {n}")
        close_rel(state.q_scale, tr.q_scale.numpy(), TOL, f"q_scale, update {n}")
        lr = tt.TDMPC2Config().lr
        assert_adam_params_close(state.model_params, tt.model_params_to_flax(tr.model.state_dict()), lr, n, "model")
        assert_adam_params_close(state.pi_params, tt.pi_params_to_flax(tr.pi.state_dict()), lr, n, "pi")
        assert_adam_params_close(state.q_target, params_to_flax(tr.q_target.state_dict(), tt.MLP_NAMES), lr, n,
                                 "q_target")


# -- whole steps --------------------------------------------------------------

def test_train_step(port_env):
    """Two warm-up collects and one learning step at CFG on the CPU."""
    obs, _ = port_env.reset(seed=0)
    tr = tt.TDMPC2Trainer(port_env, tt.TDMPC2Config(**CFG), obs.shape[-1])
    elapsed = torch.zeros(B, dtype=torch.int32)
    before = [p.detach().clone() for p in tr.pi.parameters()]
    for it in range(3):
        obs, elapsed, metrics = tr.train_step(obs, elapsed, learn=it >= 2)
    assert tr.filled == 6 and tr.ptr == 6 and elapsed.tolist() == [6, 6]
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    assert any(not torch.equal(a, b) for a, b in zip(before, tr.pi.parameters()))
    a = tr.act(obs, elapsed == 0, eval_mode=True)
    assert a.shape == (B, 1) and (a.abs() <= 1).all()


def test_cli_trains_and_saves_flax_trees(tmp_path):
    """PushCube-v1 at 2 envs with the policy prior acting: 12 warm-up
    iterations fill one episode, the 13th learns; the pickle holds the JAX
    package's model and policy trees, which load back into the port."""
    path = tmp_path / "tdmpc2.pkl"
    rate = tdmpc2_cli.main(["--env-id", "PushCube-v1", "--device", "cpu", "--num-envs", "2", "--no-mpc",
                            "--total-steps", "104", "--warmup-steps", "0", "--save-path", str(path)])
    assert 0.0 <= rate <= 1.0
    tree = load_jax_checkpoint(path)
    assert sorted(tree) == ["model", "pi"] and sorted(tree["model"]) == ["dyn", "enc", "q", "rew"]
    assert tree["model"]["q"]["params"]["Dense_0"]["kernel"].shape == (5, 512, 101)
    model = tt.WorldModel(tree["model"]["enc"]["params"]["NormedLinear_0"]["Dense_0"]["kernel"].shape[0], 8,
                          tt.TDMPC2Config())
    model.load_state_dict(tt.model_params_from_flax(tree["model"]))
    pi = tt.PolicyPrior(8, tt.TDMPC2Config())
    pi.load_state_dict(tt.pi_params_from_flax(tree["pi"]))
