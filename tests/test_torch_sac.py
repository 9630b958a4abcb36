"""The port's SAC (maniskill_tpu_torch/parallel/sac.py) against the JAX
package's (maniskill_tpu/parallel/sac.py), on the CPU, on
MS-CartpoleBalance-v1 at 4 envs.

The two RNGs draw different numbers, so every JAX draw is recomputed here
with the same ``jax.random`` calls on the same keys and fed to the port
(``update_once(draws)``, ``sample_action(eps)``). The JAX inner functions are
closures of ``train_step``. Tolerances:
- Actor and twin-Q outputs from carried params, and ``sample_action``, at
  1e-5; the params round-trip exactly.
- Two ``update_once`` calls, without and with ``demos=`` (RLPD's 50/50
  batch): the Q and actor losses and every gradient (Q, actor, log alpha)
  at 1e-4 relative to the largest magnitude. The squash's log(1 - tanh(u)^2
  + 1e-6) turns the 1-ulp apart tanh of XLA and torch into up to ~10%
  of a saturated sample's log-prob (1 - tanh^2 near 1e-6); over the batch
  that leaves up to 2.3e-5 relative in the actor's gradients and the
  second update's losses (measured). ``log_alpha`` at 1e-6; the
  params and the EMA target within 2 x lr per update of the reference (an
  Adam step moves each entry by about lr x sign(g), so an entry whose
  gradient the packages round to opposite signs parts by up to 2 x lr) and
  within 1e-5 on at least 0.999 of the entries (measured: every entry
  within 2.1e-7 after two updates).
- One whole ``train_step`` on the CPU, as tests/test_sac.py runs the JAX
  one, and the CLI at ``--device cpu`` with a tiny budget.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.parallel import sac as js
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.examples.baselines import sac as sac_cli
from maniskill_tpu_torch.parallel import sac as ts
from maniskill_tpu_torch.parallel.train import load_jax_checkpoint

from test_torch_common import (  # noqa: F401
    assert_adam_params_close, assert_trees_equal, close_rel, closures, one_torch_thread, tree_leaves,
)

B = 4
CFG = dict(rollout_steps=2, buffer_steps=8, batch_size=32, utd=1)
N_DEMO = 20
TOL = 1e-5
LOSS_TOL = 1e-4  # losses and gradients of an update (see the docstring)


def _demos(seed, obs_dim):
    rng = np.random.default_rng(seed)
    return dict(obs=rng.normal(size=(N_DEMO, obs_dim)).astype(np.float32),
                act=rng.uniform(-1, 1, (N_DEMO, 1)).astype(np.float32),
                rew=rng.uniform(0, 1, N_DEMO).astype(np.float32),
                next_obs=rng.normal(size=(N_DEMO, obs_dim)).astype(np.float32),
                term=rng.uniform(size=N_DEMO) < 0.3)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's SAC at CFG, plain and with demos: its modules,
    initial state and inner functions (jitted)."""
    env = jmake("MS-CartpoleBalance-v1", num_envs=B, obs_mode="state")
    obs, _ = env.reset(seed=0)
    obs_dim = obs.shape[-1]
    demos = _demos(0, obs_dim)
    out = dict(obs_dim=obs_dim, demo_data=demos)
    for branch, d in (("plain", None), ("demos", {k: jnp.asarray(v) for k, v in demos.items()})):
        actor, qnet, init_state, train_step = js.make_sac_step(env, js.SACConfig(**CFG), demos=d)
        update_once = closures(train_step)["update_once"]
        inner = closures(update_once)
        out[branch] = dict(
            update_once=jax.jit(update_once),
            q_grad=jax.jit(jax.value_and_grad(inner["q_loss"])),
            actor_grad=jax.jit(jax.value_and_grad(inner["actor_loss"], has_aux=True)),
            alpha_grad=jax.jit(jax.value_and_grad(inner["alpha_loss"])),
        )
    out.update(actor=actor, qnet=qnet, state=init_state(jax.random.PRNGKey(0), obs_dim))
    return out


@pytest.fixture(scope="module")
def port_env():
    return tmake("MS-CartpoleBalance-v1", num_envs=B, obs_mode="state", device="cpu")


def _port(port_env, ref, state, demos=None):
    """A port trainer holding the JAX state's params, target, temperature
    and ring."""
    tr = ts.SACTrainer(port_env, ts.SACConfig(**CFG), ref["obs_dim"], demos=demos)
    state = jax.device_get(state)
    tr.actor.load_state_dict(ts.actor_params_from_flax(state.actor_params))
    tr.qnet.load_state_dict(ts.q_params_from_flax(state.q_params))
    tr.q_target.load_state_dict(ts.q_params_from_flax(state.q_target))
    with torch.no_grad():
        tr.log_alpha.copy_(torch.as_tensor(np.array(state.log_alpha)))
    for k in ("buf_obs", "buf_act", "buf_rew", "buf_next_obs", "buf_term"):
        setattr(tr, k, torch.as_tensor(np.array(getattr(state, k))))
    tr.ptr, tr.filled = int(state.ptr), int(state.filled)
    return tr


def _filled_state(ref, seed):
    rng = np.random.default_rng(seed)
    S, D = CFG["buffer_steps"], ref["obs_dim"]
    return ref["state"]._replace(
        buf_obs=jnp.asarray(rng.normal(size=(S, B, D)).astype(np.float32)),
        buf_act=jnp.asarray(rng.uniform(-1, 1, (S, B, 1)).astype(np.float32)),
        buf_rew=jnp.asarray(rng.uniform(0, 1, (S, B)).astype(np.float32)),
        buf_next_obs=jnp.asarray(rng.normal(size=(S, B, D)).astype(np.float32)),
        buf_term=jnp.asarray(rng.uniform(size=(S, B)) < 0.2),
        filled=jnp.int32(S))


def _t(x):
    return torch.as_tensor(np.array(x))


def test_networks_and_sample_action_match_reference(ref, port_env):
    state = ref["state"]
    tr = _port(port_env, ref, state)
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(16, ref["obs_dim"])).astype(np.float32)
    act = rng.uniform(-1, 1, (16, 1)).astype(np.float32)
    jm, jls = ref["actor"].apply(state.actor_params, jnp.asarray(obs))
    jq1, jq2 = ref["qnet"].apply(state.q_params, jnp.asarray(obs), jnp.asarray(act))
    key = jax.random.PRNGKey(2)
    ja, jlogp = js._sample_action(ref["actor"], state.actor_params, jnp.asarray(obs), key)
    with torch.no_grad():
        tm, tls = tr.actor(torch.as_tensor(obs))
        tq1, tq2 = tr.qnet(torch.as_tensor(obs), torch.as_tensor(act))
        ta, tlogp = ts.sample_action(tr.actor, torch.as_tensor(obs), _t(jax.random.normal(key, (16, 1))))
    for what, j, t in (("mean", jm, tm), ("log_std", jls, tls), ("q1", jq1, tq1), ("q2", jq2, tq2),
                       ("action", ja, ta), ("logp", jlogp, tlogp)):
        close_rel(j, t.numpy(), TOL, what)


def test_params_round_trip_exactly(ref):
    state = jax.device_get(ref["state"])
    assert_trees_equal(state.actor_params, ts.actor_params_to_flax(ts.actor_params_from_flax(state.actor_params)))
    assert_trees_equal(state.q_params, ts.q_params_to_flax(ts.q_params_from_flax(state.q_params)))


def _update_draws(key, state, with_demos):
    """The reference update_once's draws from ``key`` (sac.py:198-233)."""
    bs = CFG["batch_size"]
    online = bs // 2 if with_demos else bs
    k1, k2, k3, _ = jax.random.split(key, 4)
    d = dict(idx=_t(jax.random.randint(k1, (online,), 0, int(state.filled) * B)).long(),
             eps_q=_t(jax.random.normal(k2, (bs, 1))), eps_pi=_t(jax.random.normal(k3, (bs, 1))))
    if with_demos:
        dk, _ = jax.random.split(k1)
        d["demo_idx"] = _t(jax.random.randint(dk, (bs - online,), 0, N_DEMO)).long()
    return d, k2, k3


@pytest.mark.parametrize("branch", ["plain", "demos"])
def test_two_updates_match_reference(ref, port_env, branch):
    fns = ref[branch]
    state = _filled_state(ref, 3)
    demos = {k: torch.as_tensor(v) for k, v in ref["demo_data"].items()} if branch == "demos" else None
    tr = _port(port_env, ref, state, demos)
    for n, seed in enumerate((4, 5), 1):
        key = jax.random.PRNGKey(seed)
        draws, k2, k3 = _update_draws(key, state, demos is not None)
        batch = tuple(jnp.asarray(x.numpy()) for x in tr.batch(draws))
        # the reference's gradients in its order: Q, then the actor on the
        # new Q, then the temperature on the actor's log-probs
        _, qg = fns["q_grad"](state.q_params, state, batch, k2)
        new_state, (jql, jal) = fns["update_once"](state, key)
        (_, logp), ag = fns["actor_grad"](state.actor_params, state._replace(q_params=new_state.q_params),
                                          batch[0], k3)
        _, eg = fns["alpha_grad"](state.log_alpha, logp)
        state = new_state

        tql, tal = tr.update_once(draws)
        close_rel(jql, tql.numpy(), LOSS_TOL, f"q loss {n}")
        close_rel(jal, tal.numpy(), LOSS_TOL, f"actor loss {n}")
        for what, jg, module, to_flax in (("q", qg, tr.qnet, ts.q_params_to_flax),
                                          ("actor", ag, tr.actor, ts.actor_params_to_flax)):
            tg = to_flax({k: p.grad for k, p in module.named_parameters()})
            for path, j, t in tree_leaves(jg, tg):
                close_rel(j, t, LOSS_TOL, f"{what} grad {path}, update {n}")
        close_rel(eg, tr.log_alpha.grad.numpy(), LOSS_TOL, f"log_alpha grad {n}")
        np.testing.assert_allclose(tr.log_alpha.detach().numpy(), np.asarray(state.log_alpha), rtol=0, atol=1e-6)
        lr = js.SACConfig().lr
        assert_adam_params_close(state.q_params, ts.q_params_to_flax(tr.qnet.state_dict()), lr, n, "q")
        assert_adam_params_close(state.actor_params, ts.actor_params_to_flax(tr.actor.state_dict()), lr, n, "actor")
        assert_adam_params_close(state.q_target, ts.q_params_to_flax(tr.q_target.state_dict()), lr, n, "q_target")


def test_train_step(port_env):
    """Two warm-up collects and two learning steps at CFG (rollout 2, ring
    8), as tests/test_sac.py runs the reference."""
    obs, _ = port_env.reset(seed=0)
    tr = ts.SACTrainer(port_env, ts.SACConfig(**CFG), obs.shape[-1])
    elapsed = torch.zeros(B, dtype=torch.int32)
    before = [p.detach().clone() for p in tr.actor.parameters()]
    for it in range(4):
        obs, elapsed, metrics = tr.train_step(obs, elapsed, learn=it >= 2)
    assert tr.filled == 8 and tr.ptr == 0
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    assert all(torch.isfinite(p).all() for p in tr.actor.parameters())
    assert any(not torch.equal(a, b) for a, b in zip(before, tr.actor.parameters()))


def test_cli_trains_and_saves_a_flax_tree(tmp_path, capsys):
    """PushCube-v1 at 4 envs: 2 warm-up and 2 learning iterations, the
    actor saved as the JAX package's flax tree, and the 60-step greedy
    eval."""
    path = tmp_path / "sac.pkl"
    rate = sac_cli.main(["--env-id", "PushCube-v1", "--device", "cpu", "--num-envs", "4", "--rollout-steps", "2",
                         "--buffer-steps", "8", "--total-steps", "32", "--batch-size", "32", "--utd", "1",
                         "--warmup-steps", "2", "--save-path", str(path)])
    assert 0.0 <= rate <= 1.0 and "final eval success(any)" in capsys.readouterr().out
    tree = load_jax_checkpoint(path)
    assert sorted(tree["params"]) == ["Dense_0", "Dense_1", "Dense_2", "Dense_3"]
    obs_dim = tree["params"]["Dense_0"]["kernel"].shape[0]
    mean, log_std = js.TanhGaussianActor(8).apply(tree, jnp.zeros((1, obs_dim)))
    assert mean.shape == (1, 8) and np.isfinite(np.asarray(log_std)).all()
    actor = ts.TanhGaussianActor(obs_dim, 8)
    actor.load_state_dict(ts.actor_params_from_flax(tree))
