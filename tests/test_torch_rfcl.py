"""The port's RFCL (maniskill_tpu_torch/parallel/rfcl.py and its CLI) against
the JAX package's (maniskill_tpu/parallel/rfcl.py), on the CPU.

- ``load_demo_states`` on the repo's PickCube demos: every state leaf, the
  lengths and the flat transitions bit-equal to the JAX loader's.
  Without an explicit ``device`` it loads onto the card, as every entry
  point does: without one it raises rather than load onto the CPU.
- The start-state gather (the JAX ``_gather_start_states``, a closure of its
  collect) equal for random pointers.
- Whole train steps, a warm-up one and two learning ones (the second in the
  forward phase, demo and standard resets mixed), from the same state
  and the same draws (recomputed with the JAX step's ``jax.random`` calls on
  the same keys). The env is a small deterministic stand-in with the same
  arithmetic in both packages (a state x moved by the action, episodes that
  end by the step count; curriculum resets copy the demo's cube state into
  x, standard resets zero it), so its episode ends are exact and the
  curriculum's tallies equal: the JAX package's ``test_rfcl.py`` compiles
  its train step over a PushCube env for minutes on the CPU, too long for
  this suite. The tallies' bookkeeping (k, the success EMA, the advance,
  the episode count) and the episode ends are exactly equal; obs and the
  ring within 1e-5; the other metrics within 1e-5 relative; the first
  learning step's losses (two updates from the same params) at 1e-4
  relative, as tests/test_torch_sac.py holds an update's (the squash's
  log(1 - tanh^2 + 1e-6) turns 1-ulp apart tanh values into up to ~10% of a
  saturated sample's log-prob; measured here: 5.0e-5 on the mean Q loss).
  After those updates an entry whose gradient the packages round to
  opposite signs has parted by up to 2 x lr (measured: 1 of ~70,000 actor
  entries, 5.9e-4), which moves the next step's actor loss by ~1e-3, so the
  last step is held by its params: within ``assert_adam_params_close`` and
  ``log_alpha`` within 1e-6, as that file holds SAC.
- A curriculum reset in the port's PickCube env at 2 envs restores the
  demo's cube, robot and goal within 1e-5 and leaves the other env as it was.
- The CLI at ``--device cpu`` with a tiny budget saves the JAX CLI's flax
  tree.
"""
import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from maniskill_tpu.parallel import rfcl as jr
from maniskill_tpu.parallel import sac as js

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.examples.baselines import rfcl as rfcl_cli
from maniskill_tpu_torch.parallel import rfcl as tr
from maniskill_tpu_torch.parallel import sac as ts

from test_torch_common import assert_adam_params_close, close_rel, closures, one_torch_thread  # noqa: F401

DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demos", "PickCube-v1",
                    "mp_PickCube-v1.h5")
B, A, S = 6, 4, 13  # envs, action width, the stand-in's state (the cube's 13)
NUM_DEMOS = 5
MAX_STEPS = 3
# an episode succeeds at this step, else is truncated at MAX_STEPS: every
# demo's first env succeeds, so all reach their first state by the second
# collect and the third runs the forward phase
TERM_AT = np.array([2, 3, 2, 3, 2, 9])
CFG = dict(rollout_steps=2, buffer_steps=4, batch_size=16, utd=2)
RFCL = dict(reverse_step_size=50, success_threshold=0.3)
N_DEMO_TRANS = 20
TOL = 1e-5
LOSS_TOL = 1e-4  # an update's losses (see the docstring)


class JaxStandIn:
    """The stand-in env for the JAX package's ``make_rfcl_step``."""

    def __init__(self):
        self.unwrapped, self.num_envs, self.max_episode_steps = self, B, MAX_STEPS
        self.single_action_space = SimpleNamespace(shape=(A,))

    @staticmethod
    def obs(x, n):
        return jnp.concatenate([x, n[:, None].astype(jnp.float32) / 10], -1)

    def _step_impl(self, data, action):
        x = data["x"] + 0.05 * jnp.concatenate([action, jnp.zeros((B, S - A))], -1)
        n = data["n"] + 1
        return dict(x=x, n=n), self.obs(x, n), x[:, 0] + 0.5 * x[:, 1], n >= jnp.asarray(TERM_AT), {}

    def _reset_impl(self, data, mask, keys, states):
        new = states["actors"]["cube"] if states is not None else jnp.zeros((B, S))
        x = jnp.where(mask[:, None], new, data["x"])
        n = jnp.where(mask, 0, data["n"])
        return dict(x=x, n=n), self.obs(x, n), {}


class PortStandIn:
    """The same env on torch tensors for ``RFCLTrainer``."""

    def __init__(self):
        self.unwrapped, self.num_envs, self.max_episode_steps = self, B, MAX_STEPS
        self.single_action_space = SimpleNamespace(shape=(A,))
        self.device = torch.device("cpu")
        self.x, self.n = torch.zeros(B, S), torch.zeros(B, dtype=torch.int32)

    def obs(self):
        return torch.cat([self.x, self.n[:, None].to(torch.float32) / 10], -1)

    def _step_impl(self, action):
        self.x = self.x + 0.05 * torch.cat([action, torch.zeros(B, S - A)], -1)
        self.n = self.n + 1
        return self.obs(), self.x[:, 0] + 0.5 * self.x[:, 1], self.n >= torch.as_tensor(TERM_AT), {}

    def _reset_impl(self, mask, seeds, reset_state=None):
        new = reset_state["actors"]["cube"] if reset_state is not None else torch.zeros(B, S)
        self.x = torch.where(mask[:, None], new, self.x)
        self.n = torch.where(mask, 0, self.n)
        return self.obs(), {}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def demo_states():
    return jr.load_demo_states(DEMO, NUM_DEMOS), tr.load_demo_states(DEMO, NUM_DEMOS, device="cpu")


def test_load_demo_states_is_bit_equal(demo_states):
    (jstates, jlens, jdemos), (tstates, tlens, tdemos) = demo_states
    want, got = dict(_leaves(jstates)), dict(_leaves(tstates))
    assert want.keys() == got.keys() and "controller/arm/target_qpos" in got
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert w.dtype == g.dtype and w.shape == g.shape == (NUM_DEMOS, 42) + w.shape[2:], k
        np.testing.assert_array_equal(g, w, err_msg=k)
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    assert tlens.dtype == torch.int32
    for k in jdemos:
        w, g = np.asarray(jdemos[k]), tdemos[k].numpy()
        assert w.dtype == g.dtype and w.shape == g.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    # every demo on its own is bit-equal too (the whole file: 24 demos)
    jall, tall = jr.load_demo_states(DEMO)[0], tr.load_demo_states(DEMO, device="cpu")[0]
    np.testing.assert_array_equal(tall["actors"]["cube"].numpy(), np.asarray(jall["actors"]["cube"]))


def test_load_demo_states_defaults_to_the_card():
    if torch.cuda.is_available():
        _, lens, _ = tr.load_demo_states(DEMO, 1)
        assert lens.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tr.load_demo_states(DEMO, 1)


def _demo_mix(seed):
    rng = np.random.default_rng(seed)
    n = N_DEMO_TRANS
    return dict(obs=rng.normal(size=(n, S + 1)).astype(np.float32), act=rng.uniform(-1, 1, (n, A)).astype(np.float32),
                rew=rng.uniform(0, 1, n).astype(np.float32), next_obs=rng.normal(size=(n, S + 1)).astype(np.float32),
                term=rng.uniform(size=n) < 0.3)


@pytest.fixture(scope="module")
def ref(demo_states):
    """The JAX package's RFCL over the stand-in: its init state and its
    jitted train step and collect closure."""
    jstates, jlens, _ = demo_states[0]
    demos = {k: jnp.asarray(v) for k, v in _demo_mix(0).items()}
    cfg = jr.RFCLConfig(sac=js.SACConfig(**CFG), **RFCL)
    actor, init_state, train_step = jr.make_rfcl_step(JaxStandIn(), jstates, jlens, cfg, demos=demos)
    return dict(state=init_state(jax.random.PRNGKey(0), S + 1), train_step=jax.jit(train_step),
                gather=closures(closures(train_step)["collect"])["_gather_start_states"], cfg=cfg)


def test_start_state_gather_is_equal(demo_states, ref):
    tstates, tlens, _ = demo_states[1]
    env_demo = torch.arange(B) % NUM_DEMOS
    for seed in range(3):
        k = np.random.default_rng(seed).integers(0, 60, NUM_DEMOS).astype(np.int32)  # past T - 1 clamps to 0
        want = dict(_leaves(jax.jit(ref["gather"])(jnp.asarray(k))))
        got = dict(_leaves(tr.gather_start_states(tstates, tlens, env_demo, torch.as_tensor(k))))
        assert want.keys() == got.keys()
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def _draws(key, filled_after, learn_updates):
    """The JAX train step's draws from ``key`` (rfcl.py:196-269, 321):
    per control step the action's normal and the demo-start uniform; per
    update the replay and demo indices and the two normals."""
    R, bs = CFG["rollout_steps"], CFG["batch_size"]
    key, ckey, ukey = jax.random.split(key, 3)
    eps, u = [], []
    for _ in range(R):
        ckey, akey, _, _, dkey = jax.random.split(ckey, 5)
        eps.append(jax.random.normal(akey, (B, A)))
        u.append(jax.random.uniform(dkey, (B,)))
    t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    collect = dict(eps=t(jnp.stack(eps)), u=t(jnp.stack(u)), seeds=torch.zeros(R, B, dtype=torch.int64))
    updates = []
    for k in jax.random.split(ukey, CFG["utd"]) if learn_updates else []:
        k1, k2, k3 = jax.random.split(k, 3)
        dk, _ = jax.random.split(k1)
        updates.append(dict(idx=t(jax.random.randint(k1, (bs // 2,), 0, filled_after * B)).long(),
                            demo_idx=t(jax.random.randint(dk, (bs - bs // 2,), 0, N_DEMO_TRANS)).long(),
                            eps_q=t(jax.random.normal(k2, (bs, A))), eps_pi=t(jax.random.normal(k3, (bs, A)))))
    return dict(collect=collect, updates=updates)


def test_train_steps_match_the_jax_package(demo_states, ref):
    tstates, tlens, _ = demo_states[1]
    env = PortStandIn()
    demos = {k: torch.as_tensor(v) for k, v in _demo_mix(0).items()}
    trainer = tr.RFCLTrainer(env, tstates, tlens, tr.RFCLConfig(sac=ts.SACConfig(**CFG), **RFCL), S + 1,
                             demos=demos)
    state = jax.device_get(ref["state"])
    trainer.actor.load_state_dict(ts.actor_params_from_flax(state.sac.actor_params))
    trainer.qnet.load_state_dict(ts.q_params_from_flax(state.sac.q_params))
    trainer.q_target.load_state_dict(ts.q_params_from_flax(state.sac.q_target))

    data = dict(x=jnp.zeros((B, S)), n=jnp.zeros(B, jnp.int32))
    jobs, tobs = JaxStandIn.obs(data["x"], data["n"]), env.obs()
    jel, tel = jnp.zeros(B, jnp.int32), torch.zeros(B, dtype=torch.int32)
    key = jax.random.PRNGKey(1)
    lr = ref["cfg"].sac.lr
    reverse_done = []
    for it, learn in enumerate((False, True, True)):
        draws = _draws(key, min((it + 1) * CFG["rollout_steps"], CFG["buffer_steps"]), learn)
        state, data, jobs, jel, key, jm = ref["train_step"](state, data, jobs, jel, key, jnp.asarray(learn))
        tobs, tel, tm = trainer.train_step(tobs, tel, learn, draws)
        # the curriculum: exact
        np.testing.assert_array_equal(trainer.k.numpy(), np.asarray(state.k), err_msg=f"k, step {it}")
        np.testing.assert_array_equal(trainer.succ_ema.numpy(), np.asarray(state.succ_ema), err_msg=f"ema {it}")
        assert int(trainer.episodes) == int(state.episodes)
        np.testing.assert_array_equal(tel.numpy(), np.asarray(jel))
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=0, atol=TOL)
        for name in ("buf_obs", "buf_act", "buf_rew", "buf_next_obs", "buf_term"):
            np.testing.assert_allclose(_np(getattr(trainer, name)).astype(np.float32),
                                       np.asarray(getattr(state.sac, name), np.float32), rtol=0, atol=TOL,
                                       err_msg=f"{name}, step {it}")
        for m in ("alpha", "mean_k", "reverse_done", "mean_succ_ema") + (("q_loss", "actor_loss") if it < 2 else ()):
            close_rel(jm[m], tm[m].detach().numpy(), LOSS_TOL if m.endswith("loss") else TOL, f"{m}, step {it}")
        reverse_done.append(float(tm["reverse_done"]))
    assert reverse_done == [0.0, 1.0, 1.0]  # the third collect ran the forward phase
    sac = jax.device_get(state.sac)
    n = 2 * CFG["utd"]
    assert_adam_params_close(sac.q_params, ts.q_params_to_flax(trainer.qnet.state_dict()), lr, n, "q")
    assert_adam_params_close(sac.actor_params, ts.actor_params_to_flax(trainer.actor.state_dict()), lr, n, "actor")
    assert_adam_params_close(sac.q_target, ts.q_params_to_flax(trainer.q_target.state_dict()), lr, n, "q_target")
    np.testing.assert_allclose(trainer.log_alpha.detach().numpy(), np.asarray(sac.log_alpha), rtol=0, atol=1e-6)


def test_curriculum_advance_is_exact():
    """advance_curriculum against rfcl.py:343-355 on random tallies."""
    rng = np.random.default_rng(4)
    cfg = tr.RFCLConfig()
    lens = rng.integers(5, 50, 16).astype(np.int32)
    k = rng.integers(1, 50, 16).astype(np.int32)
    ema = rng.uniform(0, 1, 16).astype(np.float32)
    cnt = rng.integers(0, 4, 16).astype(np.float32)
    succ = np.minimum(rng.integers(0, 4, 16), cnt).astype(np.float32)

    @jax.jit
    def reference(k, succ_ema, ep_cnt, ep_succ, demo_lens):
        rate = ep_succ / jnp.maximum(ep_cnt, 1)
        ema = jnp.where(ep_cnt > 0, (1 - cfg.ema) * succ_ema + cfg.ema * rate, succ_ema)
        advance = ema > cfg.success_threshold
        k = jnp.where(advance, jnp.minimum(k + cfg.reverse_step_size, demo_lens - 1), k)
        return k, jnp.where(advance, 0.0, ema)

    wk, we = reference(k, ema, cnt, succ, lens)
    gk, ge = tr.advance_curriculum(*(torch.as_tensor(x) for x in (k, ema, cnt, succ, lens)), cfg)
    assert bool((np.asarray(wk) != k).any()) and gk.dtype == torch.int32
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))


@pytest.fixture(scope="module")
def pick_env():
    return tmake("PickCube-v1", num_envs=2, obs_mode="state", device="cpu")


def test_curriculum_reset_restores_a_demo_state(demo_states, pick_env):
    """The collect's masked reset: env 0 to its demo's state one from the
    end (k = 1), env 1 untouched."""
    tstates, tlens, _ = demo_states[1]
    base = pick_env.unwrapped
    pick_env.reset(seed=3)
    before = base.get_state_dict()
    env_demo = torch.arange(2) % NUM_DEMOS
    start = tr.gather_start_states(tstates, tlens, env_demo, torch.ones(NUM_DEMOS, dtype=torch.int32))
    base._reset_impl(torch.tensor([True, False]), torch.zeros(2, dtype=torch.int64), start)
    after = base.get_state_dict()
    idx = int(tlens[0]) - 2
    for group, name in (("actors", "cube"), ("actors", "goal_site"), ("articulations", "panda")):
        want = tstates[group][name][0, idx]
        np.testing.assert_allclose(after[group][name][0].numpy(), want.numpy(), rtol=0, atol=1e-5,
                                   err_msg=f"{group}/{name}")
        np.testing.assert_array_equal(after[group][name][1].numpy(), before[group][name][1].numpy())


def test_cli_trains_and_saves_a_flax_tree(tmp_path, capsys):
    path = tmp_path / "rfcl.pkl"
    out = rfcl_cli.main(["--env-id", "PickCube-v1", "--demos", DEMO, "--num-demos", "2", "--device", "cpu",
                         "--num-envs", "2", "--rollout-steps", "2", "--buffer-steps", "4", "--total-steps", "8",
                         "--batch-size", "16", "--utd", "1", "--warmup-steps", "1", "--save-path", str(path)])
    printed = capsys.readouterr().out
    assert "loaded 2 demos, lengths [42, 42]" in printed and "final eval success(any)" in printed
    assert out["trainer"].filled == 4 and all(np.isfinite(list(out["metrics"].values())))
    with open(path, "rb") as f:
        tree = pickle.load(f)
    assert sorted(tree["params"]) == ["Dense_0", "Dense_1", "Dense_2", "Dense_3"]
    assert tree["params"]["Dense_0"]["kernel"].shape == (51, 256)
