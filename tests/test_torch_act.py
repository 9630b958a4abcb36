"""The port's ACT CLI (maniskill_tpu_torch/examples/baselines/act.py)
against the JAX package's, on the CPU, on the repo's PickCube demos.

The JAX CLI's ``ACT`` and its jitted ``epoch_step`` are local to its
``main``: one run at ``--epochs 0`` hands them over (``flax.linen.Module.init``
and ``jax.jit`` recorded, the init answered with the port's params carried
into flax; nothing of the JAX package changes). The JAX epoch's draws (the
permutation, z's noise) are recomputed with the same ``jax.random`` calls on
the same keys. Tolerances:
- the dataset: equal; the params through ``params_from_flax``/
  ``params_to_flax``: exact, with the paths and shapes of flax's own init;
- the training forward (z's noise given) and the inference forward (z = 0):
  1e-5 max-abs;
- one AdamW epoch (4 steps) from the same params and draws: the mean loss
  within 1e-5, the params within ``assert_adam_params_close``. The key
  projections' biases are held apart, to that helper's bound of 2 x lr per
  update alone: a bias added to every key shifts each softmax row by a
  constant, so its gradient is zero but for round-off (~1e-9 here, checked),
  and Adam (eps 1e-8) turns that round-off into steps of up to ~0.1 x lr of
  either sign, in both packages;
- the temporal-aggregation weights: equal; the ensembled action within 1e-6
  of the JAX CLI's float64 ``np.average``.
"""
import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax
from maniskill_tpu.examples.baselines import act as jact

from maniskill_tpu_torch.examples.baselines import act as tact

from test_torch_common import assert_adam_params_close, assert_trees_equal, one_torch_thread  # noqa: F401

DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demos", "PickCube-v1",
                    "mp_PickCube-v1.h5")
H, DIM, HEADS, LAYERS, LATENT, BATCH, LR, KL = 8, 32, 2, 1, 8, 250, 1e-4, 10.0
ARGV = ["--traj-path", DEMO, "--epochs", "0", "--batch-size", str(BATCH), "--dim", str(DIM), "--heads", str(HEADS),
        "--layers", str(LAYERS), "--latent-dim", str(LATENT), "--horizon", str(H), "--lr", str(LR)]
TOL = 1e-5


def _port(obs_dim, params=None, seed=1):
    model = tact.ACT(obs_dim, 8, H, DIM, HEADS, LAYERS, LATENT, seed=seed)
    if params is not None:
        model.load_state_dict(tact.params_from_flax(params, model))
    return model


@pytest.fixture(scope="module")
def ref():
    """The JAX CLI's ACT module, params of the port's init carried into
    flax, its jitted epoch_step and its training arrays."""
    cap, arrays = {}, []
    orig_jit, orig_asarray = jax.jit, jnp.asarray

    def init(self, rngs, obs, chunk, zkey):
        cap.update(module=self, params=tact.params_to_flax(_port(obs.shape[1])))
        return jax.tree_util.tree_map(orig_asarray, cap["params"])

    def jit(fn, *a, **k):
        out = orig_jit(fn, *a, **k)
        cap[fn.__name__] = out
        return out

    def asarray(x, *a, **k):
        if isinstance(x, np.ndarray):
            arrays.append(x)
        return orig_asarray(x, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Module, "init", init)
        mp.setattr(jax, "jit", jit)
        mp.setattr(jnp, "asarray", asarray)
        jact.main(ARGV)
    cap["X"], cap["Y"] = arrays[-2:]
    return cap


def test_dataset_and_params_match_the_jax_cli(ref):
    X, Y = tact.load_dataset(DEMO, H)
    for name, got, want in (("X", X, ref["X"]), ("Y", Y, ref["Y"])):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert X.shape == (1000, 51) and Y.shape == (1000, H, 8)
    model = _port(X.shape[1], ref["params"], seed=5)
    assert_trees_equal(ref["params"], tact.params_to_flax(model))
    jm = ref["module"]
    shapes = jax.eval_shape(lambda *a: jm.init(*a), jax.random.PRNGKey(0), jnp.zeros((1, X.shape[1])),
                            jnp.zeros((1, H, 8)), jax.random.PRNGKey(1))
    assert jax.tree_util.tree_map(lambda x: x.shape, shapes) == jax.tree_util.tree_map(np.shape, ref["params"])


def test_forward_matches_the_jax_act(ref):
    jm, params = ref["module"], ref["params"]
    model = _port(ref["X"].shape[1], params)
    rng = np.random.default_rng(3)
    obs = ref["X"][rng.choice(1000, 6)]
    chunk = ref["Y"][rng.choice(1000, 6)]
    zkey = jax.random.PRNGKey(4)
    want = jax.jit(lambda p, o, c, k: jm.apply(p, o, c, k))(params, obs, chunk, zkey)
    want_inf = jax.jit(lambda p, o: jm.apply(p, o))(params, obs)
    z_noise = torch.as_tensor(np.array(jax.random.normal(zkey, (6, LATENT))))
    with torch.no_grad():
        got = model(torch.as_tensor(obs), torch.as_tensor(chunk), z_noise)
        got_inf = model(torch.as_tensor(obs))
    for what, w, g in (("train", want, got), ("inference", want_inf, got_inf)):
        for name, a, b in zip(("chunk", "mu", "logvar"), w, g):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=TOL, err_msg=f"{what} {name}")
    assert float(np.abs(np.asarray(want[1])).max()) > 0.01  # the encoder's mu is live


def test_one_epoch_matches_the_jax_cli(ref):
    params, key = ref["params"], jax.random.PRNGKey(9)
    new_params, _, _, jloss = ref["epoch_step"](params, optax.adamw(LR, weight_decay=1e-4).init(params), key)
    n = ref["X"].shape[0]
    nb = n // BATCH

    def draws(key):  # act.py:152-158
        pk, key = jax.random.split(key)
        z = []
        for _ in range(nb):
            key, zkey = jax.random.split(key)
            z.append(jax.random.normal(zkey, (BATCH, LATENT)))
        return jax.random.permutation(pk, n), jnp.stack(z)

    perm, z_noise = (torch.as_tensor(np.array(x)) for x in jax.jit(draws)(key))
    model = _port(ref["X"].shape[1], params)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, eps=1e-8, weight_decay=1e-4)
    tloss = tact.epoch_step(model, opt, torch.as_tensor(ref["X"]), torch.as_tensor(ref["Y"]), KL,
                            dict(perm=perm.long(), z_noise=z_noise))
    assert abs(float(tloss) - float(jloss)) <= TOL * max(1.0, abs(float(jloss))), (float(tloss), float(jloss))
    want, got = jax.device_get(new_params), tact.params_to_flax(model)
    for side in ("enc", "dec"):
        for i in range(LAYERS):
            attn = f"{side}_{i}/MultiHeadDotProductAttention_0/key".split("/")
            jb, tb = (_pop(tree["params"], attn)["bias"] for tree in (want, got))
            assert np.abs(tb - np.asarray(jb)).max() <= 2 * LR * nb, (side, i)
            grad = model.get_submodule(f"{side}.{i}.attn.key").bias.grad  # the last minibatch's
            assert float(grad.abs().max()) < 1e-6, (side, i, float(grad.abs().max()))
    assert_adam_params_close(want, got, LR, nb, "act epoch")


def _pop(tree, path):
    for k in path[:-1]:
        tree = tree[k]
    return tree.pop(path[-1])


@pytest.mark.parametrize("t", [0, 3, 7, 20])
def test_temporal_aggregation_matches_the_jax_cli(t):
    rng = np.random.default_rng(t)
    preds = rng.normal(size=(50 + H, 3, H, 8)).astype(np.float32)
    # act.py:202-206, the JAX CLI's ensemble at step t
    acts, ws = [], []
    for i in range(min(t + 1, H)):
        acts.append(preds[t - i][:, i])
        ws.append(np.exp(-0.01 * i))
    want = np.average(np.stack(acts), axis=0, weights=ws)
    np.testing.assert_array_equal(tact.temporal_weights(t, H), np.asarray(ws))
    got = tact.temporal_ensemble(torch.as_tensor(preds), t).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


class StubEnv:
    """Obs drawn from a seeded numpy generator, every action recorded,
    success in env 0 from step 10 on."""

    def __init__(self, obs_dim, num_envs=3, seed=0):
        self.rng, self.obs_dim, self.num_envs = np.random.default_rng(seed), obs_dim, num_envs
        self.device, self.actions, self.unwrapped = torch.device("cpu"), [], self

    def _obs(self):
        return torch.as_tensor(self.rng.normal(size=(self.num_envs, self.obs_dim)).astype(np.float32))

    def reset(self, seed=None):
        return self._obs(), {}

    def step(self, action):
        self.actions.append(np.asarray(action, np.float32).copy())
        success = torch.zeros(self.num_envs, dtype=torch.bool)
        success[0] = len(self.actions) >= 10
        return self._obs(), None, None, None, dict(success=success)


def jax_cli_eval(env, infer, temporal_agg):
    """act.py:194-214's loops over ``env`` with ``infer(obs) -> chunk``."""
    obs, _ = env.reset(seed=123)
    success = np.zeros(env.num_envs, bool)
    if temporal_agg:
        preds = np.zeros((50 + H, env.num_envs, H, 8), np.float32)
        for t in range(50):
            chunk = infer(obs)
            preds[t] = chunk
            acts, ws = [], []
            for i in range(min(t + 1, H)):
                acts.append(preds[t - i][:, i])
                ws.append(np.exp(-0.01 * i))
            act = np.average(np.stack(acts), axis=0, weights=ws)
            obs, rew, term, trunc, info = env.step(act)
            success |= np.asarray(info["success"])
    else:
        for t in range(0, 50, H):
            chunk = infer(obs)
            for k in range(H):
                obs, rew, term, trunc, info = env.step(chunk[:, k])
                success |= np.asarray(info["success"])
    return success


@pytest.mark.parametrize("agg", [False, True])
def test_eval_loops_match_the_jax_cli(agg):
    """The port's eval executes the JAX CLI's actions in the same order."""
    model = _port(51, seed=2)
    want_env, got_env = StubEnv(51), StubEnv(51)
    with torch.no_grad():
        want = jax_cli_eval(want_env, lambda o: model(o)[0].numpy(), agg)
    got = tact.evaluate(got_env, model, agg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(got_env.actions) == len(want_env.actions) == (50 if agg else 56)
    np.testing.assert_allclose(np.stack(got_env.actions), np.stack(want_env.actions), rtol=0, atol=1e-6)


def test_cli_trains_and_evaluates_on_the_cpu(capsys):
    out = tact.main(["--traj-path", DEMO, "--env-id", "PickCube-v1", "--device", "cpu", "--epochs", "1",
                     "--dim", "16", "--heads", "2", "--layers", "1", "--batch-size", "500", "--eval-episodes", "2",
                     "--temporal-agg"])
    printed = capsys.readouterr().out
    assert "dataset: 1000 samples, obs 51, chunk 8x8" in printed and "eval success_once" in printed
    assert np.isfinite(out["loss"][0]) and 0.0 <= out["eval_success"] <= 1.0
