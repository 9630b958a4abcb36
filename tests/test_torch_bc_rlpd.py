"""The port's BC and RLPD baselines against the JAX package's, on the CPU.

- BC's dataset (obs_t, action_t) from a repo demo equals the JAX CLI's, and
  one epoch from the same flax-initialized params over the same permutation
  (the JAX CLI's ``epoch_step``: Adam at optax's defaults on the MSE) leaves
  params within the SAC tests' Adam tolerance of the JAX epoch's
  (``assert_adam_params_close``) and the same mean loss.
- ``load_demo_transitions`` equals the JAX package's on a repo demo,
  ``term[-1]`` of every episode included.
- Each CLI runs a tiny budget with ``--device cpu``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import flax.linen as nn
import optax
from maniskill_tpu.examples.baselines import bc as jbc
from maniskill_tpu.examples.baselines import rlpd as jrlpd
from maniskill_tpu.trajectory.dataset import ManiSkillTrajectoryDataset as JDataset

from maniskill_tpu_torch.examples.baselines import bc as tbc
from maniskill_tpu_torch.examples.baselines import rlpd as trlpd
from maniskill_tpu_torch.parallel.train import params_from_flax, params_to_flax

from test_torch_common import assert_adam_params_close, one_torch_thread  # noqa: F401

DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demos", "PickCube-v1",
                    "mp_PickCube-v1.h5")
HIDDEN, BATCH, LR = 64, 256, 3e-4


def jax_dataset(path):
    """The JAX BC CLI's (X, Y) (bc.py:main, its dataset loop)."""
    ds = JDataset(path)
    X, Y = [], []
    for ep in range(len(ds.actions)):
        acts = np.asarray(ds.actions[ep], np.float32)
        obs = jbc._flatten_obs(ds.obs[ep], 1)
        X.append(obs[:len(acts)])
        Y.append(acts)
    ds.close()
    return np.concatenate(X, 0), np.concatenate(Y, 0)


def jax_epoch(params, X, Y, perm):
    """The JAX BC CLI's jitted ``epoch_step`` on the given permutation."""
    class Policy(nn.Module):
        @nn.compact
        def __call__(self, x):
            for _ in range(3):
                x = nn.relu(nn.Dense(HIDDEN)(x))
            return nn.Dense(Y.shape[1])(x)

    model, tx = Policy(), optax.adam(LR)
    Xd, Yd = jnp.asarray(X), jnp.asarray(Y)
    n = X.shape[0]
    bs = min(BATCH, n)
    nb = max(1, n // bs)

    @jax.jit
    def epoch_step(params, opt_state, perm):
        def mb(carry, i):
            params, opt_state = carry
            idx = jax.lax.dynamic_slice_in_dim(perm, i * bs, bs)
            x, y = Xd[idx], Yd[idx]
            loss, g = jax.value_and_grad(lambda p: jnp.mean((model.apply(p, x) - y) ** 2))(params)
            up, opt_state = tx.update(g, opt_state)
            return (optax.apply_updates(params, up), opt_state), loss

        (params, opt_state), losses = jax.lax.scan(mb, (params, opt_state), jnp.arange(nb))
        return params, jnp.mean(losses)

    if params is None:
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, X.shape[1])))
        return params, nb
    out, loss = epoch_step(params, tx.init(params), jnp.asarray(perm))
    return jax.device_get(out), float(loss)


def test_bc_dataset_and_epoch_match_the_jax_package():
    X, Y, meta = tbc.load_dataset(DEMO)
    jX, jY = jax_dataset(DEMO)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(Y, jY)
    assert meta["env_info"]["env_id"] == "PickCube-v1"

    params, n_updates = jax_epoch(None, X, Y, None)
    params = jax.device_get(params)
    perm = np.random.default_rng(0).permutation(X.shape[0])
    jparams, jloss = jax_epoch(params, X, Y, perm)

    policy = tbc.Policy(X.shape[1], Y.shape[1], HIDDEN)
    policy.load_state_dict(params_from_flax(params, tbc.FLAX_NAMES))
    opt = torch.optim.Adam(policy.parameters(), lr=LR, eps=1e-8)
    tloss = tbc.epoch_step(policy, opt, torch.as_tensor(X), torch.as_tensor(Y), BATCH, torch.as_tensor(perm))
    assert abs(float(tloss) - jloss) <= 1e-5 * max(1.0, abs(jloss)), (float(tloss), jloss)
    tparams = params_to_flax(policy.state_dict(), tbc.FLAX_NAMES)
    assert_adam_params_close(jparams, tparams, LR, n_updates, "bc epoch")


def test_load_demo_transitions_matches_the_jax_package():
    want, got = jrlpd.load_demo_transitions(DEMO), trlpd.load_demo_transitions(DEMO)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["term"].sum()) == 24  # one terminal row per episode


def test_bc_cli_runs_on_the_cpu(tmp_path, capsys):
    out = tbc.main(["--traj-path", DEMO, "--epochs", "2", "--batch-size", "256", "--hidden", "32",
                    "--num-eval-envs", "2", "--eval-steps", "2", "--device", "cpu",
                    "--save-path", str(tmp_path / "bc.pt")])
    assert len(out["mse"]) == 2 and all(np.isfinite(out["mse"])) and out["eval_success"] is not None
    state = torch.load(tmp_path / "bc.pt")
    assert tuple(state["net.6.weight"].shape) == (8, 32)
    assert "dataset: 1000 transitions" in capsys.readouterr().out


def test_rlpd_cli_runs_on_the_cpu(tmp_path, capsys):
    out = trlpd.main(["--env-id", "PickCube-v1", "--traj-path", DEMO, "--device", "cpu", "--num-envs", "2",
                      "--total-steps", "24", "--batch-size", "16", "--buffer-steps", "8",
                      "--warmup-steps", "1", "--save-path", str(tmp_path / "rlpd.pkl")])
    printed = capsys.readouterr().out
    assert "control mode: demos pd_joint_pos, env pd_joint_delta_pos (they differ" in printed
    assert out["trainer"].filled == 8 and all(np.isfinite(list(out["metrics"].values())))
    assert (tmp_path / "rlpd.pkl").exists()
