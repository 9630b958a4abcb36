"""The port's Diffusion Policy CLI
(maniskill_tpu_torch/examples/baselines/diffusion_policy.py) against the JAX
package's, on the CPU.

The JAX CLI's flax modules and jitted functions are local to its ``main``,
so one run of it at ``--epochs 0`` on a small file (a state vector and a
32x32 uint8 frame per step, written with the port's h5 writer) hands them
over: ``flax.linen.Module.init`` records the ``Denoiser`` and its params,
``jax.jit`` records ``epoch_step`` and ``sample_chunk``, and
``jnp.asarray`` the training arrays. Nothing of the JAX package changes. The
two RNGs draw different numbers, so the JAX functions' draws are recomputed
with the same ``jax.random`` calls on the same keys and given to the port.
Tolerances:
- the dataset (windows, chunks, frames, the action range): equal;
- the params through ``params_from_flax``/``params_to_flax``: exact;
- the denoiser's forward pass (unet and mlp, with and without frames):
  1e-5 max-abs;
- one epoch (3 Adam steps) from the same params and draws: the mean loss
  within 1e-5 and the params within ``assert_adam_params_close``;
- the DDPM chain from the same x_T and per-step noise: 1e-4 max-abs.
"""
import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax
from maniskill_tpu.examples.baselines import diffusion_policy as jdp

from maniskill_tpu_torch.examples.baselines import diffusion_policy as tdp
from maniskill_tpu_torch.utils import h5

from test_torch_common import assert_adam_params_close, assert_trees_equal, one_torch_thread  # noqa: F401

DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demos", "PickCube-v1",
                    "mp_PickCube-v1.h5")
H, W, STEPS, BATCH, LR, HIDDEN, DIMS = 8, 2, 6, 8, 3e-4, 64, (16, 32)
EPISODES = (7, 9, 8)  # steps per episode: 24 windows, 3 minibatches of 8
STATE, ACT, FRAME = 9, 8, (32, 32, 3)
FWD_TOL, LOSS_TOL, CHAIN_TOL = 1e-5, 1e-5, 1e-4


def write_demo(path):
    """Three episodes: obs/agent/{qpos, qvel} float32 and one camera's uint8
    rgb per step, actions, terminated and truncated."""
    rng = np.random.default_rng(0)
    with h5.File(path, "w") as f:
        for ep, T in enumerate(EPISODES):
            g = f"traj_{ep}"
            f.create_dataset(f"{g}/actions", data=rng.uniform(-1, 1, (T, ACT)).astype(np.float32))
            f.create_dataset(f"{g}/obs/agent/qpos", data=rng.normal(size=(T + 1, STATE)).astype(np.float32))
            f.create_dataset(f"{g}/obs/agent/qvel", data=rng.normal(size=(T + 1, 2)).astype(np.float32))
            f.create_dataset(f"{g}/obs/sensor_data/base_camera/rgb",
                             data=rng.integers(0, 256, (T + 1,) + FRAME, dtype=np.uint8))
            f.create_dataset(f"{g}/terminated", data=np.zeros(T, bool))
            f.create_dataset(f"{g}/truncated", data=np.arange(T) == T - 1)


ARGV = ["--epochs", "0", "--batch-size", str(BATCH), "--unet-dims", *map(str, DIMS), "--hidden", str(HIDDEN),
        "--diffusion-steps", str(STEPS), "--horizon", str(H), "--obs-window", str(W)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX CLI's Denoiser (unet, with frames), its params, its jitted
    epoch_step and sample_chunk, and its training arrays, from one run."""
    path = str(tmp_path_factory.mktemp("dp") / "demo.h5")
    write_demo(path)
    cap, arrays = {}, []
    orig_jit, orig_asarray = jax.jit, jnp.asarray

    def init(self, rngs, noisy, obs, imgs, t):
        """The params of a port Denoiser of the same shapes, carried into
        flax (applying them checks every name and shape flax asks for)."""
        model = tdp.Denoiser(self.kind, H, ACT, obs.shape[1], imgs.shape[2:] if imgs is not None else None, W,
                             HIDDEN, DIMS, seed=1)
        cap.update(module=self, params=tdp.params_to_flax(model))
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
        jdp.main(["--traj-path", path] + ARGV)
    cap["X"], cap["Y"], cap["XI"] = arrays[-3:]
    cap["path"] = path
    return cap


def _port(ref, kind="unet", images=True, params=None, seed=0):
    model = tdp.Denoiser(kind, H, ACT, ref["X"].shape[1], FRAME if images else None, W, HIDDEN, DIMS, seed=seed)
    if params is not None:
        model.load_state_dict(tdp.params_from_flax(params, model))
    return model


def test_dataset_matches_the_jax_cli(ref):
    X, Y, XI, a_min, a_scale = tdp.load_dataset(ref["path"], H, W)
    for name, got, want in (("X", X, ref["X"]), ("Y", Y, ref["Y"]), ("XI", XI, ref["XI"])):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert X.shape == (sum(EPISODES), W * (STATE + 2)) and XI.shape == (sum(EPISODES), W) + FRAME
    # the action range of the JAX CLI's own windows over the same file
    with h5.File(ref["path"]) as f:
        raw = np.concatenate([jdp._windows(np.zeros((T + 1, 1), np.float32), f[f"traj_{ep}/actions"][()], W, H)[1]
                              for ep, T in enumerate(EPISODES)])
    np.testing.assert_array_equal(a_min, raw.min(axis=(0, 1)))
    np.testing.assert_array_equal(a_scale, np.maximum(raw.max(axis=(0, 1)) - raw.min(axis=(0, 1)), 1e-4))


def test_params_round_trip_exactly(ref):
    model = _port(ref, params=ref["params"])
    assert_trees_equal(ref["params"], tdp.params_to_flax(model))
    # flax's own init draws a tree of the same paths and shapes
    jm, X = ref["module"], ref["X"]
    shapes = jax.eval_shape(lambda *a: jm.init(*a), jax.random.PRNGKey(0), jnp.zeros((1, H, ACT)),
                            jnp.zeros((1, X.shape[1])), jnp.zeros((1, W) + FRAME, jnp.uint8), jnp.zeros((1,)))
    assert jax.tree_util.tree_map(lambda x: x.shape, shapes) == jax.tree_util.tree_map(np.shape, ref["params"])


@pytest.mark.parametrize("kind", ["unet", "mlp"])
@pytest.mark.parametrize("images", [True, False])
def test_forward_matches_the_jax_denoiser(ref, kind, images):
    """The captured variant from its flax params; the others from the
    port's init carried into flax (``params_to_flax``)."""
    jm = type(ref["module"])(kind=kind)
    if kind == "unet" and images:
        params = ref["params"]
        model = _port(ref, params=params)
    else:
        model = _port(ref, kind, images, seed=3)
        params = tdp.params_to_flax(model)
    rng = np.random.default_rng(5)
    n = 5
    noisy = rng.normal(size=(n, H, ACT)).astype(np.float32)
    obs = rng.normal(size=(n, ref["X"].shape[1])).astype(np.float32)
    imgs = rng.integers(0, 256, (n, W) + FRAME, dtype=np.uint8) if images else None
    t = rng.integers(0, STEPS, n).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, noisy, obs, imgs, t))
    with torch.no_grad():
        got = model(*(torch.as_tensor(x) if x is not None else None for x in (noisy, obs, imgs, t))).numpy()
    assert got.shape == want.shape == (n, H, ACT)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)


def _epoch_draws(key, n, nb, bs):
    """The JAX epoch_step's draws from ``key`` (diffusion_policy.py:254-264)."""
    def draws(key):
        perm_key, key = jax.random.split(key)
        t, noise = [], []
        for _ in range(nb):
            key, tk, nk = jax.random.split(key, 3)
            t.append(jax.random.randint(tk, (bs,), 0, STEPS))
            noise.append(jax.random.normal(nk, (bs, H, ACT)))
        return jax.random.permutation(perm_key, n), jnp.stack(t), jnp.stack(noise)

    perm, t, noise = (torch.as_tensor(np.array(x)) for x in jax.jit(draws)(key))
    return dict(perm=perm.long(), t=t.long(), noise=noise)


def test_one_epoch_matches_the_jax_cli(ref):
    params, key = ref["params"], jax.random.PRNGKey(11)
    new_params, _, _, jloss = ref["epoch_step"](params, optax.adam(LR).init(params), key)
    n = ref["X"].shape[0]
    nb = n // BATCH
    model = _port(ref, params=params)
    opt = torch.optim.Adam(model.parameters(), lr=LR, eps=1e-8)
    alpha_bar = torch.as_tensor(tdp.ddpm_schedule(STEPS)[2])
    data = [torch.as_tensor(ref[k]) for k in ("X", "Y", "XI")]
    tloss = tdp.epoch_step(model, opt, *data, alpha_bar, _epoch_draws(key, n, nb, BATCH))
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL * max(1.0, abs(float(jloss))), (float(tloss), float(jloss))
    assert_adam_params_close(jax.device_get(new_params), tdp.params_to_flax(model), LR, nb, "dp epoch")


def test_ddpm_chain_matches_the_jax_cli(ref):
    rng = np.random.default_rng(7)
    n = 4
    obs = rng.normal(size=(n, ref["X"].shape[1])).astype(np.float32)
    imgs = rng.integers(0, 256, (n, W) + FRAME, dtype=np.uint8)
    key = jax.random.PRNGKey(13)
    want = np.asarray(ref["sample_chunk"](ref["params"], obs, imgs, key))
    # sample_chunk's draws (diffusion_policy.py:296-307): x_T from the key,
    # then one split per step
    def draws(key):
        noise = []
        for _ in range(STEPS):
            key, nk = jax.random.split(key)
            noise.append(jax.random.normal(nk, (n, H, ACT)))
        return jnp.stack(noise)

    x_T, noise = jax.random.normal(key, (n, H, ACT)), jax.jit(draws)(key)
    got = tdp.sample_chunk(_port(ref, params=ref["params"]), torch.as_tensor(obs), torch.as_tensor(imgs),
                           tdp.ddpm_schedule(STEPS), torch.as_tensor(np.array(x_T)),
                           torch.as_tensor(np.array(noise))).numpy()
    assert np.abs(want).max() > 0.1  # not all clipped to 0
    np.testing.assert_allclose(got, want, rtol=0, atol=CHAIN_TOL)


def test_obs_parts_matches_split_obs():
    """The eval's flattening of a live obs tree equals the dataset's."""
    rng = np.random.default_rng(2)
    obs = {"agent": {"qvel": rng.normal(size=(3, 2)).astype(np.float32),
                     "qpos": rng.normal(size=(3, 4)).astype(np.float32)},
           "sensor_data": {"b": {"rgb": rng.integers(0, 256, (3, 8, 8, 3), dtype=np.uint8)},
                           "a": {"rgb": rng.integers(0, 256, (3, 8, 8, 3), dtype=np.uint8),
                                 "depth": rng.integers(0, 900, (3, 8, 8, 1)).astype(np.int16)}}}
    vec, imgs = jdp._split_obs(obs, 1)
    tvec, timg = tdp.obs_parts(jax.tree_util.tree_map(torch.as_tensor, obs))
    np.testing.assert_array_equal(tvec.numpy(), vec)
    np.testing.assert_array_equal(timg.numpy(), np.concatenate(imgs, -1))


def test_cli_trains_and_evaluates_on_the_cpu(ref, capsys):
    """Two epochs on the frames file, then the mlp on the repo's PickCube
    demos with the 50-step eval in a PickCube env at 2 envs."""
    out = tdp.main(["--traj-path", ref["path"], "--device", "cpu", "--epochs", "2", "--batch-size", "8",
                    "--unet-dims", "16", "32", "--diffusion-steps", "4"])
    assert len(out["loss"]) == 2 and all(np.isfinite(out["loss"])) and out["eval_success"] is None
    out = tdp.main(["--traj-path", DEMO, "--env-id", "PickCube-v1", "--device", "cpu", "--epochs", "1",
                    "--denoiser", "mlp", "--hidden", "32", "--diffusion-steps", "2", "--eval-episodes", "2"])
    printed = capsys.readouterr().out
    assert f"dataset: {sum(EPISODES)} windows, state 22, chunk 8x8, images (2, 32, 32, 3)" in printed
    assert "dataset: 1000 windows, state 102, chunk 8x8" in printed and "eval success_once" in printed
    assert 0.0 <= out["eval_success"] <= 1.0 and out["sample_ms"] > 0
