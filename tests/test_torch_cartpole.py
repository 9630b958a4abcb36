"""The PyTorch port's slice end to end: CartpoleBalanceBenchmark-v1 with RGB
observations, against the JAX package's env, on the CPU.

Parity by state, not by seed: the JAX env's reset state goes into the port
through ``reset(options=dict(reset_to_env_states=...))``, then both take the
same numpy actions. qpos/qvel within atol 1e-4 after 10 control steps (20 f32
substeps); rgb within 1 of 255 on >= 99% of pixels (the JAX CPU path is the
jnp rasterizer, which renders back faces too; tests/test_render.py:100-108).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.envs.utils import rewards as jrewards
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.envs.utils import rewards as trewards

from test_torch_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE = dict(obs_mode="rgb", control_mode="pd_joint_delta_pos")


def _tree(x, fn):
    return {k: _tree(v, fn) for k, v in x.items()} if isinstance(x, dict) else fn(x)


def test_slice_matches_reference():
    B = 2
    je = jmake("CartpoleBalanceBenchmark-v1", num_envs=B, **SLICE)
    te = tmake("CartpoleBalanceBenchmark-v1", num_envs=B, device="cpu", **SLICE)
    je.reset(seed=0)
    state = _tree(je.unwrapped.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))
    tobs, _ = te.reset(seed=0, options=dict(reset_to_env_states=state))
    jdata, tdata = je.unwrapped.scene.data, te.unwrapped.scene.data
    np.testing.assert_array_equal(tdata.qpos.numpy(), np.asarray(jdata.qpos))

    rng = np.random.default_rng(0)
    for _ in range(10):
        action = rng.uniform(-1, 1, (B, 1)).astype(np.float32)
        jobs, jrew, jterm, _, _ = je.step(action)
        tobs, trew, tterm, ttrunc, tinfo = te.step(action)
    jdata, tdata = je.unwrapped.scene.data, te.unwrapped.scene.data
    np.testing.assert_allclose(tdata.qpos.numpy(), np.asarray(jdata.qpos), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tdata.qvel.numpy(), np.asarray(jdata.qvel), rtol=0, atol=1e-4)
    assert np.abs(np.asarray(jdata.qpos)).max() > 0.05, "the cart did not move"

    jrgb = np.asarray(jobs["sensor_data"]["base_camera_0"]["rgb"]).astype(np.int32)
    trgb = tobs["sensor_data"]["base_camera_0"]["rgb"]
    assert trgb.shape == (B, 128, 128, 3) and trgb.dtype == torch.uint8
    close = np.abs(trgb.numpy().astype(np.int32) - jrgb).max(-1) <= 1
    assert close.mean() >= 0.99, close.mean()
    for key in ("qpos", "qvel"):
        np.testing.assert_allclose(tobs["agent"][key].numpy(), np.asarray(jobs["agent"][key]), atol=1e-4)
    for key in ("velocity", "angular_velocity"):
        np.testing.assert_allclose(tobs["extra"][key].numpy(), np.asarray(jobs["extra"][key]), atol=1e-3)
    np.testing.assert_allclose(tobs["agent"]["controller"]["slider"]["target_qpos"].numpy(),
                               np.asarray(jobs["agent"]["controller"]["slider"]["target_qpos"]),
                               atol=1e-4)
    for key, v in tobs["sensor_param"]["base_camera_0"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jobs["sensor_param"]["base_camera_0"][key]),
                                   atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
    assert tinfo["elapsed_steps"].tolist() == [10, 10] and not ttrunc.any()


def test_import_and_step_without_jax():
    """The port imports no jax, flax, optax, gymnasium or maniskill_tpu: a
    process that blocks them still imports maniskill_tpu_torch, runs a CPU
    step of the Cartpole RGB slice and of PickCube-v1, builds the PPO
    trainer and loads the repo's state checkpoint into it."""
    code = textwrap.dedent('''
        import sys
        import importlib.abc

        BLOCKED = ("jax", "jaxlib", "flax", "optax", "gymnasium", "maniskill_tpu")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import: {name}")
                return None

        sys.meta_path.insert(0, Block())
        import numpy as np
        import maniskill_tpu_torch.envs
        from maniskill_tpu_torch import make

        env = make("CartpoleBalanceBenchmark-v1", num_envs=2, obs_mode="rgb",
                   control_mode="pd_joint_delta_pos", device="cpu")
        env.reset(seed=0)
        obs, *_ = env.step(np.zeros((2, 1), np.float32))
        assert tuple(obs["sensor_data"]["base_camera_0"]["rgb"].shape) == (2, 128, 128, 3)
        env = make("PickCube-v1", num_envs=2, obs_mode="state",
                   control_mode="pd_joint_delta_pos", device="cpu")
        env.reset(seed=0)
        obs, *_ = env.step(np.zeros((2, 8), np.float32))
        assert tuple(obs.shape) == (2, 51) and bool(obs.isfinite().all())
        from maniskill_tpu_torch.parallel import train
        trainer = train.PPOTrainer(env, train.PPOConfig(rollout_steps=1), obs)
        tree = train.load_jax_checkpoint("examples_checkpoints/ppo_pickcube_state.pkl")
        trainer.model.load_state_dict(train.params_from_flax(tree))
        loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not loaded, loaded
        print("STEP_OK")
    ''')
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "STEP_OK" in res.stdout, res.stderr[-3000:]


def test_device_is_never_chosen_quietly():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmake("CartpoleBalanceBenchmark-v1", num_envs=1, **SLICE)


def test_reset_seeding_and_partial_reset():
    env = tmake("CartpoleBalanceBenchmark-v1", num_envs=3, device="cpu", obs_mode="state")
    base = env.unwrapped
    env.reset(seed=5)
    q0 = base.scene.data.qpos.clone()
    assert (q0[:, 0].abs() <= 0.1).all() and (q0[:, 1].abs() <= 0.034).all()
    assert len(set(q0[:, 0].tolist())) == 3, "envs drew the same episode"
    env.reset(seed=5)
    torch.testing.assert_close(base.scene.data.qpos, q0, rtol=0, atol=0)
    for _ in range(3):
        env.step(np.full((3, 1), 0.5, np.float32))
    moved = base.scene.data.qpos.clone()
    env.reset(seed=[11], options=dict(env_idx=[1]))
    after = base.scene.data.qpos
    torch.testing.assert_close(after[[0, 2]], moved[[0, 2]], rtol=0, atol=0)
    assert not torch.equal(after[1], moved[1])
    # env 1's episode is a function of its own seed only
    env.reset(seed=[11, 11, 11])
    torch.testing.assert_close(base.scene.data.qpos[1], after[1], rtol=0, atol=0)
    assert base.elapsed_steps.tolist() == [0, 0, 0]


@pytest.mark.parametrize("sigmoid", ["gaussian", "hyperbolic", "long_tail", "reciprocal",
                                     "cosine", "linear", "quadratic", "tanh_squared"])
def test_reward_tolerance_matches_reference(sigmoid):
    x = np.linspace(-3, 3, 61, dtype=np.float32)
    kw = dict(bounds=(-0.5, 0.25), margin=1.5, sigmoid=sigmoid, value_at_margin=0.2)
    np.testing.assert_allclose(trewards.tolerance(torch.as_tensor(x), **kw).numpy(),
                               np.asarray(jrewards.tolerance(jnp.asarray(x), **kw)), atol=1e-6)


def test_balance_env_dense_reward():
    """MS-CartpoleBalance-v1 (the dense-reward cartpole) steps and scores in
    [0, 1], upright and centred near 1 at reset."""
    env = tmake("MS-CartpoleBalance-v1", num_envs=2, device="cpu", obs_mode="state",
                reward_mode="dense")
    obs, _ = env.reset(seed=0)
    assert obs.shape == (2, 11)
    obs, rew, term, trunc, info = env.step(np.zeros((2, 1), np.float32))
    assert ((rew > 0.9) & (rew <= 1.0)).all(), rew
    assert not term.any() and "fail" in info
