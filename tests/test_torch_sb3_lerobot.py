"""The port's SB3 adapter (maniskill_tpu_torch/vector/sb3.py) and LeRobot
converter (maniskill_tpu_torch/trajectory/convert_to_lerobot.py) against the
JAX package's, on the CPU.

- SB3: both adapters over one port PickCube env's outputs at 3 envs (the
  JAX adapter reads them as jax arrays through a thin stand-in env, so the
  adapters alone differ): reset obs, then 4 steps of the same numpy actions,
  the last one past the 50-step time limit: obs, rewards, dones and every
  env's info dict equal, ``TimeLimit.truncated`` included. The port's host
  copy packs a step's tensors into one buffer (checked on a mix of dtypes).
- LeRobot: both converters on the repo's PickCube demos write the same
  parquet frames (pandas frames equal) and the same meta JSON files.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from maniskill_tpu.trajectory import convert_to_lerobot as jlerobot
from maniskill_tpu.vector import sb3 as jsb3

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.trajectory import convert_to_lerobot as tlerobot
from maniskill_tpu_torch.vector import sb3 as tsb3

from test_torch_common import one_torch_thread  # noqa: F401

DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demos", "PickCube-v1",
                    "mp_PickCube-v1.h5")
B = 3


def _jax(x):
    if isinstance(x, dict):
        return {k: _jax(v) for k, v in x.items()}
    return jnp.asarray(x.numpy()) if isinstance(x, torch.Tensor) else x


class AsJax:
    """A port env whose outputs come back as jax arrays."""

    def __init__(self, env):
        self.env, self.unwrapped = env, env.unwrapped

    def reset(self, **kw):
        obs, info = self.env.reset(**kw)
        return _jax(obs), _jax(info)

    def step(self, action):
        return tuple(_jax(x) for x in self.env.step(np.asarray(action)))

    def close(self):
        self.env.close()


def _env():
    env = tmake("PickCube-v1", num_envs=B, obs_mode="state", device="cpu")
    env.reset(seed=5)  # both adapters' own seedless resets continue this RNG
    return env


def test_sb3_adapter_matches_the_jax_adapter():
    got_env, want_env = tsb3.ManiSkillSB3VectorEnv(_env()), jsb3.ManiSkillSB3VectorEnv(AsJax(_env()))
    assert got_env.num_envs == want_env.num_envs == B
    np.testing.assert_array_equal(got_env.reset(), want_env.reset())
    rng = np.random.default_rng(0)
    for n in range(4):
        if n == 3:  # the next step truncates every episode
            for e in (got_env, want_env):
                e._env.unwrapped._elapsed_steps[:] = 49
        action = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
        got, want = got_env.step(action), want_env.step(action)
        for name, g, w in zip(("obs", "rew", "dones"), got[:3], want[:3]):
            assert isinstance(g, np.ndarray) and g.dtype == np.asarray(w).dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert len(got[3]) == len(want[3]) == B
        for gi, wi in zip(got[3], want[3]):
            assert gi.keys() == wi.keys() and "success" in gi
            for k in wi:
                np.testing.assert_array_equal(gi[k], wi[k], err_msg=k)
    assert [i["TimeLimit.truncated"] for i in got[3]] == [True] * B and got[2].all()
    assert got_env.get_attr("num_envs") == [B] * B and got_env.env_is_wrapped(object) == [False] * B


def test_host_copy_packs_mixed_dtypes():
    items = [torch.arange(6, dtype=torch.float32).reshape(2, 3), {"a": torch.tensor([True, False]),
             "b": {"c": torch.tensor([7, -8], dtype=torch.int16)}}, torch.tensor(2.5, dtype=torch.float64), 3]
    obs, info, scalar, other = tsb3._to_host(items)
    np.testing.assert_array_equal(obs, np.arange(6, dtype=np.float32).reshape(2, 3))
    assert info["a"].dtype == bool and info["a"].tolist() == [True, False]
    assert info["b"]["c"].dtype == np.int16 and info["b"]["c"].tolist() == [7, -8]
    assert scalar.shape == () and float(scalar) == 2.5 and int(other) == 3


def test_lerobot_converter_matches_the_jax_converter(tmp_path):
    pd = pytest.importorskip("pandas")
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    jlerobot.main(["--traj-path", DEMO, "--output-dir", str(want_dir)])
    tlerobot.main(["--traj-path", DEMO, "--output-dir", str(got_dir)])
    want = sorted(p.relative_to(want_dir) for p in want_dir.rglob("*") if p.is_file())
    got = sorted(p.relative_to(got_dir) for p in got_dir.rglob("*") if p.is_file())
    assert want == got and len([p for p in got if p.suffix == ".parquet"]) == 24
    for rel in got:
        if rel.suffix == ".parquet":
            w, g = pd.read_parquet(want_dir / rel), pd.read_parquet(got_dir / rel)
            assert list(w.columns) == list(g.columns) and "next.reward" in g.columns
            for col in w.columns:
                np.testing.assert_array_equal(np.stack(g[col].to_numpy()), np.stack(w[col].to_numpy()), err_msg=col)
        elif rel.suffix == ".json":
            assert json.loads((got_dir / rel).read_text()) == json.loads((want_dir / rel).read_text()), rel
        else:
            assert (got_dir / rel).read_text() == (want_dir / rel).read_text(), rel
    info = json.loads((got_dir / "meta" / "info.json").read_text())
    assert info["total_episodes"] == 24 and info["features"]["observation.state"]["shape"] == [51]
