"""The port's trajectory replay (maniskill_tpu_torch/trajectory/replay_trajectory.py)
on the repo's PickCube-v1 demos, on the CPU.

- The batched open-loop replay of all 24 episodes as the envs of one batch,
  each started from its recorded first state (``--use-first-env-state``: the
  port's RNG draws other initial states than the JAX package's for the same
  seed), solves at least the recorded count less 2, the bar of
  tests/test_torch_motionplanning.py.
- Replay by env states steps each recorded action and then restores the
  recorded state of the step's end: every restored state equals the
  recording within 1e-5, and the last one reports the recorded success. On
  the last 3 steps of the same episode the JAX package's replay, which
  restores state t+1 before it steps with action t, ends one step past the
  recording and reports failure (a fault of the reference).
- ``_ActionConverter`` to pd_joint_delta_pos and pd_ee_delta_pos, from one
  recorded state restored in both packages, equals the JAX converter's
  output.
"""
import json
import os

import h5py
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.trajectory import replay_trajectory as jreplay
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.trajectory import replay_trajectory as treplay

from test_torch_common import one_torch_thread, tree  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demos", "PickCube-v1", "mp_PickCube-v1.h5")


def _meta():
    with open(DEMO.replace(".h5", ".json")) as f:
        return json.load(f)


def test_batched_replay_reproduces_the_recorded_success(capsys):
    out = treplay.main(["--traj-path", DEMO, "--num-envs", "24", "--device", "cpu", "--use-first-env-state"])
    recorded = sum(e["success"] for e in _meta()["episodes"])
    assert len(out["success"]) == 24
    assert sum(out["success"]) >= recorded - 2, (sum(out["success"]), recorded)
    assert f"replayed 24 episodes, success={sum(out['success'])}" in capsys.readouterr().out


def test_replay_by_env_states_restores_each_recorded_state():
    out = treplay.main(["--traj-path", DEMO, "--use-env-states", "--num-episodes", "1", "--device", "cpu"])
    assert out["state_err"][0] <= 1e-5, out["state_err"]
    assert out["success"] == [_meta()["episodes"][0]["success"]] == [True]


@pytest.fixture(scope="module")
def tail_file(tmp_path_factory):
    """Episode 0's last 3 steps as a trajectory file of its own."""
    path = str(tmp_path_factory.mktemp("tail") / "tail.h5")
    meta = _meta()
    with h5py.File(DEMO) as src, h5py.File(path, "w") as dst:
        traj = src["traj_0"]
        g = dst.create_group("traj_0")
        for k in ("actions", "terminated", "truncated", "rewards"):
            g.create_dataset(k, data=traj[k][-3:])
        for k in ("success", "fail"):
            g.create_dataset(k, data=traj[k][()])

        def copy(s, d):
            for k, v in s.items():
                if isinstance(v, h5py.Group):
                    copy(v, d.create_group(k))
                else:
                    d.create_dataset(k, data=v[-4:])

        copy(traj["env_states"], g.create_group("env_states"))
    meta["episodes"] = [dict(meta["episodes"][0], elapsed_steps=3)]
    meta["env_info"]["env_kwargs"]["num_envs"] = 1
    with open(path.replace(".h5", ".json"), "w") as f:
        json.dump(meta, f)
    return path


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_forward():
    """The JAX package's ``physics.forward``, and the forward kinematics its
    action converter calls, under ``jax.jit`` for this file: outside any jit
    they run op by op (~5 s a call here); every JAX env of the file shares
    one model shape, so each compiles once."""
    import jax
    from maniskill_tpu import physics as jphys
    from maniskill_tpu.agents.controllers.utils import kinematics as jkin

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jphys, "forward", jax.jit(jphys.forward))
        mp.setattr(jkin, "forward_kinematics", jax.jit(jkin.forward_kinematics))
        yield


def test_jax_replay_by_env_states_ends_past_the_recording(tail_file, capsys):
    out = treplay.main(["--traj-path", tail_file, "--use-env-states", "--device", "cpu"])
    assert out["success"] == [True] and out["state_err"][0] <= 1e-5
    capsys.readouterr()
    jreplay.main(["--traj-path", tail_file, "--use-env-states"])
    assert "episode 0: success=False" in capsys.readouterr().out


@pytest.mark.parametrize("target", ["pd_joint_delta_pos", "pd_ee_delta_pos"])
def test_action_converter_matches_the_jax_package(target):
    t_step = 12
    with h5py.File(DEMO) as f:
        traj = f["traj_3"]
        action = traj["actions"][t_step][None]
        state = tree(jreplay._nested_to_arrays(traj["env_states"]), lambda v: v[t_step][None])
    kw = dict(num_envs=1, obs_mode="state", control_mode=target, reward_mode="normalized_dense")
    jenv = jmake("PickCube-v1", **kw)
    jenv.reset(seed=0, options=dict(reset_to_env_states=tree(state, jnp.asarray)))
    tenv = tmake("PickCube-v1", device="cpu", **kw)
    tenv.reset(seed=0, options=dict(reset_to_env_states=tree(state, torch.as_tensor)))
    want = jreplay._ActionConverter(jenv, "pd_joint_pos", target)(action)
    got = treplay._ActionConverter(tenv, "pd_joint_pos", target)(action)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert np.abs(want[:, :-1]).max() > 1e-3  # a move, not zeros
