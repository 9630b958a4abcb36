"""The port's seven single-robot tabletop tasks of the family's last slice
(PokeCube, RollBall, PushT, TurnFaucet, PlugCharger, PegInsertionSide,
AssemblingKits) against the JAX package's, at 4 envs on the CPU.

For each task both packages start from the JAX env's state after the reset
inside ``make`` (through ``reset_to_env_states``) and take 6 steps of the
same seeded random ``pd_joint_delta_pos`` actions. Two tasks take one step,
since their objects settle chaotically in both packages and the packages
part by more than round-off within two:
- PegInsertionSide: the peg spawns just touching the table, and in env 0 of
  this state it rocks while it settles, which amplifies round-off ~50x per
  control step (6e-6 m after one step, 7e-3 m after four). The settled peg
  is stepped in tests/test_torch_peg_insertion.py.
- AssemblingKits: the piece's hull proxies pad a block's 8 corners with
  repeats of the first, so a piece landing flat ties its deepest-4 contact
  points; round-off then tips some pieces onto an edge (~1 degree, z 0.7 mm
  lower), in both packages but in other envs after the second step.
Then: the obs within
1e-4, the reward within 1e-4 (normalized dense, or sparse where the task
has only that), ``success`` equal, ``contact.overflow == 0`` on both sides.
Before the steps the two models' candidate pairs, body and geom types and
per-env tables (geom sizes and offsets, hull clouds) are equal, and the
obs after the reset are within 1e-6. PegInsertionSide draws its per-env
geometry from ``geometry_seed=5`` in both packages (numpy draws, the same
arrays); AssemblingKits' per-env shapes come from the same numpy draw.
Each JAX env is made once, with its solver's bf16 cast made an identity
(``f32_solver``, tests/test_torch_common.py) before it compiles.
"""
import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_obs_close, f32_reference_solver, jax_cooking, one_torch_thread, tree,
)

B = 4
STEPS = 6
TASKS = ["PokeCube-v1", "RollBall-v1", "PushT-v1", "TurnFaucet-v1", "PlugCharger-v1",
         "PegInsertionSide-v1", "AssemblingKits-v1"]
SPARSE = {"PlugCharger-v1", "AssemblingKits-v1"}
STEPS_OF = {"PegInsertionSide-v1": 1, "AssemblingKits-v1": 1}
EXTRA_KW = {"PegInsertionSide-v1": dict(geometry_seed=5), "PlugCharger-v1": dict(robot_uids="panda")}


def _kwargs(env_id):
    reward_mode = "sparse" if env_id in SPARSE else "normalized_dense"
    return dict(num_envs=B, obs_mode="state_dict", reward_mode=reward_mode, control_mode="pd_joint_delta_pos",
                **EXTRA_KW.get(env_id, {}))


@pytest.fixture(scope="module")
def jax_env(f32_reference_solver, jax_cooking):
    """``jax_env(env_id)``: the task's JAX env, made once per module."""
    envs = {}

    def get(env_id):
        if env_id not in envs:
            envs[env_id] = jmake(env_id, **_kwargs(env_id))
        return envs[env_id]

    return get


@pytest.mark.parametrize("env_id", TASKS)
def test_task_matches_reference(env_id, jax_env):
    je = jax_env(env_id)
    te = tmake(env_id, device="cpu", **_kwargs(env_id))
    jb, tb = je.unwrapped, te.unwrapped
    assert_models_equal(tb.scene.model, jb.scene.model)
    # the JAX env's state after the reset inside make (a second JAX reset
    # would compile the reset again)
    tobs, _ = te.reset(seed=3, options=dict(reset_to_env_states=tree(
        jb.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))))
    np.testing.assert_array_equal(tb.scene.data.qpos.numpy(), np.asarray(jb.scene.data.qpos))
    assert_obs_close(tobs, jb._init_raw_obs, 1e-6, f"{env_id} reset")

    rng = np.random.default_rng(7)
    for _ in range(STEPS_OF.get(env_id, STEPS)):
        action = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
        jobs, jrew, jterm, _, jinfo = je.step(action)
        tobs, trew, tterm, _, tinfo = te.step(torch.as_tensor(action))
    assert_obs_close(tobs, jobs, 1e-4, env_id)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tinfo["success"].numpy(), np.asarray(jinfo["success"]))
    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
    assert tb.scene.data.contact.overflow.tolist() == [0] * B
    assert np.asarray(jb.scene.data.contact.overflow).tolist() == [0] * B
    assert np.abs(np.asarray(jb.scene.data.qvel)).max() > 0.1, "nothing moved"
