"""The port's FrankaMoveBenchmark-v1 and FrankaPickCubeBenchmark-v1 (state
obs, Panda on a ground plane, 100/50 Hz) against the JAX package's, on the
CPU: both envs set to the same ``reset_to_env_states`` take 2 control steps
of seeded random actions; qpos at atol 1e-4, qvel at 1e-3, obs at 1e-3,
``contact.overflow == 0`` on both sides. The reference solver runs with its
bf16 matvec cast made an identity (see tests/test_torch_common.py).
"""

import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake

from test_torch_common import f32_reference_solver, one_torch_thread, tree  # noqa: F401

B = 2


@pytest.mark.parametrize("uid", ["FrankaMoveBenchmark-v1", "FrankaPickCubeBenchmark-v1"])
def test_benchmark_env_matches_reference(uid, f32_reference_solver):
    je = jmake(uid, num_envs=B, obs_mode="state", control_mode="pd_joint_delta_pos")
    te = tmake(uid, num_envs=B, obs_mode="state", control_mode="pd_joint_delta_pos", device="cpu")
    base = te.unwrapped
    assert base.sim_config.sim_steps_per_control == 2
    assert base.scene.model.solver_iterations == (8 if "Move" in uid else 10)
    je.reset(seed=0)
    state = tree(je.unwrapped.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))
    te.reset(seed=0, options=dict(reset_to_env_states=state))

    rng = np.random.default_rng(1)
    for _ in range(2):
        action = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
        jobs, jrew, *_ = je.step(action)
        tobs, trew, *_ = te.step(torch.as_tensor(action))
    jdata, tdata = je.unwrapped.scene.data, base.scene.data
    np.testing.assert_allclose(tdata.qpos.numpy(), np.asarray(jdata.qpos), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tdata.qvel.numpy(), np.asarray(jdata.qvel), rtol=0, atol=1e-3)
    assert np.abs(np.asarray(jdata.qvel)).max() > 0.1, "the arm did not move"
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
    assert tdata.contact.overflow.tolist() == [0] * B
    assert np.asarray(jdata.contact.overflow).tolist() == [0] * B
    if "PickCube" in uid:
        # the cube rests on the ground, untouched
        np.testing.assert_allclose(base.cube.pose.p[:, 2].numpy(), 0.02, atol=1e-3)
