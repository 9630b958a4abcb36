"""The port's PickCubeWidowXAI-v1 and the WidowX AI against the JAX
package's, at 2 envs on the CPU.

One JAX env (its solver's bf16 cast made an identity) starts from its state
after the reset inside ``make``; the port's env starts from the same state.
Both take a zero-action step and one seeded random ``pd_joint_delta_pos``
step (6 arm joints and the mimic gripper): after each, obs within 1e-4,
qpos within 1e-5, reward and info equal (float info within 1e-4) and
``contact.overflow == 0``. The models are equal, and the robot stands at
x = -0.45.
"""
import numpy as np

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_steps_match, f32_reference_solver, one_torch_thread,
)

B = 2
KW = dict(num_envs=B, obs_mode="state", control_mode="pd_joint_delta_pos")


def test_pick_cube_widowxai_matches_reference(f32_reference_solver):
    je = jmake("PickCubeWidowXAI-v1", **KW)
    te = tmake("PickCubeWidowXAI-v1", device="cpu", **KW)
    jb, tb = je.unwrapped, te.unwrapped
    assert [link.name for link in tb.agent.robot.links] == [link.name for link in jb.agent.robot.links]
    assert_models_equal(tb.scene.model, jb.scene.model)
    np.testing.assert_allclose(tb.agent.robot.links[0].pose.p.numpy(), [[-0.45, 0, 0]] * B, atol=1e-7)
    rng = np.random.default_rng(7)
    actions = [np.zeros((B, 7), np.float32), rng.uniform(-1, 1, (B, 7)).astype(np.float32)]
    assert_steps_match(je, te, actions, 1e-4, 1e-5, "PickCubeWidowXAI-v1")
    assert np.abs(np.asarray(jb.scene.data.qvel)).max() > 0.1, "nothing moved"
