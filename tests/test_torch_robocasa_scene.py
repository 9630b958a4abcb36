"""The port's RoboCasa_SceneManipulation-v1 against the JAX package's, on
the CPU: the RoboCasa builder registered as a scene builder of
SceneManipulation-v1 (the one-wall kitchen, the Fetch standing in its open
floor). At 2 envs from the JAX env's state after the reset inside
``make`` (its solver's bf16 cast made an identity): 2 zero-action steps,
qpos within 1e-5, obs within 1e-4.
"""
import numpy as np
import pytest

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake

from test_torch_common import assert_steps_match, f32_reference_solver, one_torch_thread  # noqa: F401

B = 2
UID = "RoboCasa_SceneManipulation-v1"


@pytest.fixture(scope="module")
def envs(f32_reference_solver):  # noqa: F811
    kw = dict(num_envs=B, obs_mode="state")
    return jmake(UID, **kw), tmake(UID, device="cpu", **kw)


def test_robocasa_scene_manipulation_steps_match_reference(envs):
    je, te = envs
    jb, tb = je.unwrapped, te.unwrapped
    assert type(tb.scene_builder).__name__ == type(jb.scene_builder).__name__ == "RoboCasaSceneBuilder"
    assert tb.agent.uid == "fetch" and te.single_action_space.shape == (13,)
    assert (tb.scene.model.nbody, tb.scene.model.ngeom, tb.scene.model.nv) == (28, 153, 21)
    np.testing.assert_array_equal(tb.agent.robot.root_pose.p.numpy(), np.asarray(jb.agent.robot.root_pose.p))
    assert tb.reward_mode == "none" and tb.evaluate() == {}
    actions = [np.zeros((B, 13), np.float32)] * 2
    assert_steps_match(je, te, actions, 1e-4, 1e-5, UID)
