"""The port's ``unitree_h1_with_hands_upper_body_only`` against the JAX
package's, in Empty-v1 at 2 envs on the CPU, in both of its control modes:
the 8 shoulder and elbow joints and the 6 wrist and thumb joints under PD,
the 11 leg and torso joints passive. The port starts from the JAX env's
state after the reset inside ``make``; a zero step and a seeded random
step: obs within 1e-4, qpos within 1e-5, info equal (the JAX solver's bf16
cast made an identity).
"""
import numpy as np
import pytest

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_steps_match, f32_reference_solver, one_torch_thread,
)

B = 2


@pytest.mark.parametrize("mode", ["pd_joint_delta_pos", "pd_joint_pos"])
def test_h1_upper_body_with_passive_legs_matches_reference(mode, f32_reference_solver):
    uid = "unitree_h1_with_hands_upper_body_only"
    kw = dict(num_envs=B, obs_mode="state", control_mode=mode, robot_uids=uid)
    je = jmake("Empty-v1", **kw)
    te = tmake("Empty-v1", device="cpu", **kw)
    jb, tb = je.unwrapped, te.unwrapped
    assert [j.name for j in tb.agent.robot.active_joints] == [j.name for j in jb.agent.robot.active_joints]
    assert sorted(tb.agent.controller.controllers) == ["arm_hands", "body", "legs"]
    assert len(tb.agent.controller.controllers["legs"].joints) == 11
    assert_models_equal(tb.scene.model, jb.scene.model)
    rng = np.random.default_rng(5)
    actions = [np.zeros((B, 14), np.float32), rng.uniform(-0.3, 0.3, (B, 14)).astype(np.float32)]
    assert_steps_match(je, te, actions, 1e-4, 1e-5, f"H1 upper body {mode}")
