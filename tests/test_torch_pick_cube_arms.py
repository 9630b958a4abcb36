"""The port's PickCubeSO100-v1 against the JAX package's, at 2 envs on the
CPU.

One JAX env (its solver's bf16 cast made an identity) starts from its state
after the reset inside ``make``; the port's env starts from the same state.
Both take a zero-action step and one seeded random ``pd_joint_delta_pos``
step: after each, obs within 1e-4, qpos within 1e-5, reward and info equal
(float info within 1e-4) and ``contact.overflow == 0``. The models are
equal. The static reward slices ``qvel[..., :-2]`` for the SO100 too,
dropping an arm joint, as the reference does (ROADMAP section 3): the
reward of an env whose last arm joint alone moves shows it.
PickCubeWidowXAI-v1 has a file of its own
(tests/test_torch_pick_cube_widowxai.py), so each stays near ~30 s.
"""
import numpy as np
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_steps_match, f32_reference_solver, one_torch_thread,
)

B = 2
KW = dict(num_envs=B, obs_mode="state", control_mode="pd_joint_delta_pos")


def test_pick_cube_so100_matches_reference(f32_reference_solver):
    je = jmake("PickCubeSO100-v1", **KW)
    te = tmake("PickCubeSO100-v1", device="cpu", **KW)
    jb, tb = je.unwrapped, te.unwrapped
    assert [link.name for link in tb.agent.robot.links] == [link.name for link in jb.agent.robot.links]
    assert_models_equal(tb.scene.model, jb.scene.model)
    rng = np.random.default_rng(7)
    actions = [np.zeros((B, 6), np.float32), rng.uniform(-1, 1, (B, 6)).astype(np.float32)]
    assert_steps_match(je, te, actions, 1e-4, 1e-5, "PickCubeSO100-v1")
    assert np.abs(np.asarray(jb.scene.data.qvel)).max() > 0.1, "nothing moved"

    # the static reward ignores the wrist roll (the 5th of 6 joints): a
    # placed cube's reward with only that joint moving equals the reward at
    # rest, with the 4th moving it is lower
    info = dict(is_grasped=torch.zeros(B, dtype=torch.bool), is_obj_placed=torch.ones(B, dtype=torch.bool),
                success=torch.zeros(B, dtype=torch.bool))

    def reward_with_joint_moving(j):
        qvel = torch.zeros(B, tb.agent.robot.dof)
        if j is not None:
            qvel[:, j] = 5.0
        tb.agent.robot.set_qvel(qvel)
        return tb.compute_dense_reward(None, None, info)

    at_rest = reward_with_joint_moving(None)
    torch.testing.assert_close(reward_with_joint_moving(4), at_rest, rtol=0, atol=0)
    assert bool((reward_with_joint_moving(3) < at_rest - 0.5).all())
