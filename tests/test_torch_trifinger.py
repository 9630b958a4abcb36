"""The port's TriFingerRotateCube levels and TriFingerPro against the JAX
package's, at 4 envs on the CPU.

One JAX env (TriFingerRotateCubeLevel4-v1, its solver's bf16 cast made an
identity) takes one zero-action step from its state after the reset inside
``make`` and then 9 seeded random ``pd_joint_delta_pos`` steps; the port's
env starts from the same state and takes the same actions. The packages
agree to ~2e-7 over all 10 steps (the cube rests on the floor and the
fingers, moving 0.1 rad per step at most, do not reach it), so all 10 are
held: obs and the normalized dense reward within 1e-4, success and
terminated equal, ``contact.overflow == 0`` on both sides. Before any step
the models are equal and the links and joints have the same names in the
same (depth-first) order.

Levels 0-3 differ from level 4 only in how they draw the goal. The port's
env of each level, started from the JAX env's last state, computes the JAX
package's success and reward on it; a state with the cube moved onto its
goal succeeds (reward 15, normalized 1). The goals each level draws at 64
envs have that level's property.
"""
import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.agents.robots.trifingerpro import trifingerpro
from maniskill_tpu_torch.envs.tasks.dexterity.rotate_cube import RotateCubeEnv

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_tree_close, f32_reference_solver, one_torch_thread, port_rollout,
    reference_rollout, tree,
)

B = 4
STEPS = 10
KW = dict(num_envs=B, obs_mode="state_dict", control_mode="pd_joint_delta_pos")


@pytest.fixture(scope="module")
def reference(f32_reference_solver):
    """(JAX level-4 env, its rollout, its state after the rollout)."""
    je = jmake("TriFingerRotateCubeLevel4-v1", **KW)
    ref = reference_rollout(je, STEPS, first_action=0.0)
    return je, ref, tree(je.unwrapped.get_state_dict(), np.array)


def test_level4_matches_reference(reference):
    je, ref, _ = reference
    jb = je.unwrapped
    te = tmake("TriFingerRotateCubeLevel4-v1", device="cpu", **KW)
    tb = te.unwrapped
    trobot, jrobot = tb.agent.robot, jb.agent.robot
    assert [j.name for j in trobot.active_joints] == [j.name for j in jrobot.active_joints]
    assert [j.name for j in trobot.active_joints] == trifingerpro.JOINT_NAMES
    assert [link.name for link in trobot.links] == [link.name for link in jrobot.links]
    assert_models_equal(tb.scene.model, jb.scene.model)

    out = port_rollout(te, ref)
    np.testing.assert_array_equal(out["qpos0"].numpy(), ref["qpos0"])
    assert_tree_close(out["obs0"], ref["obs0"], 1e-6, "reset")
    assert_tree_close(out["obs"], ref["obs"], 1e-4, "TriFingerRotateCubeLevel4-v1")
    np.testing.assert_allclose(out["reward"].numpy(), ref["reward"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out["terminated"].numpy(), ref["terminated"])
    np.testing.assert_array_equal(out["info"]["success"].numpy(), ref["info"]["success"])
    assert tb.scene.data.contact.overflow.tolist() == [0] * B
    assert np.asarray(jb.scene.data.contact.overflow).tolist() == [0] * B
    assert np.abs(np.asarray(jb.scene.data.qvel)).max() > 0.1, "nothing moved"
    # the tip poses stack on the last axis
    tips = tb.agent.tip_poses
    assert tips.shape == (B, 7, 3)
    np.testing.assert_allclose(tips.numpy(), np.asarray(jb.agent.tip_poses), rtol=0, atol=1e-5)


@pytest.mark.parametrize("level", range(4))
def test_levels_evaluate_and_reward_on_reference_state(level, reference):
    _, ref, last = reference
    te = tmake(f"TriFingerRotateCubeLevel{level}-v1", device="cpu", **KW)
    tb = te.unwrapped
    assert tb.difficulty_level == level
    obs, info = te.reset(seed=3, options=dict(reset_to_env_states=tree(last, torch.as_tensor)))
    np.testing.assert_array_equal(info["success"].numpy(), ref["info"]["success"])
    reward = tb.compute_normalized_dense_reward(obs, None, info)
    np.testing.assert_allclose(reward.numpy(), ref["reward"], rtol=0, atol=1e-5)

    # the cube moved onto its goal succeeds in every env
    onto = tree(last, np.copy)
    onto["actors"]["cube"][:, :7] = onto["actors"]["cube_goal"][:, :7]
    obs, info = te.reset(seed=3, options=dict(reset_to_env_states=tree(onto, torch.as_tensor)))
    assert info["success"].all()
    np.testing.assert_array_equal(tb.compute_normalized_dense_reward(obs, None, info).numpy(), np.ones(B, np.float32))


def test_goal_sampling_by_level():
    """Each level's goals at 64 envs: 0 on the floor (z = 0.0325) with no
    rotation, 1 the same turned about z only, 2 fixed at (0, 0, 0.0825), 3
    in the air with no rotation, 4 in the air with any rotation; random
    positions lie within the arena's reach of its centre."""
    n = 64
    r_max = RotateCubeEnv.max_com_distance_to_center
    for level in range(5):
        te = tmake(f"TriFingerRotateCubeLevel{level}-v1", num_envs=n, device="cpu")
        te.reset(seed=11)
        goal = te.unwrapped.obj_goal.pose
        p, q = goal.p.numpy(), goal.q.numpy()
        r = np.linalg.norm(p[:, :2], axis=1)
        np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-6)
        if level in (0, 1):
            np.testing.assert_array_equal(p[:, 2], np.float32(0.065 / 2))
        if level in (0, 2, 3):
            np.testing.assert_array_equal(q, np.broadcast_to(np.float32([1, 0, 0, 0]), (n, 4)))
        if level == 1:
            np.testing.assert_array_equal(q[:, 1:3], 0.0)
            assert np.abs(q[:, 3]).max() > 0.5  # turned, about z only
        if level == 2:
            np.testing.assert_allclose(p, np.broadcast_to(np.float32([0, 0, 0.065 / 2 + 0.05]), (n, 3)), atol=1e-7)
        else:
            assert (r <= r_max + 1e-6).all() and r.max() > 0.5 * r_max
        if level == 3:
            assert ((p[:, 2] >= 0.065 / 2) & (p[:, 2] < 0.1)).all() and np.ptp(p[:, 2]) > 0.02
        if level == 4:
            assert ((p[:, 2] >= RotateCubeEnv.radius_3d) & (p[:, 2] < 0.1)).all()
            assert np.abs(q[:, 1:3]).max() > 0.5


def test_goal_cube_is_hidden_and_kinematic():
    """The goal cube has no collision geom, is kinematic and is hidden from
    the cameras."""
    from maniskill_tpu_torch.physics.types import KINEMATIC

    tb = tmake("TriFingerRotateCubeLevel4-v1", num_envs=2, device="cpu").unwrapped
    goal = tb.obj_goal
    assert goal.body_type == KINEMATIC and goal in tb._hidden_objects
    assert all(tb.scene.mb.geoms[g].visual for g in goal.geom_ids)
    assert len([a for a in tb.scene.actors if a.startswith("arena_wall_")]) == 8
