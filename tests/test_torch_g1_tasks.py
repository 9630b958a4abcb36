"""The port's G1 upper-body tasks against the JAX package's, at 2 envs on
the CPU: UnitreeG1PlaceAppleInBowl-v1 and UnitreeG1TransportBox-v1 (the
``unitree_g1_simplified_upper_body_with_head_camera`` robot,
maniskill_tpu_torch/envs/tasks/humanoid/).

Each JAX env (its solver's bf16 cast made an identity) starts from its
state after the reset inside ``make`` and the port's from the same state.
Both take a zero step and a seeded random ``pd_joint_delta_pos`` step: obs
and dense reward within 1e-4, qpos within 1e-5, info equal. Then the
object is put into the right hand in both (the apple between the thumb and
the finger chain, the box resting on both) and both take a zero step: the
hand's contact forces within 1e-4 relative (1e-3 N absolute) of the
reference's (above 1 N in all, so
the hand touches), ``_hand_is_grasping`` / the hug test equal, qpos within
1e-5, the dense reward within 1e-4.
"""
import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.structs.pose import Pose as JPose
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.structs.pose import Pose as TPose

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_steps_match, f32_reference_solver, one_torch_thread,
)

B = 2
KW = dict(num_envs=B, obs_mode="state", control_mode="pd_joint_delta_pos", reward_mode="dense")


def _put(jb, tb, actor, pose):
    """Set ``actor``'s pose (B, 7) in both envs, as a task's reset does."""
    import jax.numpy as jnp

    getattr(jb, actor).set_pose(JPose.create(jnp.asarray(pose)))
    getattr(tb, actor).set_pose(TPose.create(torch.as_tensor(pose)))


def _forces(b, links, obj):
    return np.stack([np.asarray(b.scene.get_pairwise_contact_forces(b.agent.robot.links_map[n], obj))
                     for n in links])


@pytest.mark.parametrize("uid", ["UnitreeG1PlaceAppleInBowl-v1", "UnitreeG1TransportBox-v1"])
def test_g1_task_matches_reference(uid, f32_reference_solver):
    je = jmake(uid, **KW)
    te = tmake(uid, device="cpu", **KW)
    jb, tb = je.unwrapped, te.unwrapped
    assert [link.name for link in tb.agent.robot.links] == [link.name for link in jb.agent.robot.links]
    assert [j.name for j in tb.agent.robot.active_joints] == [j.name for j in jb.agent.robot.active_joints]
    assert_models_equal(tb.scene.model, jb.scene.model)
    rng = np.random.default_rng(11)
    actions = [np.zeros((B, 25), np.float32), rng.uniform(-1, 1, (B, 25)).astype(np.float32)]
    assert_steps_match(je, te, actions, 1e-4, 1e-5, uid)

    # the object in the right hand
    quat = np.tile(np.array([1, 0, 0, 0], np.float32), (B, 1))
    if uid.startswith("UnitreeG1PlaceApple"):
        mid = (tb.agent.robot.links_map["right_five_link"].pose.p + tb.agent.robot.links_map["right_three_link"].pose.p)
        _put(jb, tb, "apple", np.concatenate([mid.numpy() / 2, quat], 1))
        obj, links = ("apple", ("right_five_link", "right_three_link"))
    else:
        # the box resting on the thumb and finger chains, 3 mm into the higher
        # of their 1 cm capsules: its weight keeps it pressing through the step
        five, three = (tb.agent.robot.links_map[f"right_{n}_link"].pose.p.numpy() for n in ("five", "three"))
        center = five.copy()
        center[:, 2] = np.maximum(five[:, 2], three[:, 2]) + 0.12 + 0.007
        _put(jb, tb, "box", np.concatenate([center, quat], 1))
        obj, links = ("box", ("right_five_link", "right_three_link", "right_palm_link"))
    zero = np.zeros((B, 25), np.float32)
    _, jrew, _, _, jinfo = je.step(zero)
    _, rew, _, _, info = te.step(torch.as_tensor(zero))
    np.testing.assert_allclose(tb.scene.data.qpos.numpy(), np.asarray(jb.scene.data.qpos), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=0, atol=1e-4)
    tf, jf = _forces(tb, links, getattr(tb, obj)), _forces(jb, links, getattr(jb, obj))
    np.testing.assert_allclose(tf, jf, rtol=1e-4, atol=1e-3)
    assert np.linalg.norm(jf, axis=-1).sum(0).min() > 1.0, "the hand does not touch the object"
    if obj == "apple":
        np.testing.assert_array_equal(info["is_grasped"].numpy(), np.asarray(jinfo["is_grasped"]))
        np.testing.assert_array_equal(tb.agent._hand_is_grasping("right", tb.apple).numpy(),
                                      np.asarray(jb.agent._hand_is_grasping("right", jb.apple)))
        np.testing.assert_allclose(tb.agent.right_hand_dist_to_open_grasp().numpy(),
                                   np.asarray(jb.agent.right_hand_dist_to_open_grasp()), rtol=0, atol=1e-5)
    else:
        for side in ("left", "right"):
            np.testing.assert_allclose(tb._hand_contact_force(side).numpy(),
                                       np.asarray(jb._hand_contact_force(side)), rtol=1e-4, atol=1e-3)
        for k in ("box_grasped", "right_hand_hit_box", "left_hand_hit_box", "success"):
            np.testing.assert_array_equal(info[k].numpy(), np.asarray(jinfo[k]), err_msg=k)
