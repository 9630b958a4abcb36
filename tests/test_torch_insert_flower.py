"""The port's InsertFlower-v1 and the floating Panda gripper against the
JAX package's, at 4 envs on the CPU.

One JAX env (its solver's bf16 cast made an identity) starts from its state
after the reset inside ``make``; the port's env starts from the same state.
Both take 20 scripted ``pd_joint_delta_pos`` steps computed from the JAX
env's state: the root moves the TCP to the flower's stem (clipped to the
controller's 0.1 m per step), the gripper stays open for 12 steps and then
closes. All 20 steps are held (qpos within 3.6e-6 at the 20th): obs and
the normalized dense reward within 1e-4, success and terminated equal,
``contact.overflow == 0`` on both sides. The models are equal before any
step.

``is_grasping`` goes through ``scene.get_pairwise_contact_forces`` for each
finger and the angle of that force to the finger's closing direction. The
gripper closes on the stem with only ~0.25 N per finger (its drive target
is clamped at the joints' lower limit 0, and the 8 mm stem stops it at
4 mm), so at the last step both packages find no grasp at the default
0.5 N and a grasp in every env at 0.1 N.
"""
import numpy as np
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.agents.robots.floating_panda_gripper import floating_panda_gripper as fpg

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_tree_close, f32_reference_solver, one_torch_thread, tree,
)

B = 4
STEPS = 20
CLOSE_AT = 12
KW = dict(num_envs=B, obs_mode="state_dict", control_mode="pd_joint_delta_pos")


def _action(jb, i):
    """Move the TCP onto the stem (2 mm below the flower's origin), the
    gripper open until ``CLOSE_AT`` and closed after."""
    target = np.asarray(jb.flower.pose.p) + np.float32([0, 0, -0.002])
    a = np.zeros((B, 7), np.float32)
    a[:, :3] = np.clip((target - np.asarray(jb.agent.tcp_pose.p)) / 0.1, -1, 1)
    a[:, 6] = 1.0 if i < CLOSE_AT else -1.0
    return a


def test_rollout_and_grasp_match_reference(f32_reference_solver):
    je = jmake("InsertFlower-v1", **KW)
    jb = je.unwrapped
    te = tmake("InsertFlower-v1", device="cpu", **KW)
    tb = te.unwrapped
    trobot, jrobot = tb.agent.robot, jb.agent.robot
    assert [j.name for j in trobot.active_joints] == fpg.ROOT_JOINTS + fpg.GRIPPER_JOINTS
    assert [link.name for link in trobot.links] == [link.name for link in jrobot.links]
    assert_models_equal(tb.scene.model, jb.scene.model)

    state = tree(jb.get_state_dict(), np.array)
    obs0, _ = te.reset(seed=3, options=dict(reset_to_env_states=tree(state, torch.as_tensor)))
    assert_tree_close(obs0, tree(jb._init_raw_obs, np.asarray), 1e-6, "reset")
    for i in range(STEPS):
        action = _action(jb, i)
        jobs, jrew, jterm, _, jinfo = je.step(action)
        obs, reward, terminated, _, info = te.step(torch.as_tensor(action))
        assert tb.scene.data.contact.overflow.tolist() == [0] * B
        assert np.asarray(jb.scene.data.contact.overflow).tolist() == [0] * B
    assert_tree_close(obs, tree(jobs, np.asarray), 1e-4, "InsertFlower-v1")
    np.testing.assert_allclose(reward.numpy(), np.asarray(jrew), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(terminated.numpy(), np.asarray(jterm))
    np.testing.assert_array_equal(info["success"].numpy(), np.asarray(jinfo["success"]))
    np.testing.assert_allclose(tb.scene.data.qpos.numpy(), np.asarray(jb.scene.data.qpos), rtol=0, atol=1e-5)
    # the TCP reached the stem
    assert np.abs(np.asarray(jb.agent.tcp_pose.p) - np.asarray(jb.flower.pose.p)).max() < 0.01

    for min_force, want in ((0.5, False), (0.1, True)):
        jg = np.asarray(jb.agent.is_grasping(jb.flower, min_force=min_force))
        tg = tb.agent.is_grasping(tb.flower, min_force=min_force).numpy()
        np.testing.assert_array_equal(tg, jg)
        assert tg.tolist() == [want] * B, (min_force, tg)
    for link in ("finger1_link", "finger2_link"):
        jf = np.asarray(jb.scene.get_pairwise_contact_forces(getattr(jb.agent, link), jb.flower))
        tf = tb.scene.get_pairwise_contact_forces(getattr(tb.agent, link), tb.flower).numpy()
        np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-3)
        assert (np.linalg.norm(jf, axis=-1) > 0.1).all()


def test_vase_and_flower_build():
    """The vase is one static actor of 8 box staves and a cylinder floor
    (the staves drawn, the floor not); the flower a capsule stem and a
    sphere head, both drawn."""
    from maniskill_tpu_torch.physics.types import BOX, CAPSULE, CYLINDER, SPHERE, STATIC

    tb = tmake("InsertFlower-v1", num_envs=2, device="cpu").unwrapped
    geoms = tb.scene.mb.geoms
    assert tb.vase.body_type == STATIC
    vase = [g for g in geoms if g.name.startswith("vase_")]
    assert sorted((g.type, g.visual) for g in vase) == sorted([(BOX, False)] * 8 + [(BOX, True)] * 8
                                                               + [(CYLINDER, False)])
    flower = [geoms[g] for g in tb.flower.geom_ids]
    assert [g.name.split("_")[0] for g in flower] == ["flower"] * 4
    assert sorted((g.type, g.visual) for g in flower) == sorted([(CAPSULE, False), (CAPSULE, True),
                                                                 (SPHERE, False), (SPHERE, True)])
