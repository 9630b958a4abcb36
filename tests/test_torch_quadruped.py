"""The port's quadruped tasks (AnymalC-Reach-v1, UnitreeGo2-Reach-v1,
AnymalC-Spin-v1) and its URDF-loaded robots ANYmal C and Go2 against the
JAX package's, at 4 envs on the CPU.

One JAX env per robot (AnymalC-Reach, UnitreeGo2-Reach), its solver's bf16
cast made an identity, takes one settling zero-action step from its state
after the reset inside ``make`` and then seeded random ``pd_joint_delta_pos``
steps. The port's env starts from the same state (the contact solver warm
starts from the last step's impulses, which a state dict does not carry, so
both start cold) and takes the same actions: obs within 1e-4, reward within 1e-4, terminated and success equal,
the full qpos (the FREE root's 7 included) and every body's ``cvel`` within
1e-4, ``contact.overflow == 0`` on both sides, and the bodies moving. Before
any step the models are equal and the links and joints have the same names
in the same (depth-first) order; the keyframes name their qpos in that
order. AnymalC-Spin-v1 differs from AnymalC-Reach-v1 in its obs, reward and
end test, so it is held to the Reach JAX env's rollout through the JAX
package's Spin reward (``QuadrupedSpinEnv.compute_dense_reward(jax_env,
...) / 2``), its obs to the Reach obs's agent and root velocity leaves.

How many control steps each robot takes is as many as stay within round-off
of the 1e-4 tolerance with these actions, and no more: the robots sag and
stumble under random delta targets (two ANYmal envs fall within 10 steps).
- ANYmal C: the settling step and 6 more.
- Go2: the settling step and 4 more (its stiff 1000 N m/rad gains amplify
  round-off).

``Articulation.get_net_contact_forces`` after the settling step: the port's
(B, 17, 3) per-link forces equal the JAX package's within 1e-4 N (5.3e-5 N
apart on feet carrying ~88 N each), and equal the per-link
``net_contact_forces_for_bodies`` calls they replace.
"""
import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.envs.tasks.quadruped.quadruped_spin import QuadrupedSpinEnv as JaxSpin
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.agents.robots.anymal import anymal_c
from maniskill_tpu_torch.agents.robots.unitree_go import unitree_go2

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_tree_close, f32_reference_solver, one_torch_thread, port_rollout,
    reference_rollout, tree,
)

B = 4
KW = dict(num_envs=B, obs_mode="state_dict", control_mode="pd_joint_delta_pos")
STEPS = {"AnymalC-Reach-v1": 6, "UnitreeGo2-Reach-v1": 4}


@pytest.fixture(scope="module")
def reference(f32_reference_solver):
    """``reference(env_id)``: (JAX env, its rollout whose first step settles
    with a zero action, after which the per-link net contact forces are
    read), made once per robot."""
    runs = {}

    def get(env_id):
        if env_id not in runs:
            je = jmake(env_id, **KW)
            runs[env_id] = (je, reference_rollout(
                je, 1 + STEPS[env_id], first_action=0.0,
                after_first=lambda jb: np.asarray(jb.agent.robot.get_net_contact_forces())))
        return runs[env_id]

    return get


def _check_common(tb, jb, ref):
    """The robot's state (root pose and velocities, qpos, qvel) and its
    links' cvel within 1e-4; no overflow; the bodies moved."""
    data, jdata = tb.scene.data, jb.scene.data
    trobot, jrobot = tb.agent.robot, jb.agent.robot
    np.testing.assert_allclose(trobot.get_state().numpy(), np.asarray(jrobot.get_state()), rtol=0, atol=1e-4)
    tids, jids = [link.body_id for link in trobot.links], [link.body_id for link in jrobot.links]
    np.testing.assert_allclose(data.cvel[:, tids].numpy(), np.asarray(jdata.cvel)[:, jids], rtol=0, atol=1e-4)
    assert data.contact.overflow.tolist() == [0] * B
    assert np.asarray(jdata.contact.overflow).tolist() == [0] * B
    assert np.abs(np.asarray(jdata.qvel)).max() > 0.1, "nothing moved"


@pytest.mark.parametrize("env_id", list(STEPS))
def test_task_matches_reference(env_id, reference):
    je, ref = reference(env_id)
    jb = je.unwrapped
    te = tmake(env_id, device="cpu", **KW)
    tb = te.unwrapped
    assert [j.name for j in tb.agent.robot.active_joints] == [j.name for j in jb.agent.robot.active_joints]
    assert [link.name for link in tb.agent.robot.links] == [link.name for link in jb.agent.robot.links]
    assert_models_equal(tb.scene.model, jb.scene.model)

    out = port_rollout(te, ref)
    np.testing.assert_array_equal(out["qpos0"].numpy(), ref["qpos0"])
    np.testing.assert_allclose(out["cvel0"].numpy(), ref["cvel0"], rtol=0, atol=1e-6)
    assert_tree_close(out["obs0"], ref["obs0"], 1e-6, f"{env_id} reset")
    assert_tree_close(out["obs"], ref["obs"], 1e-4, env_id)
    np.testing.assert_allclose(out["reward"].numpy(), ref["reward"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out["terminated"].numpy(), ref["terminated"])
    np.testing.assert_array_equal(out["info"]["success"].numpy(), ref["info"]["success"])
    _check_common(tb, jb, ref)
    # the base camera rides on the floating base
    for key, v in tb._sensors["base_camera"].get_params().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jb._sensors["base_camera"].get_params()[key]),
                                   rtol=0, atol=1e-4, err_msg=key)


def test_spin_matches_reference(reference):
    je, ref = reference("AnymalC-Reach-v1")
    jb = je.unwrapped
    te = tmake("AnymalC-Spin-v1", device="cpu", **KW)
    tb = te.unwrapped
    # the Reach env's model has the goal sphere besides (kinematic, no
    # collision); the Spin env starts from the Reach state without it
    state = dict(ref["state"], actors={})
    out = port_rollout(te, dict(ref, state=state))
    jobs = dict(agent=ref["obs"]["agent"], extra={k: ref["obs"]["extra"][k] for k in
                                                  ("root_linear_velocity", "root_angular_velocity")})
    assert_tree_close(out["obs"], jobs, 1e-4, "AnymalC-Spin-v1")
    jlast_obs, jlast_info = ref["last"]
    # (the normalized reward is the dense one over 2; called on the Reach
    # env, Spin's normalizing method would dispatch to Reach's dense reward)
    jrew = np.asarray(JaxSpin.compute_dense_reward(jb, jlast_obs, ref["actions"][-1], jlast_info)) / 2.0
    np.testing.assert_allclose(out["reward"].numpy(), jrew, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out["terminated"].numpy(), ref["info"]["fail"])
    assert "success" not in out["info"]
    _check_common(tb, jb, ref)


def test_net_contact_forces_match_reference(reference):
    """Per-link net contact forces of AnymalC-Reach after one zero-action
    step from the JAX env's reset state."""
    _, ref = reference("AnymalC-Reach-v1")
    jforces = ref["after_first"]
    te = tmake("AnymalC-Reach-v1", device="cpu", **KW)
    tb = te.unwrapped
    te.reset(seed=3, options=dict(reset_to_env_states=tree(ref["state"], torch.as_tensor)))
    te.step(torch.zeros(B, 12))
    robot = tb.agent.robot
    forces = robot.get_net_contact_forces()
    assert forces.shape == (B, len(robot.links), 3)
    np.testing.assert_allclose(forces.numpy(), jforces, rtol=0, atol=1e-4)
    assert np.abs(jforces[..., 2]).max() > 50.0  # the feet carry the robot
    per_link = torch.stack([tb.scene.net_contact_forces_for_bodies([link.body_id]) for link in robot.links], 1)
    np.testing.assert_allclose(forces.numpy(), per_link.numpy(), rtol=0, atol=1e-5)
    names = ["LF_SHANK", "RH_SHANK", "base"]
    some = robot.get_net_contact_forces(names)
    np.testing.assert_array_equal(some.numpy(), forces[:, [robot.links.index(robot.links_map[n]) for n in names]])


def test_keyframes_and_joint_order():
    """The robots' joint lists are the loader's depth-first order, which the
    keyframes' qpos follow (leg by leg); the keyframe stands the robot."""
    for env_id, mod, n in (("AnymalC-Reach-v1", anymal_c, 12), ("UnitreeGo2-Reach-v1", unitree_go2, 12)):
        te = tmake(env_id, device="cpu", **dict(KW, num_envs=2))
        te.reset(seed=0)
        robot = te.unwrapped.agent.robot
        assert [j.name for j in robot.active_joints] == mod.JOINT_NAMES and robot.dof == n
        kf = te.unwrapped.agent.keyframes["standing"]
        np.testing.assert_allclose(robot.qpos.numpy(), np.broadcast_to(kf.qpos, (2, n)), atol=1e-6)
        np.testing.assert_allclose(robot.root_pose.raw_pose.numpy(), np.broadcast_to(kf.pose, (2, 7)), atol=1e-6)


def test_mounted_camera_follows_the_base():
    """AnymalC-Reach rgb on the CPU (the kernel's plain version): the base
    camera's pose is the base's pose times its mount offset in every env,
    after the base has moved, and the frame shows the green goal sphere
    ahead (the rest of the frame is background, as in the JAX package)."""
    te = tmake("AnymalC-Reach-v1", num_envs=2, obs_mode="rgb+segmentation", control_mode="pd_joint_delta_pos",
               device="cpu")
    tb = te.unwrapped
    te.reset(seed=0)
    p0 = tb.agent.robot.pose.raw_pose.clone()
    for _ in range(2):
        obs, *_ = te.step(torch.ones(2, 12))
    base = tb.agent.robot.pose
    assert (base.raw_pose - p0).abs().max().item() > 1e-3
    cam = tb._sensors["base_camera"]
    want = base * cam.config.pose
    np.testing.assert_allclose(cam.world_pose().raw_pose.numpy(), want.raw_pose.numpy(), atol=1e-6)
    rgb = obs["sensor_data"]["base_camera"]["rgb"]
    assert tuple(rgb.shape) == (2, 128, 128, 3) and rgb.dtype == torch.uint8
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    green = ((g > r + 50) & (g > b + 50)).sum((1, 2))
    goal = (obs["sensor_data"]["base_camera"]["segmentation"][..., 0] == tb.goal.per_scene_id).sum((1, 2))
    assert (green > 20).all() and torch.equal(green, goal), (green, goal)
