"""The port's DM-control locomotion tasks (MS-Hopper*, MS-Ant*, MS-Humanoid*)
against the JAX package's, at 4 envs on the CPU.

One JAX env per robot (HopperStand, AntWalk, HumanoidStand), its solver's
bf16 cast made an identity, is stepped from its state after the reset inside
``make`` with seeded random ``pd_joint_delta_pos`` actions. Each port env
starts from that state (``reset_to_env_states``) and takes the same actions:
obs within 1e-4, reward within 1e-4, terminated equal, the full qpos (the
free or planar root included) and every body's ``cvel`` within 1e-4,
``contact.overflow == 0`` on both sides, and the bodies moving. Before any
step the two models are equal (pairs, topology, tables), the links and joints
have the same names in the same order, and after the reset qpos equals the
JAX env's exactly (the FREE root's qpos[:7] included), every body's cvel and
the obs within 1e-6.

The variants that differ from their robot's JAX env only in reward terms
(HopperHop, AntRun, HumanoidWalk/Run and the three Hard variants) are held
to the JAX env's own reward methods on its final state, called as the
variant's (``HumanoidWalk.compute_normalized_dense_reward(jax_env, ...)``;
AntRun's with ``move_speed`` set to its run speed); the Hard variants' obs
add the torso's velocities to the JAX obs, and they have no fall test.

How many control steps each robot takes is as many as stay within round-off
of the 1e-4 tolerance with these actions, and no more: the bodies fall,
kick and tumble, so the packages' f32 round-off grows each step.
- Hopper: 6 steps (obs within 3.3e-5 over 9 steps; the 10th step's toe
  contact force parts by 3.3e-4 in log1p).
- Ant: 6 steps (within 2.1e-5 over 10).
- Humanoid: 1 step. Its multi-axis joints are chains of 1e-4 kg dummy
  bodies with 1e-8 inertias, so the joint-space mass matrix is badly scaled
  and qvel parts by 4.9e-5 after one step and 2.1e-4 after two (max |qvel|
  15-18 rad/s, so ~1e-5 relative).
"""
import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.envs.tasks.control import humanoid as jhumanoid
from maniskill_tpu.envs.tasks.control.hopper import HopperHopEnv as JaxHopperHop
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_tree_close, f32_reference_solver, one_torch_thread, port_rollout,
    reference_rollout,
)

B = 4
KW = dict(num_envs=B, obs_mode="state_dict", control_mode="pd_joint_delta_pos")
STEPS = {"MS-HopperStand-v1": 6, "MS-AntWalk-v1": 6, "MS-HumanoidStand-v1": 1}


def _ant_run_reward(jb, obs, action, info):
    walk = jb.move_speed
    jb.move_speed = 4.0  # the run speed of MS-AntRun-v1
    try:
        return jb.compute_normalized_dense_reward(obs, action, info)
    finally:
        jb.move_speed = walk


def _method(cls):
    return lambda jb, obs, action, info: cls.compute_normalized_dense_reward(jb, obs, action, info)


# port env id -> (its robot's JAX env, the JAX reward of the variant or None
# for the JAX env's own, whether it is a Hard variant)
CASES = {
    "MS-HopperStand-v1": ("MS-HopperStand-v1", None, False),
    "MS-HopperHop-v1": ("MS-HopperStand-v1", lambda jb, o, a, i: JaxHopperHop.compute_dense_reward(jb, o, a, i),
                        False),
    "MS-AntWalk-v1": ("MS-AntWalk-v1", None, False),
    "MS-AntRun-v1": ("MS-AntWalk-v1", _ant_run_reward, False),
    "MS-HumanoidStand-v1": ("MS-HumanoidStand-v1", None, False),
    "MS-HumanoidWalk-v1": ("MS-HumanoidStand-v1", _method(jhumanoid.HumanoidWalk), False),
    "MS-HumanoidRun-v1": ("MS-HumanoidStand-v1", _method(jhumanoid.HumanoidRun), False),
    "MS-HumanoidStandHard-v1": ("MS-HumanoidStand-v1", _method(jhumanoid.HumanoidStandHard), True),
    "MS-HumanoidWalkHard-v1": ("MS-HumanoidStand-v1", _method(jhumanoid.HumanoidWalkHard), True),
    "MS-HumanoidRunHard-v1": ("MS-HumanoidStand-v1", _method(jhumanoid.HumanoidRunHard), True),
}


@pytest.fixture(scope="module")
def reference(f32_reference_solver):
    """``reference(env_id)``: (JAX env, its rollout), made once per robot."""
    runs = {}

    def get(env_id):
        if env_id not in runs:
            je = jmake(env_id, **KW)
            runs[env_id] = (je, reference_rollout(je, STEPS[env_id]))
        return runs[env_id]

    return get


@pytest.mark.parametrize("env_id", list(CASES))
def test_task_matches_reference(env_id, reference):
    ref_id, variant_reward, hard = CASES[env_id]
    je, ref = reference(ref_id)
    jb = je.unwrapped
    te = tmake(env_id, device="cpu", **KW)
    tb = te.unwrapped
    assert [j.name for j in tb.agent.robot.active_joints] == [j.name for j in jb.agent.robot.active_joints]
    assert [link.name for link in tb.agent.robot.links] == [link.name for link in jb.agent.robot.links]
    assert_models_equal(tb.scene.model, jb.scene.model)

    out = port_rollout(te, ref)
    # the reset: qpos (the root's 7 included) equal, every body's cvel and
    # the obs within round-off of the JAX env's
    np.testing.assert_array_equal(out["qpos0"].numpy(), ref["qpos0"])
    np.testing.assert_allclose(out["cvel0"].numpy(), ref["cvel0"], rtol=0, atol=1e-6)
    # (a Hard variant's obs adds the torso's velocities, checked after the steps)
    assert_tree_close({k: v for k, v in out["obs0"].items() if k in ref["obs0"]}, ref["obs0"], 1e-6,
                      f"{env_id} reset")
    tobs, trew, tterm = out["obs"], out["reward"], out["terminated"]
    jobs = dict(ref["obs"])
    if hard:
        torso = jb.agent.robot.links_map["torso"]
        jobs.update(root_vel=np.asarray(torso.linear_velocity), root_quat_vel=np.asarray(torso.angular_velocity))
    assert_tree_close(tobs, jobs, 1e-4, env_id)
    jrew = ref["reward"]
    if variant_reward is not None:
        jlast_obs, jlast_info = ref["last"]
        jrew = np.asarray(variant_reward(jb, jlast_obs, ref["actions"][-1], jlast_info))
    np.testing.assert_allclose(trew.numpy(), jrew, rtol=0, atol=1e-4)
    jterm = np.zeros(B, bool) if hard else ref["terminated"]
    np.testing.assert_array_equal(tterm.numpy(), jterm)
    data, jdata = tb.scene.data, jb.scene.data
    np.testing.assert_allclose(data.qpos.numpy(), np.asarray(jdata.qpos), rtol=0, atol=1e-4)
    np.testing.assert_allclose(data.cvel.numpy(), np.asarray(jdata.cvel), rtol=0, atol=1e-4)
    assert data.contact.overflow.tolist() == [0] * B
    assert np.asarray(jdata.contact.overflow).tolist() == [0] * B
    assert np.abs(np.asarray(jdata.qvel)).max() > 0.1, "nothing moved"


@pytest.mark.parametrize("env_id", ["MS-HopperHop-v1", "MS-HumanoidStand-v1", "MS-HumanoidWalkHard-v1"])
def test_reset_draws(env_id):
    """The port's own reset draws: the hopper's joints inside their limits
    (clipped to [-pi, pi]) with the sliders at 0; the humanoid's root at
    1.3 m with a yaw-only quaternion; the Hard humanoid's joints uniform
    inside ``qlimits``, its root at 1.5 m with a random unit quaternion."""
    te = tmake(env_id, device="cpu", **dict(KW, num_envs=16))
    te.reset(seed=0)
    robot = te.unwrapped.agent.robot
    qpos, lim = robot.qpos, robot.qlimits
    assert lim.shape == (16, robot.dof, 2)
    assert bool((qpos >= torch.clamp(lim[..., 0], min=-np.pi) - 1e-6).all())
    assert bool((qpos <= torch.clamp(lim[..., 1], max=np.pi) + 1e-6).all())
    if env_id.startswith("MS-Hopper"):
        assert qpos[:, :2].abs().max().item() == 0.0
        return
    root = robot.root_pose.raw_pose
    np.testing.assert_allclose(root[:, 3:].norm(dim=-1).numpy(), 1.0, atol=1e-6)
    if env_id == "MS-HumanoidStand-v1":
        np.testing.assert_allclose(root[:, 2].numpy(), 1.3)
        assert root[:, 4:6].abs().max().item() == 0.0
        assert qpos.abs().max().item() <= 1e-2
    else:
        np.testing.assert_allclose(root[:, 2].numpy(), 1.5)
        assert root[:, 4:6].abs().max().item() > 0.1
        assert (qpos.std(0) > 0).all()
    assert len(torch.unique(root[:, 3])) == 16
