"""The port's arm robots, ``pd_joint_pos_vel`` and per-env friction against
the JAX package's, on the CPU (no JAX env: nothing is compiled).

- The 13 robots of the arm slice, built in a bare scene of each package:
  their models are equal, their links and joints named in the same order,
  their keyframes equal and of the robot's dof, and every control mode's
  action space has the same bounds.
- ``pd_joint_pos_vel`` on an SO100 of each package from one state, with the
  same actions (absolute and normalized, absolute and raw, delta, delta on
  the previous target): the drive targets and velocity targets are equal.
- ``scene.set_per_env_friction`` on a cube resting on the ground: the
  friction tables are equal, and the port's contact rows carry the mean of
  the cube's per-env friction and the ground's.
"""
import numpy as np
import pytest
import torch

import maniskill_tpu.agents.robots  # noqa: F401
from maniskill_tpu.agents import controllers as jctrl
from maniskill_tpu.agents.registration import get_agent_class as jagent
from maniskill_tpu.building import actors as jactors
from maniskill_tpu.building.ground import build_ground as jground
from maniskill_tpu.envs.scene import ManiSkillScene as JaxScene
from maniskill_tpu.physics import types as jtypes

import maniskill_tpu_torch.agents.robots  # noqa: F401
from maniskill_tpu_torch import physics as tphys
from maniskill_tpu_torch.agents import controllers as tctrl
from maniskill_tpu_torch.agents.registration import get_agent_class as tagent
from maniskill_tpu_torch.building import actors as tactors
from maniskill_tpu_torch.building.ground import build_ground as tground
from maniskill_tpu_torch.envs.scene import ManiSkillScene as TorchScene
from maniskill_tpu_torch.physics.collision import collide

from test_torch_common import assert_models_equal, one_torch_thread  # noqa: F401

B = 3
POSE = np.array([0.1, -0.2, 0.3, 1, 0, 0, 0])
ARM_UIDS = ["so100", "widowxai", "widowxai_wristcam", "xarm6_nogripper", "xarm6_robotiq", "xarm6_robotiq_wristcam",
            "xarm6_nogripper_wristcam", "ur_10e", "koch-v1.1", "googlerobot", "stompy",
            "floating_robotiq_2f_85_gripper", "xlerobot"]


def _build(scene_cls, agent_cls, **kw):
    scene = scene_cls(num_envs=B, **kw)
    agent = agent_cls(scene, initial_pose=POSE)
    scene.finalize()
    return scene, agent


@pytest.mark.parametrize("uid", ARM_UIDS)
def test_arm_builds_like_reference(uid):
    jscene, ja = _build(JaxScene, jagent(uid))
    tscene, ta = _build(TorchScene, tagent(uid), device="cpu")
    assert_models_equal(tscene.model, jscene.model)
    assert tscene.model.geom_names == tuple(jscene.model.geom_names)
    assert [link.name for link in ta.robot.links] == [link.name for link in ja.robot.links]
    assert [j.name for j in ta.robot.active_joints] == [j.name for j in ja.robot.active_joints]
    assert ta.robot.dof == ja.robot.dof
    assert list(ta.keyframes) == list(ja.keyframes)
    for name, kf in ta.keyframes.items():
        np.testing.assert_array_equal(kf.qpos, ja.keyframes[name].qpos, err_msg=name)
        np.testing.assert_array_equal(kf.pose, ja.keyframes[name].pose, err_msg=name)
        assert np.asarray(kf.qpos).reshape(-1).shape[0] == ta.robot.dof, name
    assert ta.supported_control_modes == ja.supported_control_modes
    for mode in ta.supported_control_modes:
        ta.set_control_mode(mode)
        ja.set_control_mode(mode)
        tspace, jspace = ta.single_action_space, ja.single_action_space
        np.testing.assert_array_equal(tspace.low, jspace.low, err_msg=mode)
        np.testing.assert_array_equal(tspace.high, jspace.high, err_msg=mode)
    tsensors = [c.uid for c in getattr(ta, "_sensor_configs", [])]
    assert tsensors == [c.uid for c in getattr(ja, "_sensor_configs", [])]


# pd_joint_pos_vel configurations: (use_delta, use_target, normalize_action,
# position bounds)
POS_VEL_MODES = {
    "abs_normalized": (False, False, True, None),
    "abs_raw": (False, False, False, None),
    "delta": (True, False, True, 0.1),
    "target_delta": (True, True, True, 0.1),
}


def _pos_vel_agent(base_cls, ctrl):
    """``base_cls`` (a package's SO100) with one pd_joint_pos_vel mode per
    entry of POS_VEL_MODES."""

    class PosVelSO100(base_cls):
        @property
        def _controller_configs(self):
            joints = [j.name for j in self.robot.active_joints]
            out = {}
            for mode, (delta, target, norm, bound) in POS_VEL_MODES.items():
                lo, hi = (None, None) if bound is None else (-bound, bound)
                out[mode] = dict(arm=ctrl.PDJointPosVelControllerConfig(
                    joint_names=joints, lower=lo, upper=hi, stiffness=1e3, damping=1e2, force_limit=100,
                    use_delta=delta, use_target=target, normalize_action=norm, vel_lower=-2.0,
                    vel_upper=[1.0, 2.0, 3.0, 1.5, 0.5, 1.0]))
            return out

    return PosVelSO100


@pytest.mark.parametrize("mode", list(POS_VEL_MODES))
def test_pd_joint_pos_vel_matches_reference(mode):
    import jax.numpy as jnp

    jscene, ja = _build(JaxScene, _pos_vel_agent(jagent("so100"), jctrl))
    tscene, ta = _build(TorchScene, _pos_vel_agent(tagent("so100"), tctrl), device="cpu")
    rng = np.random.default_rng(3)
    qpos = rng.uniform(-1, 1, (B, tscene.model.nq)).astype(np.float32)
    target = rng.uniform(-1, 1, (B, tscene.model.nv)).astype(np.float32)
    jdata = jtypes.make_data(jscene.model, B)
    jscene.data = jdata.replace(qpos=jnp.asarray(qpos), drive_target=jnp.asarray(target))
    tdata = tphys.make_data(tscene.model, B)
    tscene.bind(tdata.replace(qpos=torch.as_tensor(qpos), drive_target=torch.as_tensor(target)))
    ta.set_control_mode(mode)
    ja.set_control_mode(mode)
    jspace, tspace = ja.single_action_space, ta.single_action_space
    assert tspace.shape == jspace.shape == (12,)
    np.testing.assert_array_equal(tspace.low, jspace.low)
    np.testing.assert_array_equal(tspace.high, jspace.high)
    for k in range(2):
        action = rng.uniform(jspace.low, jspace.high, (B, 12)).astype(np.float32) * 1.3  # some clipped
        ja.set_action(jnp.asarray(action))
        ta.set_action(torch.as_tensor(action))
        for f in ("drive_target", "drive_vel_target"):
            np.testing.assert_allclose(getattr(tscene.data, f).numpy(), np.asarray(getattr(jscene.data, f)),
                                       rtol=0, atol=1e-6, err_msg=f"{mode} {f} {k}")
    assert np.abs(np.asarray(jscene.data.drive_vel_target)).max() > 0.1


@pytest.mark.parametrize("uid", ["so100", "widowxai"])
def test_arms_offer_no_pos_vel_mode(uid):
    """No JAX robot offers pd_joint_pos_vel, so the arms refuse it as they
    refuse any mode they lack, naming it."""
    _, ta = _build(TorchScene, tagent(uid), device="cpu")
    with pytest.raises(NotImplementedError, match="pd_joint_pos_vel"):
        ta.set_control_mode("pd_joint_pos_vel")


def _friction_scene(scene_cls, build_ground, actors, **kw):
    scene = scene_cls(num_envs=B, **kw)
    build_ground(scene)
    cube = actors.build_cube(scene, half_size=0.02, color=[1, 0, 0, 1], name="cube",
                             initial_pose=np.array([0, 0, 0.0199, 1, 0, 0, 0]))
    scene.finalize()
    return scene, cube


def test_set_per_env_friction_reaches_contact_rows():
    fric = np.array([0.1, 0.35, 0.5], np.float32)
    jscene, jcube = _friction_scene(JaxScene, jground, jactors)
    tscene, tcube = _friction_scene(TorchScene, tground, tactors, device="cpu")
    ground_f = float(tscene.model.geom_friction[0])
    jscene.set_per_env_friction(jcube, fric)
    tscene.set_per_env_friction(tcube, fric)
    assert tuple(tscene.model.geom_friction.shape) == (B, tscene.model.ngeom)
    np.testing.assert_array_equal(tscene.model.geom_friction.numpy(), np.asarray(jscene.model.geom_friction))

    model = tscene.model
    qpos0 = tphys.default_qpos(model)
    qa = int(model.body_q_adr[tcube.body_id])
    qpos0[qa:qa + 7] = [0, 0, 0.0199, 1, 0, 0, 0]
    data = tphys.forward(model, tphys.make_data(model, B, qpos0))
    contact = collide(model, data)
    geoms = set(tcube.geom_ids.tolist())
    rows = np.nonzero(np.isin(np.asarray(contact.geom1), list(geoms))
                      | np.isin(np.asarray(contact.geom2), list(geoms)))[0]
    live = contact.depth.numpy()[:, rows] > 0
    assert live.all(axis=1).any() and live.any(axis=1).all(), "the cube does not rest on the ground"
    want = 0.5 * (fric[:, None] + ground_f)
    got = contact.friction.numpy()[:, rows]
    np.testing.assert_allclose(got[live], np.broadcast_to(want, got.shape)[live], rtol=0, atol=1e-7)
