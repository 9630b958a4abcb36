"""The port's dexterous hands and the xArm7 robots against the JAX
package's, on the CPU.

- Empty-v1 with ``floating_inspire_hand_right`` (``pd_joint_delta_pos``)
  and with ``xarm7_ability`` (``pd_ee_delta_pose``: the batched IK on the
  arm, its end link the hand's "base"): one JAX env each at 2 envs, its
  solver's bf16 cast made an identity. The models are equal, the links and
  joints have the same names in the same (depth-first) order, and from the
  JAX env's state after the reset inside ``make`` both packages take a
  zero-action step and one seeded random step (held: both; the obs part by
  ~1e-5 at the 2nd and ~6e-5 at the 4th): obs within 1e-4, qpos within
  1e-5, ``contact.overflow == 0``.
- The other robots this slice adds, built in a bare scene of each package
  (no env, so nothing compiles): ``allegro_hand_right`` and ``_left``,
  ``floating_ability_hand_right``, the three other Inspire hands, ``xarm7``,
  ``dclaw`` and ``floating_panda_gripper``. Their models are equal, their
  links and joints named in the same order, their keyframes equal and of
  the robot's dof, and every control mode's action space has the same
  bounds.
"""
import numpy as np
import pytest
import torch

import maniskill_tpu.agents.robots  # noqa: F401
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.agents.registration import get_agent_class as jagent
from maniskill_tpu.envs.scene import ManiSkillScene as JaxScene
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.agents.registration import get_agent_class as tagent
from maniskill_tpu_torch.envs.scene import ManiSkillScene as TorchScene

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_tree_close, f32_reference_solver, one_torch_thread, tree,
)

B = 2
POSE = np.array([0.1, -0.2, 0.3, 1, 0, 0, 0])


@pytest.mark.parametrize("uid,control_mode", [("floating_inspire_hand_right", "pd_joint_delta_pos"),
                                              ("xarm7_ability", "pd_ee_delta_pose")])
def test_empty_env_step_matches_reference(uid, control_mode, f32_reference_solver):
    kw = dict(num_envs=B, obs_mode="state_dict", robot_uids=uid, control_mode=control_mode)
    je = jmake("Empty-v1", **kw)
    jb = je.unwrapped
    te = tmake("Empty-v1", device="cpu", **kw)
    tb = te.unwrapped
    trobot, jrobot = tb.agent.robot, jb.agent.robot
    assert [j.name for j in trobot.active_joints] == [j.name for j in jrobot.active_joints]
    assert [link.name for link in trobot.links] == [link.name for link in jrobot.links]
    assert_models_equal(tb.scene.model, jb.scene.model)
    assert te.unwrapped.single_action_space.shape == jb.single_action_space.shape

    state = tree(jb.get_state_dict(), np.array)
    obs0, _ = te.reset(seed=3, options=dict(reset_to_env_states=tree(state, torch.as_tensor)))
    assert_tree_close(obs0, tree(jb._init_raw_obs, np.asarray), 1e-6, "reset")
    rng = np.random.default_rng(7)
    for i in range(2):
        action = rng.uniform(-1, 1, (B,) + jb.single_action_space.shape).astype(np.float32) * (i > 0)
        jobs, *_ = je.step(action)
        obs, *_ = te.step(torch.as_tensor(action))
        assert_tree_close(obs, tree(jobs, np.asarray), 1e-4, f"{uid} step {i + 1}")
        np.testing.assert_allclose(tb.scene.data.qpos.numpy(), np.asarray(jb.scene.data.qpos), rtol=0, atol=1e-5)
        assert tb.scene.data.contact.overflow.tolist() == [0] * B
        assert np.asarray(jb.scene.data.contact.overflow).tolist() == [0] * B
    assert np.abs(np.asarray(jb.scene.data.qvel)).max() > 0.1, "nothing moved"


def _build(scene_cls, agent_cls, **kw):
    scene = scene_cls(num_envs=B, **kw)
    agent = agent_cls(scene, initial_pose=POSE)
    scene.finalize()
    return scene, agent


@pytest.mark.parametrize("uid", ["allegro_hand_right", "allegro_hand_left", "floating_ability_hand_right",
                                 "floating_inspire_hand_left", "fixed_inspire_hand_right", "fixed_inspire_hand_left",
                                 "xarm7", "dclaw", "floating_panda_gripper"])
def test_robot_builds_like_reference(uid):
    jscene, ja = _build(JaxScene, jagent(uid))
    tscene, ta = _build(TorchScene, tagent(uid), device="cpu")
    assert_models_equal(tscene.model, jscene.model)
    assert tscene.model.geom_names == tuple(jscene.model.geom_names)
    assert [link.name for link in ta.robot.links] == [link.name for link in ja.robot.links]
    assert [j.name for j in ta.robot.active_joints] == [j.name for j in ja.robot.active_joints]
    assert ta.robot.dof == ja.robot.dof
    assert sorted(ta.keyframes) == sorted(ja.keyframes)
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
