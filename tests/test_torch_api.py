"""The rest of the port's public API against the JAX package's:

- ``Actor.apply_force`` and ``Actor.get_net_contact_forces`` on a scene with
  a world-anchored drive on the same cube: two applied forces (and a torque)
  sum into ``xfrc_applied`` exactly as the JAX package sums them; the first
  substep adds the drive's wrench and consumes them all; qpos after the
  substeps within 1e-5 and the cube's net contact force within 1e-4 N of
  the JAX package's.
- ``Pose.identity``, ``from_matrix``, ``transform_point``,
  ``to_transformation_matrix`` (tensor and host poses) and
  ``vectorize_pose`` within 1e-6; ``utils/common.py``'s ``to_numpy``,
  ``batch``, ``unbatch``, ``flatten_dict_keys``, ``append_dict_array`` and
  ``index_dict_array`` equal.
- Absolute end-effector targets (``use_delta=False``) in ``pd_ee_pos`` and
  ``pd_ee_pose`` modes, added to both Pandas' controller tables through
  pytest's MonkeyPatch: drive targets within 1e-4 after ``set_action`` and
  qpos within 1e-4 after 5 control steps, as tests/test_torch_pd_ee.py holds
  the delta modes.
- ``Empty-v1`` with ``robot_uids=None``. The JAX package returns from
  ``_load_agent`` but then calls the missing agent in ``_reset_impl``
  (maniskill_tpu/envs/base_env.py:413), so no robot-free env can be made
  there; the port repairs it (an empty action space and no agent calls).
  The JAX env is given a stand-in agent that does nothing, and both are
  held to the same model, observations and state; the JAX dynamics cannot
  step a model with no dofs (its blocked Cholesky stacks no blocks), the
  port's steps it.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu import physics as jphys
from maniskill_tpu.agents.robots.panda.panda import Panda as JPanda
from maniskill_tpu.envs.scene import ManiSkillScene as JScene
from maniskill_tpu.envs.tasks.empty_env import EmptyEnv as JEmptyEnv
from maniskill_tpu.structs import pose as jpose
from maniskill_tpu.utils import common as jcommon
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch import physics as tphys
from maniskill_tpu_torch.agents.robots.panda.panda import Panda as TPanda
from maniskill_tpu_torch.envs.scene import ManiSkillScene as TScene
from maniskill_tpu_torch.structs import pose as tpose
from maniskill_tpu_torch.utils import common as tcommon

from test_torch_common import f32_reference_solver, one_torch_thread, tree  # noqa: F401

B = 2


def _force_scene(scene):
    g = scene.create_actor_builder()
    g.add_plane_collision()
    g.build_static(name="ground")
    b = scene.create_actor_builder()
    b.add_box_collision(half_size=[0.02] * 3)
    b.set_initial_pose([0.0, 0.0, 0.02, 1, 0, 0, 0])
    cube = b.build(name="cube")
    drive = scene.create_drive(None, [0.0, 0.0, 0.06, 1, 0, 0, 0], cube, None, stiffness=(40.0, 1.0),
                               damping=(4.0, 0.1))
    return cube, drive


def test_apply_force_and_contact_forces_match_reference(f32_reference_solver):  # noqa: F811
    js, ts = JScene(num_envs=B), TScene(num_envs=B, device="cpu")
    (jcube, _), (tcube, _) = _force_scene(js), _force_scene(ts)
    jm, tm = js.finalize(), ts.finalize()
    js.bind(jphys.forward(jm, jphys.make_data(jm, B)))
    ts.bind(tphys.forward(tm, tphys.make_data(tm, B)))
    np.testing.assert_array_equal(ts.data.qpos.numpy(), np.asarray(js.data.qpos))

    per_env = np.array([[0.5, -0.25, 1.0], [0.0, 0.75, 2.0]], np.float32)
    for cube in (jcube, tcube):
        cube.apply_force([0.0, 0.0, 3.0])
        cube.apply_force(per_env, torque=[0.0, 0.01, 0.0])
    np.testing.assert_array_equal(ts.data.xfrc_applied.numpy(), np.asarray(js.data.xfrc_applied))
    assert np.allclose(ts.data.xfrc_applied[:, tcube.body_id, 2].numpy(), [4.0, 5.0])

    run = jax.jit(lambda d: jax.lax.scan(lambda d, _: (jphys.step(jm, d), None), d, None, length=5)[0])
    jd = run(js.data)
    d = ts.data
    d = tphys.step(tm, d)
    assert float(d.xfrc_applied.abs().max()) == 0.0  # consumed by the first substep
    for _ in range(4):
        d = tphys.step(tm, d)
    np.testing.assert_allclose(d.qpos.numpy(), np.asarray(jd.qpos), rtol=0, atol=1e-5)

    js.bind(jphys.forward(jm, jd))
    ts.bind(tphys.forward(tm, d))
    want = np.asarray(jcube.get_net_contact_forces())
    got = tcube.get_net_contact_forces().numpy()
    assert got.shape == (B, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_pose_helpers_match_reference():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(4, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    raw = np.concatenate([rng.normal(size=(4, 3)).astype(np.float32), q], -1)
    pts = rng.normal(size=(4, 3)).astype(np.float32)
    jp, tp = jpose.Pose(jnp.asarray(raw)), tpose.Pose(torch.as_tensor(raw))
    m = tp.to_transformation_matrix()
    np.testing.assert_allclose(m.numpy(), np.asarray(jp.to_transformation_matrix()), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tpose.Pose(raw).to_transformation_matrix(),
                               jpose.Pose(raw).to_transformation_matrix(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp.transform_point(torch.as_tensor(pts)).numpy(),
                               np.asarray(jp.transform_point(jnp.asarray(pts))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tpose.Pose(raw).transform_point(pts), jpose.Pose(raw).transform_point(pts),
                               rtol=0, atol=1e-6)
    back = tpose.Pose.from_matrix(m)
    np.testing.assert_allclose(back.raw_pose.numpy(), np.asarray(jpose.Pose.from_matrix(jnp.asarray(m.numpy())).raw_pose),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(back.to_transformation_matrix().numpy(), m.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tpose.Pose.identity((2, 3)).raw_pose.numpy(),
                                  np.asarray(jpose.Pose.identity((2, 3)).raw_pose))
    assert tpose.vectorize_pose(tp) is tp.raw_pose
    np.testing.assert_array_equal(tpose.vectorize_pose(raw), np.asarray(jpose.vectorize_pose(raw)))
    for t, j in ((tpose.Pose(raw), jpose.Pose(raw)), (tp, jp)):  # host and tensor poses
        np.testing.assert_array_equal(np.asarray(t.replace(p=[1.0, 2.0, 3.0]).raw_pose),
                                      np.asarray(j.replace(p=[1.0, 2.0, 3.0]).raw_pose))
        np.testing.assert_array_equal(np.asarray(t.set_p(q=raw[0, 3:]).raw_pose),
                                      np.asarray(j.set_p(q=raw[0, 3:]).raw_pose))
    assert isinstance(tpose.Pose(raw).replace(p=torch.zeros(3)).raw_pose, torch.Tensor)


def test_dict_helpers_match_reference():
    a = {"x": np.arange(6, dtype=np.float32).reshape(2, 3), "sub": {"y": np.array([[1], [2]], np.int32)}}
    b = {"x": np.ones((1, 3), np.float32), "sub": {"y": np.array([[7]], np.int32)}}
    ta = tree(a, torch.as_tensor)
    ja = tree(a, jnp.asarray)
    assert tcommon.flatten_dict_keys(a).keys() == jcommon.flatten_dict_keys(a).keys() == {"x", "sub/y"}
    for t, j in ((tcommon.append_dict_array(ta, b), jcommon.append_dict_array(ja, b)),
                 (tcommon.index_dict_array(a, 1), jcommon.index_dict_array(a, 1)),
                 (tcommon.to_numpy(ta), jcommon.to_numpy(ja)),
                 (tcommon.batch(a), jcommon.batch(a)),
                 (tcommon.unbatch(b), jcommon.unbatch(b))):
        for k, v in jcommon.flatten_dict_keys(j).items():
            got = tcommon.flatten_dict_keys(t)[k]
            np.testing.assert_array_equal(np.asarray(tcommon.to_numpy(got)), np.asarray(v), err_msg=k)
    assert isinstance(tcommon.to_numpy(ta)["sub"]["y"], np.ndarray)
    assert tcommon.to_numpy((ta["x"], [ta["x"]]))[1][0].shape == (2, 3)
    assert tcommon.unbatch(torch.zeros(1, 4)).shape == (4,) and tcommon.unbatch(5) == 5


ABS_MODES = {
    "pd_ee_pos_abs": ("pd_ee_delta_pos", dict(use_delta=False, normalize_action=False, pos_lower=-1.0,
                                                pos_upper=1.0)),
    "pd_ee_pose_abs": ("pd_ee_delta_pose", dict(use_delta=False, normalize_action=False, pos_lower=-1.0,
                                                  pos_upper=1.0, rot_lower=-np.pi, rot_upper=np.pi)),
}


def _with_absolute_modes(cls):
    configs = cls._controller_configs.fget

    def patched(self):
        out = dict(configs(self))
        for mode, (base, changes) in ABS_MODES.items():
            out[mode] = dict(out[base], arm=dataclasses.replace(out[base]["arm"], **changes))
        return out

    return property(patched)


@pytest.fixture(scope="module")
def jenv(f32_reference_solver):  # noqa: F811
    mp = pytest.MonkeyPatch()
    mp.setattr(JPanda, "_controller_configs", _with_absolute_modes(JPanda))
    mp.setattr(TPanda, "_controller_configs", _with_absolute_modes(TPanda))
    je = jmake("PickCube-v1", num_envs=B, control_mode="pd_joint_delta_pos", obs_mode="state_dict",
               reward_mode="dense")
    base = je.unwrapped
    model, n_sub = base.scene.model, base.sim_config.sim_steps_per_control

    @jax.jit
    def physics(d):
        d = jax.lax.scan(lambda d, _: (jphys.step(model, d), None), d, None, length=n_sub)[0]
        return jphys.forward_kinematics(model, d)

    yield base, base.scene.data, physics
    mp.undo()


def test_controller_views_match_reference(jenv):
    """The controllers' joint views, the end-effector poses, the action
    split and the obs-mode struct, from one state."""
    base, data0, _ = jenv
    base.scene.bind(data0)
    base.agent.set_control_mode("pd_ee_delta_pose")
    state = tree(base.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))
    te = tmake("PickCube-v1", num_envs=B, device="cpu", control_mode="pd_ee_delta_pose", obs_mode="state_dict",
               reward_mode="dense")
    te.reset(seed=0, options=dict(reset_to_env_states=state))
    tb = te.unwrapped
    jc, tc = base.agent.controller, tb.agent.controller
    for name in ("arm", "gripper"):
        for attr in ("qpos", "qvel"):
            np.testing.assert_allclose(getattr(tc.controllers[name], attr).numpy(),
                                       np.asarray(getattr(jc.controllers[name], attr)), rtol=0, atol=1e-6)
        assert tc.controllers[name].single_action_space.shape == jc.controllers[name].single_action_space.shape
    for attr in ("ee_pose", "ee_pose_at_base"):
        np.testing.assert_allclose(getattr(tc.controllers["arm"], attr).raw_pose.numpy(),
                                   np.asarray(getattr(jc.controllers["arm"], attr).raw_pose), rtol=0, atol=1e-6)
    a = np.arange(B * 7, dtype=np.float32).reshape(B, 7)
    tsplit, jsplit = tc.to_action_dict(torch.as_tensor(a)), jc.to_action_dict(jnp.asarray(a))
    assert tsplit.keys() == jsplit.keys()
    for k in jsplit:
        np.testing.assert_array_equal(tsplit[k].numpy(), np.asarray(jsplit[k]))
    assert tb.obs_mode_struct == base.obs_mode_struct


@pytest.mark.parametrize("mode", list(ABS_MODES))
def test_absolute_ee_targets_match_reference(jenv, mode):
    base, data0, physics = jenv
    scene, agent = base.scene, base.agent
    scene.bind(data0)
    agent.set_control_mode(mode)
    agent.controller.reset()
    assert agent.controller.controllers["arm"].config.use_delta is False
    state = tree(base.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))
    te = tmake("PickCube-v1", num_envs=B, device="cpu", control_mode=mode, obs_mode="state_dict",
               reward_mode="dense")
    tb = te.unwrapped
    te.reset(seed=0, options=dict(reset_to_env_states=state))
    assert te.single_action_space.shape == agent.controller.action_space.shape

    def act(d, a):
        scene.bind(d)
        agent.set_action(a)
        return scene.data

    act = jax.jit(act)
    # targets in the root frame in reach of the arm; the pose mode points the gripper down
    targets = np.array([[0.45, 0.05, 0.25], [0.5, -0.1, 0.15], [0.55, 0.0, 0.2]], np.float32)
    d = scene.data
    for k in range(5):
        a = np.concatenate([targets[k % 3], [np.pi, 0.0, 0.1 * k] if mode == "pd_ee_pose_abs" else [], [1.0]])
        a = np.broadcast_to(a.astype(np.float32), (B, len(a))).copy()
        a[1, 0] += 0.05
        d = act(d, jnp.asarray(a))
        if k == 0:
            before = tb.scene.data
            tb.agent.set_action(torch.as_tensor(a))
            np.testing.assert_allclose(tb.scene.data.drive_target.numpy(), np.asarray(d.drive_target),
                                       rtol=0, atol=1e-4)
            tb.scene.bind(before)
        d = physics(d)
        te.step(torch.as_tensor(a))
    np.testing.assert_allclose(tb.scene.data.qpos.numpy(), np.asarray(d.qpos), rtol=0, atol=1e-4)
    assert np.abs(np.asarray(d.qpos) - np.asarray(data0.qpos)).max() > 1e-2, "the arm did not move"


class _NoAgent:
    """Stands in for the agent the JAX package's robot-free env lacks."""

    controller = types.SimpleNamespace(reset=lambda: None, get_state=lambda: {})

    def __init__(self):
        import gymnasium

        self.single_action_space = gymnasium.spaces.Box(-1.0, 1.0, (0,), np.float32)

    def _setup_controllers(self):
        pass

    def set_action(self, action):
        pass

    def before_simulation_step(self, d, i):
        return d

    def get_proprioception(self):
        return {}


def test_robot_free_empty_env(monkeypatch, capsys):
    with pytest.raises(AttributeError, match="agent"):  # the reference fault
        jmake("Empty-v1", num_envs=B, robot_uids=None)
    monkeypatch.setattr(JEmptyEnv, "agent", _NoAgent(), raising=False)
    je = jmake("Empty-v1", num_envs=B, robot_uids=None)
    te = tmake("Empty-v1", num_envs=B, robot_uids=None, device="cpu")
    jb, tb = je.unwrapped, te.unwrapped
    assert tb.agent is None and tb.control_mode is None
    assert tb.single_action_space.shape == (0,) and tb.action_space.shape == (B, 0)
    jb.print_sim_details()
    ref = capsys.readouterr().out
    tb.print_sim_details()
    assert capsys.readouterr().out == ref
    tobs, _ = te.reset(seed=1)
    jobs, _ = je.reset(seed=1)
    assert tuple(tobs.shape) == tuple(jobs.shape) == (0,)
    assert tb.get_state_dict().keys() == jb.get_state_dict().keys()
    assert tuple(tb.get_state().shape) == tuple(jb.get_state().shape)
    # a model with no dofs: the JAX dynamics' blocked Cholesky stacks no
    # blocks and raises; the port's steps (nothing moves, no reward)
    with pytest.raises(ValueError, match="at least one array"):
        je.step(jnp.zeros((B, 0)))
    tobs, trew, tterm, _, _ = te.step(torch.zeros(B, 0))
    assert tuple(tobs.shape) == (0,) and not bool(tterm.any()) and float(trew.abs().sum()) == 0.0


def test_multi_agent_robot_is_the_first_agents():
    from maniskill_tpu.agents.base_agent import MultiAgent as JMultiAgent

    from maniskill_tpu_torch.agents.base_agent import MultiAgent as TMultiAgent

    agents = [types.SimpleNamespace(robot=object(), name=f"a-{i}") for i in range(2)]
    assert TMultiAgent(agents).robot is JMultiAgent(agents).robot is agents[0].robot
