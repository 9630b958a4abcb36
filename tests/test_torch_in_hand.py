"""The port's RotateSingleObjectInHand levels 0-2 and the Allegro hands
against the JAX package's, at 4 envs on the CPU.

One JAX env each of levels 0 and 1 (their solver's bf16 cast made an
identity). The port's env starts from the JAX env's state after the reset
inside ``make``, its extras (rotation axis, tracked tangent, cumulative
angle) handed over with it; the port's reset evaluates once more at that
pose, which leaves the extras as they were (the tangent's dot with itself
rounds to 1). Both then take the same actions, and after the reset and
after every held step obs, reward, success and terminated, the three
extras and ``contact.overflow == 0`` are checked.

How many steps are held is as many as stay within round-off of the 1e-4
tolerance, and no more. ``evaluate`` takes the arccos of a dot product
clipped to [0, 1], whose slope near 1 turns round-off in the dot into
angles ~1e-5 rad apart (one f32 ulp below 1 is 3.4e-4 rad), and the dense
reward is 20 x the step's angle plus terms near 1.
- Level 0: a zero-action step, then every flexion joint closing at the
  controller's full 0.1 rad per step. Held: the first 6 steps (rewards
  2.2e-8 apart at the 6th, 2.3e-4 at the 7th). The fingertips
  reach the cube at the 14th step: there the four tip forces, (B, 4, 3)
  through ``Link.get_net_contact_forces``, agree within 1e-4 of the
  largest (13.0 N, 6.4e-4 N apart) and the joints within 1e-4 rad.
- Level 1: a zero-action step, then 8 seeded random steps (held: all 9;
  the cube lands on the palm at the 4th; rewards 3.8e-5 apart at the 9th,
  3.0e-4 at the 10th).
Before any step the models are equal: at level 1 that includes the cube's
per-env sizes, drawn from ``RandomState(2024)`` for its collision and
visual boxes. The left hand mirrors the right across the xz-plane.
"""
import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.agents.robots.allegro_hand import allegro

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_tree_close, close_rel, f32_reference_solver, one_torch_thread, tree,
)

B = 4
KW = dict(num_envs=B, obs_mode="state_dict", control_mode="pd_joint_delta_pos")
EXTRAS = ("rot_dir", "prev_unit_vector", "cum_rotation_angle")
FLEXION = [1, 2, 3, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15]
HELD = {0: 6, 1: 9}
TOUCH_STEP = 14


def _actions(level):
    if level == 0:
        close = np.zeros((B, 16), np.float32)
        close[:, FLEXION] = 1.0
        return [np.zeros((B, 16), np.float32)] + [close] * (TOUCH_STEP - 1)
    rng = np.random.default_rng(7)
    acts = [rng.uniform(-1, 1, (B, 16)).astype(np.float32) for _ in range(HELD[level])]
    acts[0][:] = 0.0
    return acts


def _extras(data):
    return {k: np.array(data.extras[k]) for k in EXTRAS}


@pytest.fixture(scope="module")
def reference(f32_reference_solver):
    """``reference(level)``: (JAX env, its start state with extras, and per
    step its (obs, reward, terminated, success, extras, qpos, tip forces)),
    made once per level."""
    runs = {}

    def get(level):
        if level not in runs:
            je = jmake(f"RotateSingleObjectInHandLevel{level}-v1", **KW)
            jb = je.unwrapped
            state = dict(tree(jb.get_state_dict(), np.array), extras=_extras(jb.scene.data))
            steps = [dict(obs=tree(jb._init_raw_obs, np.asarray), extras=_extras(jb.scene.data))]
            for action in _actions(level):
                obs, rew, term, _, info = je.step(action)
                steps.append(dict(obs=tree(obs, np.asarray), reward=np.asarray(rew), terminated=np.asarray(term),
                                  success=np.asarray(info["success"]), extras=_extras(jb.scene.data),
                                  qpos=np.array(jb.scene.data.qpos),
                                  forces=np.asarray(jb.agent.tip_contact_forces),
                                  overflow=np.asarray(jb.scene.data.contact.overflow)))
            runs[level] = (je, state, steps)
        return runs[level]

    return get


def _check_extras(tb, want, what, atol=1e-4):
    for k in EXTRAS:
        np.testing.assert_allclose(tb.scene.data.extras[k].numpy(), want[k], rtol=0, atol=atol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("level", [0, 1])
def test_rollout_and_extras_match_reference(level, reference):
    je, state, steps = reference(level)
    jb = je.unwrapped
    te = tmake(f"RotateSingleObjectInHandLevel{level}-v1", device="cpu", **KW)
    tb = te.unwrapped
    assert [j.name for j in tb.agent.robot.active_joints] == allegro.JOINT_NAMES
    assert [link.name for link in tb.agent.robot.links] == [link.name for link in jb.agent.robot.links]
    assert_models_equal(tb.scene.model, jb.scene.model)

    obs0, _ = te.reset(seed=3, options=dict(reset_to_env_states=tree(state, torch.as_tensor)))
    assert_tree_close(obs0, steps[0]["obs"], 1e-6, "reset")
    _check_extras(tb, steps[0]["extras"], "reset", atol=1e-6)
    for i, action in enumerate(_actions(level)):
        obs, reward, terminated, _, info = te.step(torch.as_tensor(action))
        want = steps[i + 1]
        if i < HELD[level]:
            what = f"level {level} step {i + 1}"
            assert_tree_close(obs, want["obs"], 1e-4, what)
            np.testing.assert_allclose(reward.numpy(), want["reward"], rtol=0, atol=1e-4, err_msg=what)
            np.testing.assert_array_equal(terminated.numpy(), want["terminated"], err_msg=what)
            np.testing.assert_array_equal(info["success"].numpy(), want["success"], err_msg=what)
            _check_extras(tb, want["extras"], what)
        assert tb.scene.data.contact.overflow.tolist() == [0] * B
        assert want["overflow"].tolist() == [0] * B
    assert np.abs(np.asarray(jb.scene.data.qvel)).max() > 0.1, "nothing moved"
    if level == 0:
        forces = tb.agent.tip_contact_forces
        assert forces.shape == (B, 4, 3)
        assert np.abs(want["forces"]).max() > 5.0, "no fingertip touches the cube"
        close_rel(want["forces"], forces.numpy(), 1e-4, "tip forces")
        np.testing.assert_allclose(tb.scene.data.qpos.numpy(), want["qpos"], rtol=0, atol=1e-4)
        per_link = torch.stack([tb.scene.net_contact_forces_for_bodies([link.body_id])
                                for link in tb.agent.tip_links], 1)
        np.testing.assert_array_equal(forces.numpy(), per_link.numpy())


def test_level1_cube_sizes_match_reference(reference):
    """Level 1's per-env cube: its collision and visual boxes take one
    half-size per env from ``RandomState(2024)`` in [0.03, 0.042), in the
    model and in the render mirror, and the reset height follows it."""
    je, _, _ = reference(1)
    tb = tmake("RotateSingleObjectInHandLevel1-v1", device="cpu", **KW).unwrapped
    sizes = np.random.RandomState(2024).uniform(0.03, 0.042, (B,)).astype(np.float32)
    gids = tb.obj.geom_ids
    assert len(gids) == 2
    want = np.broadcast_to(sizes[:, None, None], (B, 2, 3))
    np.testing.assert_array_equal(tb.scene.model.geom_size[:, gids].numpy(), want)
    np.testing.assert_array_equal(np.asarray(je.unwrapped.scene.model.geom_size)[:, gids], want)
    np.testing.assert_array_equal(tb.scene.host_geom_size[:, gids], want)
    np.testing.assert_array_equal(tb._obj_heights.numpy(), sizes)


def test_levels_rotation_axes():
    """Levels 0 and 1 turn about z; level 2 draws a random axis per env,
    and the tracked tangent is the axis's successor."""
    for level, n in ((0, 4), (1, 4), (2, 64)):
        tb = tmake(f"RotateSingleObjectInHandLevel{level}-v1", num_envs=n, device="cpu").unwrapped
        rot = tb.scene.get_extra("rot_dir").numpy()
        axis = rot.argmax(1)
        np.testing.assert_array_equal(rot.sum(1), 1.0)
        if level < 2:
            assert (axis == 2).all()
        else:
            assert set(axis.tolist()) == {0, 1, 2}
        np.testing.assert_allclose(np.abs((tb.scene.get_extra("prev_unit_vector").numpy()
                                           * np.eye(3)[(axis + 1) % 3]).sum(1)), 1.0, atol=1e-6)


def test_left_hand_mirrors_right():
    """The left hand's links and joints mirror the right's across the
    xz-plane: at the same joint angles every link's position has its y
    negated."""
    poses = {}
    for uid in ("allegro_hand_right", "allegro_hand_left"):
        te = tmake("Empty-v1", num_envs=1, robot_uids=uid, device="cpu")
        tb = te.unwrapped
        q = torch.linspace(0.1, 0.4, 16)[None]
        q[0, 12] = 0.5  # the thumb's roll lies in [0.263, 1.396]
        tb.agent.robot.set_qpos(q)
        from maniskill_tpu_torch import physics

        tb.scene.data = physics.forward(tb.scene.model, tb.scene.data)
        poses[uid] = torch.stack([link.pose.p[0] for link in tb.agent.robot.links]).numpy()
    right, left = poses["allegro_hand_right"], poses["allegro_hand_left"]
    np.testing.assert_allclose(left, right * np.float32([1, -1, 1]), atol=1e-6)
