"""The port's RotateValve levels and DClaw against the JAX package's, at 4
envs on the CPU.

One JAX env each of RotateValveLevel0-v1 and RotateValveLevel2-v1 (their
solver's bf16 cast made an identity) takes one zero-action step from its
state after the reset inside ``make`` and then 9 seeded random
``pd_joint_delta_pos`` steps; the port's env starts from the same state
(the valve's start angle, an extra of the sim state, handed over with it)
and takes the same actions. All 10 steps are held (the packages agree to
~3e-6 over 30): the claw's lowest fingertip reaches z = 0.108 m and the
valve's top is at 0.07 m, so nothing touches the valve in either package
(a reference fault, ROADMAP §3). Obs and the normalized dense reward
within 1e-4, success and terminated equal, ``contact.overflow == 0`` on
both sides, and the models equal before any step: at level 2 that includes
the per-env ``geom_size`` table, whose spoke capsules' half-lengths each
env scales by a draw from ``RandomState(0)``.

The success threshold of each level (pi/2, pi, pi, pi, 2 pi): a valve
turned by just under it fails and by just over it succeeds.
"""
import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.agents.robots.dclaw import dclaw
from maniskill_tpu_torch.physics.types import CAPSULE

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_tree_close, f32_reference_solver, one_torch_thread, reference_rollout, tree,
)

B = 4
STEPS = 10
KW = dict(num_envs=B, obs_mode="state_dict", control_mode="pd_joint_delta_pos")


@pytest.fixture(scope="module")
def reference(f32_reference_solver):
    """``reference(level)``: (JAX env, its rollout, the valve start angles
    after its reset), made once per level."""
    runs = {}

    def get(level):
        if level not in runs:
            je = jmake(f"RotateValveLevel{level}-v1", **KW)
            start = np.array(je.unwrapped.scene.data.extras["valve_start"])
            runs[level] = (je, reference_rollout(je, STEPS, first_action=0.0), start)
        return runs[level]

    return get


@pytest.mark.parametrize("level", [0, 2])
def test_rollout_matches_reference(level, reference):
    je, ref, start = reference(level)
    jb = je.unwrapped
    te = tmake(f"RotateValveLevel{level}-v1", device="cpu", **KW)
    tb = te.unwrapped
    assert [j.name for j in tb.agent.robot.active_joints] == dclaw.JOINT_NAMES
    assert [link.name for link in tb.agent.robot.links] == [link.name for link in jb.agent.robot.links]
    assert [link.name for link in tb.valve.links] == [link.name for link in jb.valve.links]
    assert_models_equal(tb.scene.model, jb.scene.model)
    assert tb.scene.model.geom_names == tuple(jb.scene.model.geom_names)

    state = dict(ref["state"], extras=dict(valve_start=start))
    obs0, _ = te.reset(seed=3, options=dict(reset_to_env_states=tree(state, torch.as_tensor)))
    assert_tree_close(obs0, ref["obs0"], 1e-6, "reset")
    for action in ref["actions"]:
        obs, reward, terminated, _, info = te.step(torch.as_tensor(action))
    assert_tree_close(obs, ref["obs"], 1e-4, f"level {level}")
    np.testing.assert_allclose(reward.numpy(), ref["reward"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(terminated.numpy(), ref["terminated"])
    np.testing.assert_array_equal(info["success"].numpy(), ref["info"]["success"])
    assert tb.scene.data.contact.overflow.tolist() == [0] * B
    assert np.asarray(jb.scene.data.contact.overflow).tolist() == [0] * B
    assert np.abs(np.asarray(jb.scene.data.qvel)).max() > 0.1, "nothing moved"


def test_per_env_spoke_sizes_match_reference(reference):
    """Level 2's (B, G, 3) ``geom_size`` equals the JAX model's exactly; it
    differs from the nominal sizes only in the spokes' collision capsules'
    half-lengths, one scale per env from ``RandomState(0)``; the host
    mirror the renderer reads keeps the visual spokes nominal, as the JAX
    renderer draws them."""
    je, _, _ = reference(2)
    tb = tmake("RotateValveLevel2-v1", device="cpu", **KW).unwrapped
    gs, jgs = tb.scene.model.geom_size.numpy(), np.asarray(je.unwrapped.scene.model.geom_size)
    assert gs.shape == jgs.shape == (B, len(tb.scene.mb.geoms), 3)
    np.testing.assert_array_equal(gs, jgs)
    nominal = tmake("RotateValveLevel0-v1", device="cpu", **KW).unwrapped.scene.model.geom_size.numpy()
    spokes = tb.spoke_geom_ids()
    assert len(spokes) == 3 and all(tb.scene.mb.geoms[g].type == CAPSULE and not tb.scene.mb.geoms[g].visual
                                    for g in spokes)
    others = np.setdiff1d(np.arange(gs.shape[1]), spokes)
    np.testing.assert_array_equal(gs[:, others], np.broadcast_to(nominal[others], (B, len(others), 3)))
    scales = np.random.RandomState(0).uniform(0.8, 1.2, size=(B, 1)).astype(np.float32)
    np.testing.assert_array_equal(gs[:, spokes, 1], nominal[spokes, 1][None] * scales)
    np.testing.assert_array_equal(gs[:, spokes][..., [0, 2]], np.broadcast_to(nominal[spokes][:, [0, 2]], (B, 3, 2)))
    vis = [g for g, gdef in enumerate(tb.scene.mb.geoms) if gdef.visual and gdef.name.startswith("valve:valve_vis")]
    np.testing.assert_array_equal(tb.scene.host_geom_size[:, vis], np.broadcast_to(nominal[vis], (B, len(vis), 3)))


@pytest.mark.parametrize("level,threshold", [(0, np.pi / 2), (1, np.pi), (2, np.pi), (3, np.pi), (4, 2 * np.pi)])
def test_success_threshold(level, threshold):
    te = tmake(f"RotateValveLevel{level}-v1", num_envs=2, device="cpu", obs_mode="state_dict")
    tb = te.unwrapped
    assert tb.success_threshold == threshold
    te.reset(seed=0)
    state = tree(tb.get_state_dict(), lambda v: v.clone())
    start = state["extras"]["valve_start"]
    q = state["articulations"]["valve"]
    turned = torch.stack([start + threshold - 1e-3, start + threshold + 1e-3], 0)[[0, 1], [0, 1]]
    q[:, 13] = turned
    _, info = te.reset(seed=0, options=dict(reset_to_env_states=state))
    assert info["success"].tolist() == [False, True]
    np.testing.assert_allclose(info["rotated"].numpy(), [threshold - 1e-3, threshold + 1e-3], atol=1e-5)
