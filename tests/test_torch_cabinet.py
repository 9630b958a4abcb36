"""OpenCabinetDrawer-v1 and OpenCabinetDoor-v1 with the Fetch, procedural
cabinets, in the port against the JAX package, at 4 envs on the CPU (one
JAX env per task, its solver's bf16 cast made an identity).

- The per-env tables after ``make``: the model's ``body_pos``,
  ``dof_limit``, ``geom_size`` and ``geom_pos`` and the task's
  ``variant_ids``, ``active``, ``handle_local`` and ``target_slot`` equal the
  JAX env's exactly (both draw them with the same numpy ``RandomState``
  calls from the same seed).
- Every body's pose, the Fetch at its ``rest`` keyframe (the envs are made
  without keyframe noise): within 1e-5 m.
- One control step of OpenCabinetDrawer-v1, a seeded random action from
  the JAX reset's state (both solvers start cold): qpos within 1e-4, qvel
  within 1e-3; obs, reward, ``open_frac`` and ``success`` within 1e-4;
  ``contact.overflow`` 0 on both sides.
- The JAX package's locked-slot experiment (tests/test_heterogeneous.py)
  rerun in the port: each slot opened to 0.9 of its own limit, a locked
  slot 0.05 past its [0, 0]; after 20 zero-action steps the locked slots are
  back within 5e-3 and the active slots keep over 0.8 of their opening.
- The base controllers: ``pd_base_vel``'s (holonomic) and the Fetch's
  forward-only velocity targets equal the JAX controllers' within 1e-6 for
  random actions at random yaws.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.agents.controllers import PDBaseVelControllerConfig as JBaseVelConfig
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch import physics as tphys
from maniskill_tpu_torch.agents.controllers import PDBaseVelControllerConfig as TBaseVelConfig
from maniskill_tpu_torch.agents.robots.fetch.fetch import BASE_JOINT_NAMES

from test_torch_common import (  # noqa: F401
    assert_tree_close, f32_reference_solver, one_torch_thread, port_rollout, reference_rollout, tree,
)

B = 4
# no keyframe noise: the reset puts the Fetch at its rest keyframe, the base
# placed by the reset's draws
KW = dict(num_envs=B, obs_mode="state_dict", control_mode="pd_joint_delta_pos", robot_init_qpos_noise=0.0)
TASKS = ("OpenCabinetDrawer-v1", "OpenCabinetDoor-v1")


@pytest.fixture(scope="module")
def envs(f32_reference_solver):
    """``envs(env_id)``: (JAX env, port env), each made once."""
    made = {}

    def get(env_id):
        if env_id not in made:
            made[env_id] = (jmake(env_id, **KW), tmake(env_id, device="cpu", **KW))
        return made[env_id]

    return get


@pytest.mark.parametrize("env_id", TASKS)
def test_per_env_tables_match_reference(envs, env_id):
    je, te = envs(env_id)
    jb, tb = je.unwrapped, te.unwrapped
    assert not jb._use_partnet and not tb._use_partnet
    jm, tm = jb.scene.model, tb.scene.model
    for f in ("body_pos", "dof_limit", "geom_size", "geom_pos"):
        assert getattr(tm, f).shape[0] == B, f
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), err_msg=f)
    ji, ti = jb.cab_inst, tb.cab_inst
    for f in ("variant_ids", "active", "limits", "dims", "handle_local"):
        np.testing.assert_array_equal(getattr(ti, f), getattr(ji, f), err_msg=f)
    np.testing.assert_array_equal(tb.handle_local.numpy(), np.asarray(jb.handle_local))
    np.testing.assert_array_equal(tb.target_slot.numpy(), np.asarray(jb.target_slot))
    np.testing.assert_array_equal(tb.slot_limits.numpy(), np.asarray(jb.slot_limits))
    np.testing.assert_array_equal(tb.active_mask.numpy(), np.asarray(jb.active_mask))
    # the batch mixes structures, and qlimits reads each env's own limits
    assert not np.all(ti.active == ti.active[0])
    lim = tb.cabinet.qlimits.numpy()
    assert lim.shape == (B, 5, 2)
    np.testing.assert_array_equal(lim, np.asarray(jm.dof_limit)[:, tb.cab_meta.slot_dofs])


def test_rest_keyframe_link_poses_match_reference(envs):
    """The JAX reset's state (the Fetch at its rest keyframe) through the
    port's forward kinematics: every body's pose within 1e-5."""
    je, te = envs(TASKS[0])
    jb, tb = je.unwrapped, te.unwrapped
    jd = jb.scene.data
    qpos = np.array(jd.qpos)
    kf = np.asarray(tb.agent.keyframes["rest"].qpos, np.float32)
    np.testing.assert_array_equal(qpos[:, tb.agent.robot._qadr.numpy()][:, 3:], np.broadcast_to(kf[3:], (B, 12)))
    td = tphys.forward(tb.scene.model, tb.scene.data.replace(qpos=torch.as_tensor(qpos)))
    np.testing.assert_allclose(td.xpos.numpy(), np.asarray(jd.xpos), rtol=0, atol=1e-5)
    np.testing.assert_allclose(td.xquat.numpy(), np.asarray(jd.xquat), rtol=0, atol=1e-5)
    # the per-env joint frames place each env's drawers at its own heights
    slot_z = td.xpos[:, tb.cab_meta.slot_bodies, 2]
    assert len(torch.unique(slot_z)) > 5


def test_one_control_step_matches_reference(envs):
    env_id = TASKS[0]
    je, te = envs(env_id)
    jb, tb = je.unwrapped, te.unwrapped
    ref = reference_rollout(je, 1, seed=3)
    out = port_rollout(te, ref)
    data, jdata = tb.scene.data, jb.scene.data
    np.testing.assert_allclose(data.qpos.numpy(), np.asarray(jdata.qpos), rtol=0, atol=1e-4)
    np.testing.assert_allclose(data.qvel.numpy(), np.asarray(jdata.qvel), rtol=0, atol=1e-3)
    assert_tree_close(out["obs"], ref["obs"], 1e-4, f"{env_id} obs")
    np.testing.assert_allclose(out["reward"].numpy(), ref["reward"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["info"]["open_frac"].numpy(), ref["info"]["open_frac"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out["info"]["success"].numpy(), ref["info"]["success"])
    assert data.contact.overflow.tolist() == [0] * B
    assert np.asarray(jdata.contact.overflow).tolist() == [0] * B
    # the step moved the robot
    assert np.abs(data.qpos.numpy() - out["qpos0"].numpy()).max() > 1e-3


def test_locked_slots_stay_shut_and_active_slots_hold(envs):
    _, te = envs(TASKS[0])
    tb = te.unwrapped
    te.reset(seed=0)
    inst = tb.cab_inst
    target_q = np.maximum(0.9 * inst.limits[..., 1], 0.05).astype(np.float32)
    d = tb.scene.data
    qpos = d.qpos.clone()
    qpos[:, tb.cab_meta.slot_qadrs] = torch.as_tensor(target_q)
    tb.scene.data = d.replace(qpos=qpos)
    for _ in range(20):
        te.step(torch.zeros(B, 13))
    qs = tb.scene.data.qpos[:, tb.cab_meta.slot_qadrs].numpy()
    active = inst.active
    assert np.abs(qs[~active]).max() < 5e-3, qs[~active]
    assert (qs[active] > 0.8 * target_q[active]).all(), qs[active]
    frac = tb.evaluate()["open_frac"].numpy()
    assert frac.min() > 0.6, frac


@pytest.mark.parametrize("holonomic", [True, False])
def test_base_controller_matches_reference(envs, holonomic):
    je, te = envs(TASKS[0])
    jb, tb = je.unwrapped, te.unwrapped
    if holonomic:
        kw = dict(joint_names=BASE_JOINT_NAMES, lower=[-1, -1, -3.14], upper=[1, 1, 3.14], damping=1000,
                  force_limit=500)
        jc = JBaseVelConfig(**kw).controller_cls(JBaseVelConfig(**kw), jb.agent.robot, jb.scene)
        tc = TBaseVelConfig(**kw).controller_cls(TBaseVelConfig(**kw), tb.agent.robot, tb.scene)
    else:
        jc, tc = jb.agent.controller.controllers["base"], tb.agent.controller.controllers["base"]
    assert type(tc).__name__ == type(jc).__name__
    n = tc.ACTION_DIM
    rng = np.random.default_rng(5)
    jdata0, tdata0 = jb.scene.data, tb.scene.data
    try:
        for _ in range(3):
            qpos = np.array(jdata0.qpos)
            qpos[:, tc.q_adrs[2].item()] = rng.uniform(-np.pi, np.pi, B)
            action = rng.uniform(-1.2, 1.2, (B, n)).astype(np.float32)
            jb.scene.bind(jdata0.replace(qpos=jnp.asarray(qpos)))
            tb.scene.bind(tdata0.replace(qpos=torch.as_tensor(qpos)))
            jc.set_action(jnp.asarray(action))
            tc.set_action(torch.as_tensor(action))
            want = np.asarray(jb.scene.data.drive_vel_target)
            got = tb.scene.data.drive_vel_target.numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            assert np.abs(got[:, tc.dof_adrs.numpy()]).max() > 0.1
    finally:
        jb.scene.bind(jdata0)
        tb.scene.bind(tdata0)
