"""The port's PickCube-v1 (Panda, table, cube, goal marker; 100/20 Hz, 5
substeps, 16 solver iterations) against the JAX package's, on the CPU.

- The Model from the port's own builders equals the JAX one in every table.
- One physics substep from the same bridged Data (the JAX env's state after
  two random control steps) matches at atol 1e-5, scaled by magnitude.
- The env, set to the same ``reset_to_env_states``, matches after 3 control
  steps of seeded random ``pd_joint_delta_pos`` actions (15 substeps): qpos
  at atol 1e-4, qvel at 1e-3, obs agent/extra and the dense reward at 1e-3,
  the boolean infos exactly, and ``contact.overflow == 0`` on both sides.

The reference solver runs with its bf16 matvec cast made an identity (see
tests/test_torch_common.py), applied before the JAX env compiles its step.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.physics.collision import collide as jcollide
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch import physics as tphys
from maniskill_tpu_torch.physics.collision import collide as tcollide

from test_torch_common import f32_reference_solver, one_torch_thread, tree  # noqa: F401

jstep = importlib.import_module("maniskill_tpu.physics.step")
tstep = importlib.import_module("maniskill_tpu_torch.physics.step")

B = 4
ENV = dict(obs_mode="state_dict", reward_mode="dense", control_mode="pd_joint_delta_pos")
DEAD = -1e5


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(a, b, atol=1e-5, what=""):
    """|b - a| <= atol * max(1, max|a|)."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(1.0, float(np.abs(a).max())) if a.size else 1.0
    np.testing.assert_allclose(b, a, rtol=0, atol=atol * scale, err_msg=what)


def _numpy_fields(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name == "contact" or v is None or isinstance(v, (int, float, tuple, str)):
            out[f.name] = None if f.name == "contact" else v
        elif isinstance(v, dict):
            out[f.name] = {k: np.asarray(x) for k, x in v.items()}
        else:
            out[f.name] = np.asarray(v)
    return out


def _bridge_contact(c):
    return tphys.Contact(
        geom1=np.asarray(c.geom1), geom2=np.asarray(c.geom2),
        **{k: torch.as_tensor(np.array(getattr(c, k)))
           for k in ("pos", "normal", "depth", "friction", "restitution", "impulse", "overflow")},
    )


@pytest.fixture(scope="module")
def envs(f32_reference_solver):
    """(JAX env, port env), the JAX solver in f32 before its step compiles."""
    je = jmake("PickCube-v1", num_envs=B, **ENV)
    te = tmake("PickCube-v1", num_envs=B, device="cpu", **ENV)
    return je, te


def test_model_matches_reference(envs):
    """Bodies, geoms, candidate pairs, the top-K budget and the mocap marker:
    integer tables exactly, floats within 1e-7."""
    je, te = envs
    jm, tm = je.unwrapped.scene.model, te.unwrapped.scene.model
    for f in dataclasses.fields(tm):
        jv, tv = getattr(jm, f.name), getattr(tm, f.name)
        if jv is None or tv is None:
            assert jv is None and tv is None, f.name
            continue
        if isinstance(jv, (tuple, str, int, float)):
            assert jv == tv, (f.name, jv, tv)
            continue
        jv, tv = np.asarray(jv), _np(tv)
        assert jv.shape == tv.shape, (f.name, jv.shape, tv.shape)
        if jv.dtype.kind in "biu":
            np.testing.assert_array_equal(tv, jv, err_msg=f.name)
        else:
            np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-7, err_msg=f.name)
    assert tm.npair > 0 and tm.max_active_contacts > 0 and len(tm.mocap_bodies) == 1


def test_substep_from_bridged_data(envs):
    """collide and one physics.step on the JAX env's state after two random
    control steps, bridged into the port (warm-start impulses included)."""
    je, _ = envs
    je.reset(seed=3)
    rng = np.random.default_rng(3)
    for _ in range(2):
        je.step(rng.uniform(-1, 1, (B, 8)).astype(np.float32))
    jm, jd = je.unwrapped.scene.model, je.unwrapped.scene.data
    tm = tphys.model_from_numpy(_numpy_fields(jm), "cpu")
    td = tphys.data_from_numpy(_numpy_fields(jd), "cpu", contact=_bridge_contact(jd.contact))

    jc, tc = jax.jit(jcollide)(jm, jd), tcollide(tm, td)
    np.testing.assert_array_equal(tc.geom1, np.asarray(jc.geom1))
    np.testing.assert_array_equal(tc.geom2, np.asarray(jc.geom2))
    live = np.asarray(jc.depth) > DEAD
    np.testing.assert_array_equal(tc.depth.numpy() > DEAD, live)
    assert (np.asarray(jc.depth) > -0.01).any(), "nothing is in contact"
    for k in ("depth", "pos", "normal"):
        _close(np.asarray(getattr(jc, k))[live], getattr(tc, k).numpy()[live], what=k)

    jd2 = jax.jit(jstep.step)(jm, jd)
    td2 = tstep.step(tm, td)
    for k in ("qpos", "qvel", "qacc"):
        _close(getattr(jd2, k), getattr(td2, k), what=k)
    _close(jd2.contact.impulse, td2.contact.impulse, what="impulse")
    np.testing.assert_array_equal(td2.contact.overflow.numpy(), np.asarray(jd2.contact.overflow))


def test_env_steps_match_reference(envs):
    je, te = envs
    je.reset(seed=0)
    state = tree(je.unwrapped.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))
    te.reset(seed=0, options=dict(reset_to_env_states=state))
    np.testing.assert_array_equal(te.unwrapped.scene.data.qpos.numpy(),
                                  np.asarray(je.unwrapped.scene.data.qpos))

    rng = np.random.default_rng(0)
    for _ in range(3):
        action = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
        jobs, jrew, jterm, _, jinfo = je.step(action)
        tobs, trew, tterm, _, tinfo = te.step(torch.as_tensor(action))
    jdata, tdata = je.unwrapped.scene.data, te.unwrapped.scene.data
    np.testing.assert_allclose(tdata.qpos.numpy(), np.asarray(jdata.qpos), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tdata.qvel.numpy(), np.asarray(jdata.qvel), rtol=0, atol=1e-3)
    assert np.abs(np.asarray(jdata.qvel)).max() > 0.1, "the arm did not move"
    for part in ("agent", "extra"):
        jflat = jax.tree_util.tree_leaves_with_path(jobs[part])
        for path, jv in jflat:
            tv = tobs[part]
            for p in path:
                tv = tv[p.key]
            np.testing.assert_allclose(_np(tv).astype(np.float32), np.asarray(jv, np.float32),
                                       rtol=0, atol=1e-3, err_msg=f"{part}{path}")
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=0, atol=1e-3)
    for k in ("success", "is_obj_placed", "is_robot_static", "is_grasped"):
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]), err_msg=k)
    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
    assert tdata.contact.overflow.tolist() == [0] * B
    assert np.asarray(jdata.contact.overflow).tolist() == [0] * B


def test_unported_control_modes_raise():
    """A mode the Panda does not have raises, naming the mode, and never
    falls back to another mode (the Panda now has all eight of the JAX
    package's modes, so the modes asked for here are ones it never had)."""
    for mode in ("pd_joint_pos_vel", "pd_base_vel"):
        with pytest.raises(NotImplementedError, match=mode):
            tmake("PickCube-v1", num_envs=1, device="cpu", control_mode=mode)
    env = tmake("PickCube-v1", num_envs=1, device="cpu", control_mode="pd_joint_target_delta_pos")
    assert env.unwrapped.control_mode == "pd_joint_target_delta_pos"
    assert env.unwrapped.single_action_space.shape == (8,)
