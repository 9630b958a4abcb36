"""OpenCabinetDrawer-v1 on PartNet-Mobility cabinets in the port against
the JAX package, at 4 envs on the CPU, from the committed fixture
tests/fixtures/partnet_mobility (models 90001 and 90002 have drawers, 90003
only doors), ``MS_ASSET_DIR`` pointed at it for this module. One JAX env,
its solver's bf16 cast made an identity.

- The model specs of 90001, 90002 and 90003: base hulls, slot kinds,
  origins, limits and hulls, ``handle_local`` (1e-6), ``root_z`` and
  ``base_origin``, each package cooking the same ``.obj`` files with its own
  native library.
- The union: the same slot kinds, hull counts and parked hulls.
- The per-env tables after ``make``: the model assignment (only from 90001
  and 90002), the hull vertex and facet tables, ``body_pos`` and
  ``dof_limit`` equal the JAX env's exactly, as do the task's active slots,
  targets, open-fraction ranges and handle points.
- Three control steps of seeded random actions from the JAX reset's state:
  qpos within 1e-4, qvel within 1e-3; obs, reward, ``open_frac`` and
  ``success`` within 1e-4; ``contact.overflow`` 0 on both sides.
- One rgb frame of the base camera through the port's plain rasterizer
  against the JAX package's render: segmentation agrees on >= 0.999 of the
  pixels and rgb is equal where it agrees; the cabinet's links are in view.
"""
import os

import numpy as np
import pytest
import torch

import jax
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.building.articulations import partnet_mobility as jpm
from maniskill_tpu.building.articulations import partnet_union as jpu
from maniskill_tpu.envs.scene import ManiSkillScene as JScene
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.building.articulations import partnet_mobility as tpm
from maniskill_tpu_torch.building.articulations import partnet_union as tpu
from maniskill_tpu_torch.building.cooking import HULL_MAX_VERTS
from maniskill_tpu_torch.envs.scene import ManiSkillScene as TScene

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_tree_close, f32_reference_solver, jax_cooking, one_torch_thread, port_rollout,
    reference_rollout, tree,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "partnet_mobility")
MODELS = ("90001", "90002", "90003")
UID = "OpenCabinetDrawer-v1"
B = 4
KW = dict(num_envs=B, obs_mode="state_dict", control_mode="pd_joint_delta_pos")


@pytest.fixture(scope="module")
def fixture_assets():
    """Both packages' dataset index pointed at the fixture for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MS_ASSET_DIR", os.path.dirname(FIXTURE))
        for pm in (jpm, tpm):
            pm.load_partnet_mobility_dataset(refresh=True)
        yield
    for pm in (jpm, tpm):
        pm.load_partnet_mobility_dataset(refresh=True)


@pytest.fixture(scope="module")
def envs(fixture_assets, jax_cooking, f32_reference_solver):
    je, te = jmake(UID, **KW), tmake(UID, device="cpu", **KW)
    assert je.unwrapped._use_partnet and te.unwrapped._use_partnet
    return je, te


def test_model_specs_match_reference(fixture_assets, jax_cooking):
    assert tpm.partnet_mobility_available()
    assert tpm.available_model_ids() == jpm.available_model_ids() == list(MODELS)
    js, ts = JScene(num_envs=2), TScene(num_envs=2, device="cpu")
    for mid in MODELS:
        j, t = jpu.load_partnet_model_spec(js, mid), tpu.load_partnet_model_spec(ts, mid)
        np.testing.assert_allclose(t.base_hulls, j.base_hulls, rtol=0, atol=1e-6, err_msg=mid)
        np.testing.assert_allclose(t.base_origin, j.base_origin, rtol=0, atol=1e-6, err_msg=mid)
        assert t.root_z == pytest.approx(j.root_z, abs=1e-6)
        assert [s.kind for s in t.slots] == [s.kind for s in j.slots], mid
        for ts_, js_ in zip(t.slots, j.slots):
            for f in ("origin", "limits", "hulls", "handle_local"):
                np.testing.assert_allclose(getattr(ts_, f), getattr(js_, f), rtol=0, atol=1e-6,
                                           err_msg=f"{mid} {f}")
    # 90003's -z hinge is mirrored to +z with a negated range
    door = [s for s in tpu.load_partnet_model_spec(ts, "90003").slots if s.kind == "door"]
    assert door and any(s.limits[0] < 0 for s in door)


def test_union_matches_reference(envs):
    je, te = envs
    jb, tb = je.unwrapped, te.unwrapped
    assert tb.cab_meta.kinds == jb.cab_meta.kinds == ["drawer", "drawer", "door", "door"]
    assert tb._pn_kb_ks == jb._pn_kb_ks
    kb, ks = tb._pn_kb_ks
    np.testing.assert_array_equal(tpu._park_hulls(ks, HULL_MAX_VERTS), jpu._park_hulls(ks, HULL_MAX_VERTS))
    assert set(tb._pn_ids) == set(jb._pn_ids) == {"90001", "90002"}


def test_per_env_tables_match_reference(envs):
    je, te = envs
    jb, tb = je.unwrapped, te.unwrapped
    assert tb._pn_model_ids == jb._pn_model_ids
    assert set(tb._pn_model_ids) == {"90001", "90002"}
    jm, tm = jb.scene.model, tb.scene.model
    assert tm.hull_verts.shape[0] == B
    assert_models_equal(tm, jm)
    for f in ("body_pos", "dof_limit"):
        assert getattr(tm, f).shape[0] == B, f
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), err_msg=f)
    for f in ("active", "limits", "ranges", "handle_local"):
        np.testing.assert_array_equal(getattr(tb._pn_assign, f), getattr(jb._pn_assign, f), err_msg=f)
    for f in ("target_slot", "target_onehot", "handle_local", "slot_limits", "active_mask"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), err_msg=f)
    # each env's active drawers follow its model (90001: one, 90002: two)
    n_drawers = {"90001": 1, "90002": 2}
    act = tb.active_mask.numpy()
    for i, mid in enumerate(tb._pn_model_ids):
        assert act[i, :2].sum() == n_drawers[mid], (i, mid, act[i])
    np.testing.assert_array_equal(tb.cabinet.qlimits.numpy(), np.asarray(jm.dof_limit)[:, tb.cab_meta.slot_dofs])


def test_steps_match_reference(envs):
    je, te = envs
    jb, tb = je.unwrapped, te.unwrapped
    ref = reference_rollout(je, 3, seed=4)
    out = port_rollout(te, ref)
    data, jdata = tb.scene.data, jb.scene.data
    np.testing.assert_allclose(data.qpos.numpy(), np.asarray(jdata.qpos), rtol=0, atol=1e-4)
    np.testing.assert_allclose(data.qvel.numpy(), np.asarray(jdata.qvel), rtol=0, atol=1e-3)
    assert_tree_close(out["obs"], ref["obs"], 1e-4, f"{UID} obs")
    np.testing.assert_allclose(out["reward"].numpy(), ref["reward"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["info"]["open_frac"].numpy(), ref["info"]["open_frac"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out["info"]["success"].numpy(), ref["info"]["success"])
    assert data.contact.overflow.tolist() == [0] * B
    assert np.asarray(jdata.contact.overflow).tolist() == [0] * B


def test_rgb_frame_matches_reference(envs):
    je, te = envs
    jb, tb = je.unwrapped, te.unwrapped
    te.reset(seed=0, options=dict(reset_to_env_states=tree(jb.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))))
    jcam, tcam = jb._sensors["base_camera"], tb._sensors["base_camera"]

    def jax_frame(data):
        jb.scene.bind(data)
        return jcam.get_obs(rgb=True, segmentation=True, hidden_actors=jb._hidden_objects)

    data = jb.scene.data
    jobs = {k: np.asarray(v) for k, v in jax.jit(jax_frame)(data).items()}
    jb.scene.bind(data)  # the trace left a tracer bound
    tobs = {k: v.numpy() for k, v in tcam.get_obs(rgb=True, segmentation=True,
                                                  hidden_actors=tb._hidden_objects).items()}
    tseg, jseg = tobs["segmentation"][..., 0], jobs["segmentation"][..., 0]
    same = tseg == jseg
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_array_equal(tobs["rgb"][same], jobs["rgb"][same])
    cabinet_ids = [link.per_scene_id for link in tb.cabinet.links]
    assert np.isin(tseg, cabinet_ids).sum((1, 2)).min() > 100  # the cabinet in view in every env
