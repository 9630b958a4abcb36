"""The port's host-side convex-hull cooking (maniskill_tpu_torch.building.
cooking and .actors.ycb, over its own copy of the native library) against the
JAX package's, on the 13 procedural YCB stand-ins: the same arrays bit for
bit (``np.testing.assert_array_equal``, no tolerance). Also the per-env facet
normals that the port's ``set_per_env_hulls`` computes once per distinct hull
against the JAX package's ``hull_face_dirs`` computed env by env.
"""
import numpy as np
import pytest
import torch

from maniskill_tpu.building import cooking as jcook
from maniskill_tpu.building.actors import ycb as jycb

from maniskill_tpu_torch.building import cooking as tcook
from maniskill_tpu_torch.building.actors import ycb as tycb

from test_torch_common import jax_cooking  # noqa: F401

# the JAX package's cooking library, loaded once it is whole
pytestmark = pytest.mark.usefixtures("jax_cooking")

MODELS = tycb.all_model_ids()


def test_model_lists_match():
    assert MODELS == jycb.all_model_ids() and len(MODELS) == 13
    assert tycb.MODEL_DENSITIES == jycb.MODEL_DENSITIES
    assert (tcook.HULL_MAX_VERTS, tcook.HULL_MAX_DIRS) == (jcook.HULL_MAX_VERTS, jcook.HULL_MAX_DIRS)


@pytest.mark.parametrize("model_id", MODELS)
def test_cooking_matches_reference(model_id):
    """Stand-in mesh, whole-mesh hull proxy, its facet normals, the convex
    decomposition (PickSingleYCB's 8 parts), each part's normals and the
    morphed render mesh of the parts: equal."""
    tv, tf = tycb.load_model_mesh(model_id)
    jv, jf = jycb.load_model_mesh(model_id)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    hull = tcook.hull_proxy(tv)
    np.testing.assert_array_equal(hull, jcook.hull_proxy(jv))
    np.testing.assert_array_equal(tcook.hull_face_dirs(hull), jcook.hull_face_dirs(hull))
    assert tcook._hull_volume(hull) == jcook._hull_volume(hull)
    tparts = tycb.cooked_hulls(model_id, max_parts=8)
    jparts = jcook.decompose_mesh(jv, jf, max_parts=8)
    assert len(tparts) == len(jparts)
    for tp, jp in zip(tparts, jparts):
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tcook.hull_face_dirs(tp), jcook.hull_face_dirs(jp))
    parts = np.stack(tparts)
    tmv, tmf = tcook.support_morph_mesh(parts)
    jmv, jmf = jcook.support_morph_mesh(parts)
    np.testing.assert_array_equal(tmv, jmv)
    np.testing.assert_array_equal(tmf, jmf)
    v, f, fc = tycb.load_model_visual(model_id)
    np.testing.assert_array_equal(v, tv)
    assert fc is None


def test_real_assets_are_refused(tmp_path, monkeypatch):
    """Where the real YCB files exist, the port builds from them as the JAX
    package does, never from a stand-in: its ``collision.ply`` is refused by
    the mesh reader (``ValueError``, in both packages), and an empty
    ``textured.obj`` gives the same empty visual."""
    model = tmp_path / "assets" / "mani_skill2_ycb" / "models" / "025_mug"
    model.mkdir(parents=True)
    (model / "collision.ply").write_text("")
    (model / "textured.obj").write_text("")
    monkeypatch.setattr(tycb, "ASSET_DIR", tmp_path)
    monkeypatch.setattr(jycb, "ASSET_DIR", tmp_path)
    for ycb in (tycb, jycb):
        with pytest.raises(ValueError, match="collision.ply"):
            ycb.load_model_mesh("025_mug")
    for t, j in zip(tycb.load_model_visual("025_mug"), jycb.load_model_visual("025_mug")):
        assert np.asarray(t).shape == np.asarray(j).shape and np.asarray(t).size == 0
    with pytest.raises(KeyError):
        tycb.load_model_mesh("999_unknown")


def test_set_per_env_hulls_dirs_match_reference():
    """Six envs over three models (two parts each, some repeated): the port's
    hull and facet-normal tables equal the JAX package's per-env
    ``hull_face_dirs``; the shared template rows of other actors stay."""
    from maniskill_tpu_torch.envs.scene import ManiSkillScene

    B, K = 6, 2
    models = ["011_banana", "025_mug", "024_bowl", "011_banana", "024_bowl", "025_mug"]
    cooked = {m: np.stack(tycb.cooked_hulls(m, max_parts=K)[:K]) for m in set(models)}
    hulls = np.stack([cooked[m] for m in models])  # (B, K, V, 3)
    scene = ManiSkillScene(num_envs=B, device="cpu")
    other = scene.create_actor_builder()
    other.add_convex_collision_from_mesh(*tycb.load_model_mesh("061_foam_brick"))
    other.build(name="brick")
    b = scene.create_actor_builder()
    for hull in cooked[models[0]]:
        b.add_convex_collision_from_mesh(hull, color=[0.8, 0.6, 0.3, 1.0])
    obj = b.build(name="obj")
    scene.finalize()
    template = scene.model.hull_dirs.clone()
    scene.set_per_env_hulls(obj, hulls)
    want = np.stack([np.stack([jcook.hull_face_dirs(hulls[e, k]) for k in range(K)]) for e in range(B)])
    m = scene.model
    assert m.hull_verts.shape == (B, 1 + K) + hulls.shape[2:]
    np.testing.assert_array_equal(m.hull_verts[:, 1:].numpy(), hulls)
    np.testing.assert_array_equal(m.hull_dirs[:, 1:].numpy(), want)
    np.testing.assert_array_equal(m.hull_dirs[:, 0].numpy(), template[0].expand(B, -1, -1).numpy())
    np.testing.assert_array_equal(scene.host_hull_verts[:, 1:], hulls)
    scene.set_per_env_body_mass(obj, np.arange(B, dtype=np.float32) + 1)
    assert scene.model.body_mass.shape == (B, scene.model.nbody)
    assert scene.model.body_mass[:, obj.body_id].tolist() == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    assert torch.equal(scene.model.body_mass[:, 0], torch.zeros(B))
