"""The port scene's per-env geometry setters take the JAX package's
signatures (maniskill_tpu/envs/scene.py): ``set_per_env_geom_sizes(actor,
sizes)`` with (B, n_geoms, 3) or (B, 3) sizes, ``set_per_env_geom_sizes_by_id
(geom_ids, sizes)``, and ``set_per_env_hulls(actor, hulls, dirs=None)`` with
precomputed facet normals. The same scene is built in each package, the same
call made on both, and the port's tables (device and host) must equal the
JAX ``Model``'s exactly.
"""
import numpy as np
import pytest

from maniskill_tpu.envs.scene import ManiSkillScene as JScene

from maniskill_tpu_torch.building.actors import ycb
from maniskill_tpu_torch.envs.scene import ManiSkillScene as TScene

from test_torch_common import jax_cooking, one_torch_thread  # noqa: F401

B = 3


def _build(Scene, kw, hull_parts=None):
    scene = Scene(num_envs=B, **kw)
    b = scene.create_actor_builder()
    b.add_box_collision(half_size=[0.02, 0.02, 0.02])
    b.add_box_visual(half_size=[0.02, 0.02, 0.02], color=[1, 0, 0, 1])
    b.add_sphere_collision(radius=0.01, pose=[0.0, 0.0, 0.03, 1, 0, 0, 0])
    multi = b.build(name="multi")
    s = scene.create_actor_builder()
    s.add_box_collision(half_size=[0.01, 0.01, 0.01])
    single = s.build(name="single")
    obj = None
    if hull_parts is not None:
        h = scene.create_actor_builder()
        for part in hull_parts:
            h.add_convex_collision_from_mesh(part, color=[0.8, 0.6, 0.3, 1.0])
        obj = h.build(name="obj")
    scene.finalize()
    return scene, multi, single, obj


def _both(hull_parts=None):
    return [_build(S, kw, hull_parts) for S, kw in ((JScene, {}), (TScene, dict(device="cpu")))]


def _assert_sizes_equal(jscene, tscene):
    np.testing.assert_array_equal(tscene.model.geom_size.numpy(), np.asarray(jscene.model.geom_size))
    np.testing.assert_array_equal(tscene.host_geom_size, np.asarray(jscene.host_geom_size))


def test_geom_sizes_of_a_multi_geom_actor_match_reference():
    rng = np.random.default_rng(0)
    (js, jmulti, _, _), (ts, tmulti, _, _) = _both()
    assert len(tmulti.geom_ids) == 3
    sizes = rng.uniform(0.01, 0.05, (B, len(tmulti.geom_ids), 3)).astype(np.float32)
    js.set_per_env_geom_sizes(jmulti, sizes)
    ts.set_per_env_geom_sizes(tmulti, sizes)
    assert ts.model.geom_size.shape == (B, ts.model.ngeom, 3)
    _assert_sizes_equal(js, ts)


def test_geom_sizes_of_a_single_geom_actor_and_by_id_match_reference():
    """(B, 3) sizes for a one-geom actor; then the id form, (B, K, 3) and
    (B, 3) for K = 1, on geoms of the other actor."""
    rng = np.random.default_rng(1)
    (js, jmulti, jsingle, _), (ts, tmulti, tsingle, _) = _both()
    assert len(tsingle.geom_ids) == 1
    sizes = rng.uniform(0.01, 0.05, (B, 3)).astype(np.float32)
    js.set_per_env_geom_sizes(jsingle, sizes)
    ts.set_per_env_geom_sizes(tsingle, sizes)
    _assert_sizes_equal(js, ts)
    ids = list(tmulti.geom_ids[:2])
    assert ids == list(jmulti.geom_ids[:2])
    two = rng.uniform(0.01, 0.05, (B, 2, 3)).astype(np.float32)
    js.set_per_env_geom_sizes_by_id(ids, two)
    ts.set_per_env_geom_sizes_by_id(ids, two)
    _assert_sizes_equal(js, ts)
    one = rng.uniform(0.01, 0.05, (B, 3)).astype(np.float32)
    js.set_per_env_geom_sizes_by_id([tmulti.geom_ids[2]], one)
    ts.set_per_env_geom_sizes_by_id([tmulti.geom_ids[2]], one)
    _assert_sizes_equal(js, ts)


@pytest.mark.usefixtures("jax_cooking")
def test_hulls_with_precomputed_dirs_match_reference():
    """A two-part hull actor given per-env hulls and made-up unit facet
    normals: both packages write the normals as given (not their own)."""
    cooked = {m: np.stack(ycb.cooked_hulls(m, max_parts=2)[:2]) for m in ("011_banana", "025_mug", "024_bowl")}
    hulls = np.stack(list(cooked.values()))  # (B, 2, V, 3)
    rng = np.random.default_rng(2)
    dirs = rng.normal(size=(B, 2, 8, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    (js, _, _, jobj), (ts, _, _, tobj) = _both(hull_parts=cooked["011_banana"])
    js.set_per_env_hulls(jobj, hulls, dirs=dirs)
    ts.set_per_env_hulls(tobj, hulls, dirs=dirs)
    np.testing.assert_array_equal(ts.model.hull_verts.numpy(), np.asarray(js.model.hull_verts))
    np.testing.assert_array_equal(ts.model.hull_dirs.numpy(), np.asarray(js.model.hull_dirs))
    np.testing.assert_array_equal(ts.model.hull_dirs[:, -2:].numpy(), dirs)
    np.testing.assert_array_equal(ts.host_hull_verts, np.asarray(js.host_hull_verts))
