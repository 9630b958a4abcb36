"""The port's convex-hull narrowphase (``_support_sat``, ``plane_hull`` and
``collide``'s hull branches in maniskill_tpu_torch.physics.collision) against
the JAX package's, on the CPU.

- ``collide`` on one scene holding a plane, a sphere, a box, a capsule, a
  cylinder and two hulls, at 64 random poses (numpy, seeded), with the hull
  tables shared by every env and per env (YCB parts differing by env):
  for every pair kind X x HULL the candidate rows come in the same order
  with the same live mask, and pos, normal and depth of the live rows agree
  within 1e-5 m.
- A padded hull (8 distinct corners, the first repeated to 16) resting face
  down on the plane: its deepest-4 selection meets exact ties; the port's
  ``top_k_stable`` keeps the JAX package's rows, ``torch.topk`` does not.
- The four scenes of tests/test_hull.py (an L-shaped part on a plane, a cube
  hull on a static box, two stacked hulls, a sphere on a hull slab), side by
  side in one model built by each package's scene and stepped 50 substeps
  from the same qpos: each body's qpos within 1e-4. The JAX solver runs with
  its bf16 cast made an identity.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from maniskill_tpu import physics as jphys
from maniskill_tpu.envs.scene import ManiSkillScene as JScene
from maniskill_tpu.physics import collision as jcol

from maniskill_tpu_torch import physics as tphys
from maniskill_tpu_torch.building.actors import ycb
from maniskill_tpu_torch.envs.scene import ManiSkillScene as TScene
from maniskill_tpu_torch.physics import collision as tcol
from maniskill_tpu_torch.physics.types import BOX, CAPSULE, CYLINDER, HULL, PLANE, SPHERE

from test_torch_common import f32_reference_solver, jax_cooking, one_torch_thread  # noqa: F401

# the JAX package's cooking library, loaded once it is whole
pytestmark = pytest.mark.usefixtures("jax_cooking")

B = 64
ATOL = 1e-5
DEAD = -1e5  # depth below this is a BAD_DEPTH row
KINDS = [PLANE, SPHERE, BOX, CAPSULE, CYLINDER, HULL]
NAMES = {PLANE: "plane", SPHERE: "sphere", BOX: "box", CAPSULE: "capsule", CYLINDER: "cylinder", HULL: "hull"}


def _numpy_fields(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or isinstance(v, (int, float, tuple, str)):
            out[f.name] = v
        elif isinstance(v, dict):
            out[f.name] = {k: np.asarray(x) for k, x in v.items()}
        else:
            out[f.name] = np.asarray(v)
    return out


def _box_mesh(center, half):
    c, h = np.asarray(center, float), np.asarray(half, float)
    vs = np.array(list(itertools.product(*[[-1, 1]] * 3)), float) * h + c
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    fs = []
    for a, b, cc, d in quads:
        fs += [(a, b, cc), (a, cc, d)]
    return vs, np.array(fs, np.int32)


def _l_mesh():
    v1, f1 = _box_mesh([0, 0, 0.05], [0.1, 0.05, 0.05])
    v2, f2 = _box_mesh([-0.05, 0, 0.15], [0.05, 0.05, 0.05])
    return np.concatenate([v1, v2]), np.concatenate([f1, f2 + len(v1)])


def _free_adrs(model):
    adr, types = np.asarray(model.body_q_adr), np.asarray(model.body_jnt_type)
    return [int(adr[i]) for i in range(len(types)) if types[i] == tphys.FREE]


# ---------------------------------------------------------------------------
# collide on random poses, every pair kind x HULL
# ---------------------------------------------------------------------------
def _kinds_scene(per_env: bool):
    """The JAX scene's model: a plane and one free body per primitive kind
    and two hull bodies; with ``per_env`` every env's hulls are YCB parts."""
    scene = JScene(num_envs=B)
    b = scene.create_actor_builder()
    b.add_plane_collision()
    b.build_static(name="ground")
    adders = [
        lambda bb: bb.add_sphere_collision(radius=0.05),
        lambda bb: bb.add_box_collision(half_size=[0.06, 0.04, 0.03]),
        lambda bb: bb.add_capsule_collision(radius=0.03, half_length=0.05),
        lambda bb: bb.add_cylinder_collision(radius=0.04, half_length=0.03),
    ]
    for i, add in enumerate(adders):
        bb = scene.create_actor_builder()
        add(bb)
        bb.build(name=f"prim{i}")
    hulls = []
    for i, mid in enumerate(["025_mug", "011_banana"]):
        bb = scene.create_actor_builder()
        bb.add_convex_collision_from_mesh(*ycb.load_model_mesh(mid))
        hulls.append(bb.build(name=f"hull{i}"))
    scene.finalize()
    if per_env:
        cooked = [ycb.cooked_hulls(m) for m in ("011_banana", "024_bowl", "025_mug", "035_power_drill")]
        for k, actor in enumerate(hulls):
            parts = [cooked[(e + k) % 4][(e // 4) % 2] for e in range(B)]
            scene.set_per_env_hulls(actor, np.stack(parts)[:, None])
    return scene.model


@pytest.fixture(scope="module", params=["shared", "per_env"])
def kinds_contacts(request):
    """(JAX contact, port contact, geom types) at the same random poses."""
    jm = _kinds_scene(request.param == "per_env")
    tm = tphys.model_from_numpy(_numpy_fields(jm), "cpu")
    assert (tm.hull_verts.ndim == 4) == (request.param == "per_env")
    rng = np.random.default_rng(5)
    qpos = np.tile(jphys.default_qpos(jm), (B, 1))
    for qa in _free_adrs(jm):
        qpos[:, qa:qa + 3] = rng.uniform([-0.08, -0.08, -0.02], [0.08, 0.08, 0.1], (B, 3))
        q = rng.normal(size=(B, 4))
        qpos[:, qa + 3:qa + 7] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    qpos = qpos.astype(np.float32)
    jd = jphys.make_data(jm, B, qpos[0]).replace(qpos=jnp.asarray(qpos))
    jc = jax.jit(lambda m, d: jcol.collide(m, jphys.forward_kinematics(m, d)))(jm, jd)
    td = tphys.forward_kinematics(tm, tphys.make_data(tm, B).replace(qpos=torch.as_tensor(qpos)))
    tc = tcol.collide(tm, td)
    return jc, tc, np.asarray(jm.geom_type)


@pytest.mark.parametrize("kind", KINDS, ids=[f"{NAMES[k]}-hull" for k in KINDS])
def test_collide_hull_pairs_match_reference(kinds_contacts, kind):
    jc, tc, gtype = kinds_contacts
    g1, g2 = np.asarray(jc.geom1), np.asarray(jc.geom2)
    np.testing.assert_array_equal(tc.geom1, g1)
    np.testing.assert_array_equal(tc.geom2, g2)
    rows = (gtype[g1] == kind) & (gtype[g2] == HULL)
    assert rows.sum() == tcol.contacts_per_pair(kind, HULL) * (1 if kind == HULL else 2)  # one or two hulls
    jdepth, tdepth = np.asarray(jc.depth)[:, rows], tc.depth.numpy()[:, rows]
    live = jdepth > DEAD
    np.testing.assert_array_equal(tdepth > DEAD, live)
    assert live.mean() > 0.1, live.mean()
    assert kind == PLANE or (~live).any()  # separated pairs give BAD_DEPTH rows (plane rows never do)
    np.testing.assert_allclose(tdepth[live], jdepth[live], rtol=0, atol=ATOL)
    for k in ("pos", "normal"):
        np.testing.assert_allclose(getattr(tc, k).numpy()[:, rows][live], np.asarray(getattr(jc, k))[:, rows][live],
                                   rtol=0, atol=ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# exact ties: a padded hull resting face down
# ---------------------------------------------------------------------------
def test_padded_hull_face_down_ties(monkeypatch):
    """A cube's hull proxy has 8 distinct corners and repeats its first to
    fill 16 rows, so with the cube resting face down four corners and the
    eight copies of corner 0 tie in ``plane_hull``'s deepest-4. The port
    keeps the JAX package's four distinct corners; ``torch.topk`` picks other
    rows (copies of one corner) and the manifold differs."""
    verts, _ = _box_mesh([0, 0, 0], [0.05, 0.05, 0.05])
    scene = JScene(num_envs=2)
    b = scene.create_actor_builder()
    b.add_plane_collision()
    b.build_static(name="ground")
    bb = scene.create_actor_builder()
    bb.add_convex_collision_from_mesh(verts)
    bb.build(name="cube")
    jm = scene.finalize()
    hv = np.asarray(jm.hull_verts)[0]
    assert len(np.unique(hv, axis=0)) == 8 and (hv[8:] == hv[0]).all()
    tm = tphys.model_from_numpy(_numpy_fields(jm), "cpu")
    qpos = np.tile(jphys.default_qpos(jm), (2, 1)).astype(np.float32)
    (qa,) = _free_adrs(jm)
    qpos[:, qa:qa + 3] = [[0.0, 0.0, 0.0499], [0.3, -0.2, 0.05]]
    jc = jax.jit(lambda m, d: jcol.collide(m, jphys.forward_kinematics(m, d)))(
        jm, jphys.make_data(jm, 2).replace(qpos=jnp.asarray(qpos)))

    def port():
        td = tphys.forward_kinematics(tm, tphys.make_data(tm, 2).replace(qpos=torch.as_tensor(qpos)))
        c = tcol.collide(tm, td)
        return c.pos.numpy(), c.depth.numpy()

    pos, depth = port()
    np.testing.assert_allclose(depth, np.asarray(jc.depth), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pos, np.asarray(jc.pos), rtol=0, atol=ATOL)
    assert len(np.unique(pos[0].round(6), axis=0)) == 4  # four distinct corners
    monkeypatch.setattr(tcol, "top_k_stable", lambda x, k: torch.topk(x, k))
    pos_topk, depth_topk = port()
    np.testing.assert_array_equal(depth_topk, depth)  # the same tied values...
    assert np.abs(pos_topk - np.asarray(jc.pos)).max() > 1e-2  # ...from other rows


# ---------------------------------------------------------------------------
# the four scenes of tests/test_hull.py, stepped in both packages
# ---------------------------------------------------------------------------
# The scenes stand 1 m apart in one model, each in a collision group of its
# own (the ground plane in all of them), so that each package builds the
# scenes' own candidate pairs and compiles and steps once. The pedestal of
# "cube_on_box" stands on the plane, its top where the original's is.
def _build_scenes(scene):
    """Build the four scenes into ``scene``: {name: [(actor name, pose7)]}."""
    b = scene.create_actor_builder()
    b.add_plane_collision()
    b.set_collision_groups(0b1111, 0b1111)
    b.build_static(name="ground")
    cube = _box_mesh([0, 0, 0], [0.05, 0.05, 0.05])
    out = {}

    def body(name, group, pose, add, static=False):
        bb = scene.create_actor_builder()
        add(bb)
        bb.set_collision_groups(1 << group, 1 << group)
        pose = [pose[0] + group] + list(pose[1:])
        if static:
            bb.set_initial_pose(pose)
            bb.build_static(name=name)
        else:
            bb.build(name=name)
            out.setdefault(name.split(".")[0], []).append((name, pose))

    body("l_on_plane.l", 0, [0, 0, 0.3, 1, 0, 0, 0],
         lambda bb: bb.add_multiple_convex_collisions_from_mesh(*_l_mesh()))
    body("cube_on_box.pedestal", 1, [0, 0, 0.05, 1, 0, 0, 0],
         lambda bb: bb.add_box_collision(half_size=[0.1, 0.1, 0.05]), static=True)
    body("cube_on_box.cube", 1, [0.02, 0, 0.3, 1, 0, 0, 0], lambda bb: bb.add_convex_collision_from_mesh(*cube))
    for i, z in enumerate((0.05, 0.16)):
        body(f"hull_stack.c{i}", 2, [0, 0, z, 1, 0, 0, 0], lambda bb: bb.add_convex_collision_from_mesh(*cube))
    body("sphere_on_hull.slab", 3, [0, 0, 0.05, 1, 0, 0, 0],
         lambda bb: bb.add_convex_collision_from_mesh(*_box_mesh([0, 0, 0], [0.1, 0.1, 0.05])))
    body("sphere_on_hull.ball", 3, [0, 0, 0.3, 1, 0, 0, 0], lambda bb: bb.add_sphere_collision(radius=0.03))
    return out


@pytest.fixture(scope="module")
def stepped_scenes(f32_reference_solver):
    """The four scenes stepped 50 substeps in both packages from the same
    qpos: (scene layout, qpos0, JAX qpos, port qpos, JAX model, port model)."""
    jscene, tscene = JScene(num_envs=1), TScene(num_envs=1, device="cpu")
    layout = _build_scenes(jscene)
    assert _build_scenes(tscene) == layout
    jm, tm = jscene.finalize(), tscene.finalize()
    qpos0 = jphys.default_qpos(jm)
    for poses in layout.values():
        for name, pose in poses:
            qa = int(jm.body_q_adr[jscene.actors[name].body_id])
            qpos0[qa:qa + 7] = pose
    jd, jstep = jax.jit(jphys.forward)(jm, jphys.make_data(jm, 1, qpos0)), jax.jit(jphys.step)
    for _ in range(50):
        jd = jstep(jm, jd)
    td = tphys.forward(tm, tphys.make_data(tm, 1, qpos0))
    for _ in range(50):
        td = tphys.step(tm, td)
    assert int(np.asarray(jd.contact.overflow).max()) == 0
    return layout, qpos0, np.asarray(jd.qpos)[0], td.qpos.numpy()[0], jm, tm, jscene


def test_hull_scene_tables_match_reference(stepped_scenes):
    *_, jm, tm, _ = stepped_scenes
    np.testing.assert_array_equal(tm.geom_hull, np.asarray(jm.geom_hull))
    np.testing.assert_array_equal(tm.hull_verts.numpy(), np.asarray(jm.hull_verts))
    np.testing.assert_array_equal(tm.hull_dirs.numpy(), np.asarray(jm.hull_dirs))
    np.testing.assert_array_equal(tm.pair_geom1, np.asarray(jm.pair_geom1))
    np.testing.assert_allclose(tm.body_inertia.numpy(), np.asarray(jm.body_inertia), rtol=1e-6)
    np.testing.assert_allclose(tm.body_mass.numpy(), np.asarray(jm.body_mass), rtol=1e-6)


@pytest.mark.parametrize("name", ["cube_on_box", "hull_stack", "l_on_plane", "sphere_on_hull"])
def test_hull_scene_steps_match_reference(stepped_scenes, name):
    layout, qpos0, jq, tq, jm, _, jscene = stepped_scenes
    adrs = [int(jm.body_q_adr[jscene.actors[actor].body_id]) for actor, _ in layout[name]]
    assert max(np.abs(jq[qa:qa + 7] - qpos0[qa:qa + 7]).max() for qa in adrs) > 0.01  # a body fell and met
    for (actor, _), qa in zip(layout[name], adrs):
        np.testing.assert_allclose(tq[qa:qa + 7], jq[qa:qa + 7], rtol=0, atol=1e-4, err_msg=actor)


# ---------------------------------------------------------------------------
# per-env render tables: hull visuals and per-env primitive sizes
# ---------------------------------------------------------------------------
def test_per_env_render_mesh_matches_reference():
    """Three envs, a box actor whose sizes differ per env and a coloured
    two-part hull object whose parts differ per env: the port's render mesh
    (per-env local vertex table, faces in their Morton order, colours, ids,
    vertex geoms) equals the JAX package's."""
    from maniskill_tpu.render.rasterizer import SceneMesh as JMesh

    from maniskill_tpu_torch.render.rasterizer import SceneMesh as TMesh

    n = 3
    cooked = [ycb.cooked_hulls(m)[:2] for m in ("025_mug", "011_banana", "035_power_drill")]
    sizes = np.array([[0.02, 0.03, 0.04], [0.05, 0.01, 0.02], [0.03, 0.03, 0.03]], np.float32)
    meshes = []
    for Scene, kw in ((JScene, {}), (TScene, dict(device="cpu"))):
        scene = Scene(num_envs=n, **kw)
        b = scene.create_actor_builder()
        b.add_box_collision(half_size=[0.02, 0.02, 0.02])
        b.add_box_visual(half_size=[0.02, 0.02, 0.02], color=[1, 0, 0, 1])
        box = b.build(name="box")
        h = scene.create_actor_builder()
        for part in cooked[0]:
            h.add_convex_collision_from_mesh(part, color=[0.8, 0.6, 0.3, 1.0])
        obj = h.build(name="obj")
        scene.finalize()
        scene.set_per_env_geom_sizes(box, np.stack([sizes, sizes], 1))
        scene.set_per_env_hulls(obj, np.stack([np.stack(c) for c in cooked]))
        meshes.append((JMesh if Scene is JScene else TMesh).build(scene.model, scene))
    jmesh, tmesh = meshes
    assert tmesh.verts.shape[0] == n
    np.testing.assert_array_equal(tmesh.verts.numpy(), np.asarray(jmesh.verts_b))
    np.testing.assert_array_equal(tmesh.faces, np.asarray(jmesh.faces))
    np.testing.assert_array_equal(tmesh.vert_geom, np.asarray(jmesh.vert_geom))
    np.testing.assert_array_equal(tmesh.face_color.numpy(), np.asarray(jmesh.face_color))
    np.testing.assert_array_equal(tmesh.face_seg.numpy(), np.asarray(jmesh.face_seg))
    assert not np.array_equal(tmesh.verts[0].numpy(), tmesh.verts[1].numpy())
