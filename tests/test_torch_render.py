"""Parity of the PyTorch port's renderer (maniskill_tpu_torch.render,
maniskill_tpu_torch.sensors) with the JAX package's, on the CPU.

- The tiled rasterizer's plain torch version (``rasterize_tiles_ref``, which
  ``rasterize_tiles`` runs for CPU tensors) against the Pallas kernel
  ``pallas_rasterize_tiles`` run under ``force_tpu_interpret_mode`` on random
  faces made with numpy: seg equal on >= 99.9% of pixels (XLA:CPU may
  contract the plane evaluations to FMAs and move an edge pixel), 1/z depth
  within rtol 1e-5 where seg agrees. The port drops no face; the Pallas
  kernel cuts a band's list at 1,024 faces, so where a band overflows it is
  run on two halves of the faces, each under the cap, and merged as the list
  walk would.
- A pile of 40 coincident cylinders (1,206 front faces in one band) and a
  box built after them, drawn by the port's ``rasterize`` and by the JAX
  package's dense path: seg equal on every pixel, ``dropped`` 0.
- The plain version against a literal face-by-face loop in numpy (the
  kernel's semantics): equal on every pixel, including ragged sizes.
- The camera (all modalities) against the JAX camera on the cartpole scene,
  with the thresholds of tests/test_render.py:100-108.
- Every primitive mesh wound outward, and a cylinder drawn by the culled
  tiled path equal to the two-sided face-chunked path.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from maniskill_tpu import physics as jphys
from maniskill_tpu.envs.scene import ManiSkillScene as JScene
from maniskill_tpu.envs.tasks.control.cartpole import CartPoleRobot as JCartPole
from maniskill_tpu.render import rasterizer as jrasterizer
from maniskill_tpu.render.pallas_rasterizer import pallas_rasterize_tiles
from maniskill_tpu.sensors.camera import Camera as JCamera
from maniskill_tpu.sensors.camera import CameraConfig as JCameraConfig
from maniskill_tpu.utils.scene_utils import look_at as jlook_at

from maniskill_tpu_torch import physics as tphys
from maniskill_tpu_torch.envs.scene import ManiSkillScene as TScene
from maniskill_tpu_torch.envs.tasks.control.cartpole import CartPoleRobot as TCartPole
from maniskill_tpu_torch.render import rasterizer as trasterizer
from maniskill_tpu_torch.render import tiled_rasterizer as tr
from maniskill_tpu_torch.sensors.camera import Camera as TCamera
from maniskill_tpu_torch.sensors.camera import CameraConfig as TCameraConfig
from maniskill_tpu_torch.utils.scene_utils import look_at as tlook_at

from test_torch_common import one_torch_thread  # noqa: F401


def random_faces(rng, B, F, H, W, band_rows=None):
    """Well-shaped random triangles (rotated, jittered equilateral) in screen
    space; ``band_rows`` packs small ones into those rows to overflow a band."""
    ylo, yhi = (0, H) if band_rows is None else band_rows
    rmax = 30.0 if band_rows is None else 4.0
    cx = rng.uniform(-5, W + 5, (B, F, 1))
    cy = rng.uniform(ylo, yhi, (B, F, 1))
    r = rng.uniform(2.0, rmax, (B, F, 1))
    ang = rng.uniform(0, 2 * np.pi, (B, F, 1)) + np.array([0, 2.1, 4.2]) + rng.uniform(-0.3, 0.3, (B, F, 3))
    fx = (cx + r * np.cos(ang)).astype(np.float32)
    fy = (cy + r * np.sin(ang)).astype(np.float32)
    inv_z = rng.uniform(0.2, 2.0, (B, F, 3)).astype(np.float32)
    ok = (rng.uniform(size=(B, F)) < 0.9).astype(np.int32)
    rgb = rng.uniform(size=(B, F, 3)).astype(np.float32)
    seg = rng.integers(0, 50, F).astype(np.int32)
    return fx, fy, inv_z, ok, rgb, seg


@pytest.mark.parametrize(
    "B,F,H,W,band_rows",
    [(2, 80, 32, 128, None), (1, 1200, 16, 128, (2.0, 12.0))],
    ids=["random", "band-overflow"],
)
def test_tiled_matches_pallas_interpret(B, F, H, W, band_rows):
    args = random_faces(np.random.default_rng(F), B, F, H, W, band_rows)

    def pallas(faces):
        fx, fy, inv_z, ok, rgb, seg = args
        with pltpu.force_tpu_interpret_mode():
            out = pallas_rasterize_tiles(
                *[jnp.asarray(a[:, faces]) for a in (fx, fy, inv_z, ok, rgb)], jnp.asarray(seg[faces]), H, W
            )
        return [np.asarray(x) for x in out]

    zj, sj, rj, dj = pallas(slice(None))
    zt, st, rt, dt = tr.rasterize_tiles(*[torch.as_tensor(a) for a in args], H, W)
    zt, st, rt = zt.numpy(), st.numpy(), rt.numpy()
    assert int(dt) == 0
    if band_rows is None:
        assert int(dj) == 0
    else:
        # the Pallas kernel dropped faces past its 1,024-entry band list; the
        # port walks the whole list, which equals the first half's list then
        # the second half's: the second half wins a pixel only where nearer
        assert int(dj) > 0, "no band overflowed"
        za, sa, ra, da = pallas(slice(0, F // 2))
        zb, sb, rb, db = pallas(slice(F // 2, F))
        assert int(da) == int(db) == 0
        nearer = (sb >= 0) & (zb < za)
        zj, rj = np.where(nearer, zb, za), np.where(nearer[..., None], rb, ra)
        sj = np.where(nearer, sb, sa)
    same = st == sj
    assert same.mean() >= 0.999, same.mean()
    fg = same & (sj >= 0)
    assert fg.mean() > 0.3
    np.testing.assert_allclose(zt[fg], zj[fg], rtol=1e-5)
    np.testing.assert_array_equal(rt[same], rj[same])


def _face_by_face(table, idx, counts, H, W):
    """The kernel's semantics, literally: per pixel, walk the band's list in
    order; strict > on 1/z from 0."""
    B, T, _ = idx.shape
    iz = np.zeros((B, H, W), np.float32)
    seg = np.full((B, H, W), -1, np.int32)
    rgb = np.zeros((B, H, W, 3), np.float32)
    px = np.arange(W, dtype=np.float32) + np.float32(0.5)
    for b in range(B):
        for t in range(T):
            rows = np.arange(t * 16, min(t * 16 + 16, H))
            py = (rows.astype(np.float32) + np.float32(0.5))[:, None]
            for j in range(counts[b, t]):
                r = table[b, idx[b, t, j]]
                e = [(r[3 * k] * px + r[3 * k + 1] * py) + r[3 * k + 2] for k in range(4)]
                better = (e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0) & (e[3] > iz[b, rows])
                iz[b, rows] = np.where(better, e[3], iz[b, rows])
                seg[b, rows] = np.where(better, np.int32(r[12]), seg[b, rows])
                rgb[b, rows] = np.where(better[..., None], r[13:16], rgb[b, rows])
    return iz, seg, rgb


@pytest.mark.parametrize("H,W", [(32, 128), (40, 100)], ids=["aligned", "ragged"])
def test_plain_matches_face_by_face(H, W):
    args = [torch.as_tensor(a) for a in random_faces(np.random.default_rng(H), 2, 150, H, W)]
    table, valid = tr.face_records(*args)
    idx, counts, dropped = tr.bin_faces(args[0], args[1], valid, H, W)
    iz, seg, rgb = tr.raster_bands_ref(table, idx, counts, H, W)
    ref = _face_by_face(table.numpy(), idx.numpy(), counts.numpy(), H, W)
    assert int(dropped) == 0 and (ref[1] >= 0).mean() > 0.3
    np.testing.assert_array_equal(iz.numpy(), ref[0])
    np.testing.assert_array_equal(seg.numpy(), ref[1])
    np.testing.assert_array_equal(rgb.numpy(), ref[2])
    zbuf, seg2, rgb2, _ = tr.rasterize_tiles(*args, H, W)
    np.testing.assert_array_equal(seg2.numpy(), ref[1])
    np.testing.assert_array_equal(zbuf.numpy(), np.where(ref[1] >= 0, 1.0 / np.maximum(ref[0], 1e-9), 1e9))


def _pile_scene(scene_cls, n_dots, **kw):
    """``n_dots`` coincident flat cylinders (marker bodies, as the drawing
    tasks' undrawn ink dots) and a box built after them, beside the pile."""
    scene = scene_cls(num_envs=1, sim_timestep=0.01, solver_iterations=4, **kw)
    for i in range(n_dots):
        b = scene.create_actor_builder()
        b.add_cylinder_visual(radius=0.08, half_length=0.0015, color=[0.8, 0.2, 0.2, 1])
        b.set_initial_pose([0, 0, 0, *PILE_QUAT])
        b.build_kinematic(f"dot_{i}")
    b = scene.create_actor_builder()
    b.add_box_visual(half_size=[0.05, 0.05, 0.01], color=[0.1, 0.3, 0.9, 1])
    b.set_initial_pose([0.0, 0.15, 0, 1, 0, 0, 0])
    b.build("box")
    scene.model = scene.finalize()
    return scene


PILE_QUAT = [np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0]


def test_band_overflow_draws_every_face():
    """A band holding more than 1,024 front faces (the reference's Pallas
    band cap) is drawn whole: the port's ``rasterize`` on the CPU equals the
    JAX package's dense path, which draws every face. The box is built after
    the pile, so its faces come last in the band's list: a capped list loses
    it. 1/z within rtol 5e-5: the tiled path evaluates 1/z as one affine
    plane, the dense path as a sum of three edge ratios, and their f32
    roundings part by ~1e-5."""
    n, H, W = 40, 48, 64
    poses = np.array([[[0, 0, 0, *PILE_QUAT]] * n], np.float32)
    qpos = np.array([[0.0, 0.15, 0, 1, 0, 0, 0]], np.float32)
    js = _pile_scene(JScene, n)
    js.bind(jphys.forward(js.model, jphys.make_data(js.model, 1).replace(
        mocap_pose=jnp.asarray(poses), qpos=jnp.asarray(qpos))))
    ts = _pile_scene(TScene, n, device="cpu")
    ts.bind(tphys.forward(ts.model, tphys.make_data(ts.model, 1).replace(
        mocap_pose=torch.as_tensor(poses), qpos=torch.as_tensor(qpos))))
    cfg = dict(uid="cam", width=W, height=H, fov=1.2, near=0.01, far=100)
    eye, target = [0.25, 0.05, 0.3], [0, 0.06, 0]
    jcam = JCamera(JCameraConfig(pose=jlook_at(eye, target), **cfg), js)
    tcam = TCamera(TCameraConfig(pose=tlook_at(eye, target), **cfg), ts)
    jmesh, tmesh = jcam._get_mesh(()), tcam._get_mesh(())

    jgpos, jgquat = jphys.geom_poses(js.model, js.data)
    jo = jax.jit(lambda v, view: jrasterizer.rasterize(jmesh, v, view, jcam.proj, H, W))(
        jmesh.world_vertices(jgpos, jgquat), jcam._view_matrix()
    )
    gpos, gquat = tphys.geom_poses(ts.model, ts.data)
    args = (tmesh, tmesh.world_vertices(gpos, gquat), tcam._view_matrix(), tcam.proj, H, W)
    fx, fy, *_ = inputs = trasterizer.tiled_inputs(*args)
    _, valid = tr.face_records(*inputs)
    _, counts, _ = tr.bin_faces(fx, fy, valid, H, W)
    assert int(counts.max()) > 1024, counts
    to = trasterizer.rasterize(*args)

    jseg, tseg = np.asarray(jo["seg"]), to["seg"].numpy()
    assert int(to["dropped"]) == 0
    np.testing.assert_array_equal(tseg, jseg)
    box = int(tmesh.face_seg[-1])
    assert (jseg == 1).sum() > 50 and (jseg == box).sum() > 50  # the pile's top and the box
    fg = jseg > 0
    np.testing.assert_allclose(1.0 / to["depth"].numpy()[fg], 1.0 / np.asarray(jo["depth"])[fg], rtol=5e-5)


def test_kernel_refuses_cpu_tensors():
    """The kernel never runs a plain path in its place: CPU tensors raise."""
    args = [torch.as_tensor(a) for a in random_faces(np.random.default_rng(0), 1, 10, 16, 128)]
    table, valid = tr.face_records(*args)
    idx, counts, _ = tr.bin_faces(args[0], args[1], valid, 16, 128)
    launches = tr.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        tr.KERNEL(table, idx, counts, 16, 128)
    assert tr.KERNEL.launches == launches


# ---------------------------------------------------------------------------
# the camera on the cartpole scene
# ---------------------------------------------------------------------------
def _scene(scene_cls, robot_cls, B, **kw):
    scene = scene_cls(num_envs=B, sim_timestep=1.0 / 120, solver_iterations=4, **kw)
    robot_cls(scene, control_mode="pd_joint_delta_pos")
    wall = scene.create_actor_builder()
    wall.add_box_visual(half_size=(1e-3, 20, 10), color=(0.3, 0.3, 0.3, 1))
    wall.set_initial_pose(np.array([1, 0, 1, 0.7071068, 0, 0, 0.7071068]))
    wall.build_static(name="wall")
    scene.set_ambient_light([0.3, 0.3, 0.3])
    scene.add_directional_light([1, 1, -1], [1, 1, 1])
    scene.add_directional_light([0, 0, -1], [1, 1, 1])
    scene.model = scene.finalize()
    return scene


def test_camera_matches_reference():
    """All modalities of the camera against the JAX camera (its CPU path is
    the jnp rasterizer): the port's rgb/depth/segmentation/position come from
    the tiled rasterizer (back faces culled), its normal/albedo from the
    face-chunked path, as in the reference."""
    B, H, W = 2, 48, 80
    qpos = np.array([[0.3, 0.4], [-0.5, -1.2]], np.float32)
    js = _scene(JScene, JCartPole, B)
    ts = _scene(TScene, TCartPole, B, device="cpu")
    js.bind(jphys.forward(js.model, jphys.make_data(js.model, B).replace(qpos=jnp.asarray(qpos))))
    ts.bind(tphys.forward(ts.model, tphys.make_data(ts.model, B).replace(qpos=torch.as_tensor(qpos))))
    cfg = dict(uid="cam", width=W, height=H, fov=np.pi / 3, near=0.01, far=100)
    jcam = JCamera(JCameraConfig(pose=jlook_at([0.3, -1.6, 1.3], [0, 0, 1]), **cfg), js)
    tcam = TCamera(TCameraConfig(pose=tlook_at([0.3, -1.6, 1.3], [0, 0, 1]), **cfg), ts)
    modes = dict(rgb=True, depth=True, segmentation=True, position=True)
    jcam._get_mesh(())  # built eagerly, outside the trace

    def jax_obs(data):
        js.bind(data)
        return jcam.get_obs(normal=True, albedo=True, **modes)

    jo = {k: np.asarray(v) for k, v in jax.jit(jax_obs)(js.data).items()}
    to = {k: v.numpy() for k, v in tcam.get_obs(**modes).items()}
    to.update({k: v.numpy() for k, v in tcam.get_obs(rgb=False, normal=True, albedo=True).items()})

    seg_same = to["segmentation"] == jo["segmentation"]
    assert seg_same.mean() >= 0.99, seg_same.mean()
    assert len(np.unique(jo["segmentation"])) >= 3  # wall, cart, pole
    depth_close = np.abs(to["depth"].astype(np.int32) - jo["depth"].astype(np.int32)) <= 2
    assert depth_close.mean() >= 0.99, depth_close.mean()
    rgb_close = np.abs(to["rgb"].astype(np.int32) - jo["rgb"].astype(np.int32)).max(-1) <= 1
    assert rgb_close.mean() >= 0.99, rgb_close.mean()
    pos_close = np.abs(to["position"].astype(np.int32) - jo["position"].astype(np.int32)).max(-1) <= 2
    assert pos_close.mean() >= 0.99, pos_close.mean()
    seg = seg_same[..., 0]
    np.testing.assert_allclose(to["normal"][seg], jo["normal"][seg], atol=1e-5)
    alb_close = np.abs(to["albedo"].astype(np.int32) - jo["albedo"].astype(np.int32)).max(-1) <= 1
    assert alb_close[seg].mean() >= 0.99
    for k, v in tcam.get_params().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jcam.get_params()[k]), atol=1e-5, err_msg=k)


def test_view_and_projection_matrices():
    rng = np.random.default_rng(2)
    for _ in range(5):
        eye, target = rng.normal(size=3) * 3, rng.normal(size=3)
        np.testing.assert_array_equal(trasterizer.look_at_matrix(eye, target),
                                      jrasterizer.look_at_matrix(eye, target))
    np.testing.assert_array_equal(trasterizer.perspective_matrix(1.1, 1.6, 0.01, 50.0),
                                  jrasterizer.perspective_matrix(1.1, 1.6, 0.01, 50.0))


@pytest.mark.parametrize("gtype", ["box", "sphere", "cylinder", "capsule"])
def test_primitive_meshes_wound_outward(gtype):
    """Every face of each primitive mesh is wound outward, as the tiled
    path's back-face culling assumes (the JAX package's cylinder side faces
    are wound inward: culled, a cylinder loses its near side), and a
    cylinder drawn by the culled tiled path covers the same pixels as the
    two-sided face-chunked path."""
    from maniskill_tpu_torch.physics.types import BOX, CAPSULE, CYLINDER, SPHERE
    from maniskill_tpu_torch.render.meshes import geom_mesh

    kind = dict(box=BOX, sphere=SPHERE, cylinder=CYLINDER, capsule=CAPSULE)[gtype]
    v, f = geom_mesh(kind, np.array([0.3, 0.2, 0.1], np.float32))
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    normal = np.cross(b - a, c - a)
    assert (np.sum(normal * (a + b + c) / 3, 1) > 0).all()
    if kind == CYLINDER:
        scene = TScene(num_envs=1, device="cpu")
        builder = scene.create_actor_builder()
        builder.add_cylinder_visual(radius=0.3, half_length=0.2, color=[1, 0, 0, 1])
        builder.build_static("cylinder")
        scene.finalize()
        scene.bind(tphys.forward(scene.model, tphys.make_data(scene.model, 1)))
        cam = TCamera(TCameraConfig("cam", tlook_at([0.9, 0.5, 0.8], [0, 0, 0]), 64, 64, 1.0, 0.01, 10), scene)
        mesh = cam._get_mesh(())
        gpos, gquat = tphys.geom_poses(scene.model, scene.data)
        args = (mesh, mesh.world_vertices(gpos, gquat), cam._view_matrix(), cam.proj, 64, 64)
        culled = trasterizer.rasterize(*args)["seg"]
        two_sided = trasterizer.rasterize(*args, want_normal=True)["seg"]
        assert (culled > 0).sum() > 500
        np.testing.assert_array_equal(culled.numpy(), two_sided.numpy())
