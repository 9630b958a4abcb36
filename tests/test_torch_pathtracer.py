"""The port's path tracer (the ``rt``, ``rt-med`` and ``rt-fast`` shader
packs, maniskill_tpu_torch/render/pathtracer.py) against the JAX package's
on the mesh and state of PickCube-v1 at 2 envs and 24x32 pixels, the JAX
package's draws handed over.

Tolerances: seg and valid agree on >= 0.999 of the pixels; color, depth,
normal and albedo within 1e-5 on every pixel whose 3x3 neighbourhood agrees
in seg and valid (the box filter mixes a pixel's neighbours). A ray-chunked
frame is bit-equal to the unchunked one, and ties between coplanar faces go
to the first face, inside a face chunk and across chunks, as in the JAX
package.

The JAX ``rt`` and ``rt-med`` packs cannot run as written: their indirect
ray calls ``jnp.linalg.norm(tang, -1, keepdims=True)``, which passes -1 as
the norm's order, not its axis, and raises on the (B, R, 3) frame vectors
(maniskill_tpu/render/pathtracer.py:193). The port takes the norm along the
last axis, as the line means; here the JAX module's ``jnp`` is patched
through pytest's MonkeyPatch so that call does so too (no JAX file is
edited).
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from maniskill_tpu.render import pathtracer as jpt

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.physics.kinematics import geom_poses
from maniskill_tpu_torch.render import pathtracer as tpt
from maniskill_tpu_torch.utils.geometry import rotation_conversions as rc

from test_torch_common import one_torch_thread  # noqa: F401

B, H, W = 2, 24, 32
SEG_AGREE = 0.999
ATOL = 1e-5


def _norm_last_axis(x, ord=None, axis=None, keepdims=False):
    """``jnp.linalg.norm`` with the JAX pathtracer's ``norm(x, -1, ...)``
    taken along the last axis."""
    if ord == -1 and axis is None:
        ord, axis = None, -1
    return jnp.linalg.norm(x, ord=ord, axis=axis, keepdims=keepdims)


@pytest.fixture(scope="module")
def patched_jpt():
    mp = pytest.MonkeyPatch()
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.linalg = types.SimpleNamespace(norm=_norm_last_axis)
    mp.setattr(jpt, "jnp", proxy)
    yield jpt
    mp.undo()


@pytest.fixture(scope="module")
def scene():
    """PickCube's human camera at 24x32 over 2 envs: the mesh, the world
    vertices and the camera of the port's env after a seeded reset."""
    env = tmake("PickCube-v1", num_envs=B, obs_mode="state", device="cpu",
                human_render_camera_configs=dict(width=W, height=H))
    env.reset(seed=3)
    base = env.unwrapped
    cam = base._human_render_cameras["render_camera"]
    mesh = cam._get_mesh(())
    wv = mesh.world_vertices(*geom_poses(base.scene.model, base.scene.data))
    pose = cam.world_pose()
    rot = torch.einsum("bij,jk->bik", rc.quaternion_to_matrix(pose.q), cam._ros_to_gl.T)
    return dict(base=base, cam=cam, mesh=mesh, wv=wv, pos=pose.p, rot=rot)


def jax_draws(key, spp, R):
    """The draws the JAX pathtrace makes from ``key``: per sample
    k1, k2 = split(k), jitter = uniform(k1, (R, 2)), and from split(k2)'s
    first key the bounce draws (B, R, 2)."""
    jitter, bounce = [], []
    for k in jax.random.split(key, spp):
        k1, k2 = jax.random.split(k)
        jitter.append(np.asarray(jax.random.uniform(k1, (R, 2))))
        k2a, _ = jax.random.split(k2)
        bounce.append(np.asarray(jax.random.uniform(k2a, (B, R, 2))))
    return torch.as_tensor(np.stack(jitter)), torch.as_tensor(np.stack(bounce))


def jax_render(jpt, sc, key, **cfg):
    mesh = sc["mesh"]
    jmesh = types.SimpleNamespace(faces=mesh.faces, face_color=jnp.asarray(mesh.face_color.numpy()),
                                  face_seg=jnp.asarray(mesh.face_seg.numpy()))
    cam = sc["cam"]
    out = jpt.pathtrace(jmesh, jnp.asarray(sc["wv"].numpy()), jnp.asarray(sc["pos"].numpy()),
                        jnp.asarray(sc["rot"].numpy()), cam.fx, cam.fy, cam.cx, cam.cy, H, W,
                        lights=sc["base"].scene.lights, key=key, **cfg)
    return {k: np.asarray(v) for k, v in out.items()}


def port_render(sc, **kw):
    cam = sc["cam"]
    out = tpt.pathtrace(sc["mesh"], sc["wv"], sc["pos"], sc["rot"], cam.fx, cam.fy, cam.cx, cam.cy, H, W,
                        lights=sc["base"].scene.lights, **kw)
    return {k: v.numpy() for k, v in out.items()}


def neighbourhood_agrees(ok):
    """(B, H, W) bool: every pixel of the 3x3 neighbourhood agrees."""
    pad = np.pad(ok, ((0, 0), (1, 1), (1, 1)), constant_values=True)
    out = np.ones_like(ok)
    for dy in range(3):
        for dx in range(3):
            out &= pad[:, dy:dy + H, dx:dx + W]
    return out


@pytest.mark.parametrize("pack", ["rt-fast", "rt-med", "rt"])
def test_pack_matches_reference(patched_jpt, scene, pack):
    cfg = tpt.RT_PACKS[pack]
    assert cfg == jpt.RT_PACKS[pack]
    key = jax.random.fold_in(jax.random.PRNGKey(7), 12345)
    jitter, bounce = jax_draws(key, cfg["spp"], H * W)
    ref = jax_render(patched_jpt, scene, key, **cfg)
    out = port_render(scene, jitter=jitter, bounce_draws=bounce if cfg["bounces"] else None, **cfg)
    agree = (out["seg"] == ref["seg"]) & (out["valid"] == ref["valid"])
    assert agree.mean() >= SEG_AGREE, f"{pack}: seg/valid agree on {agree.mean():.5f}"
    assert 0.2 < ref["valid"].mean() < 0.95, "the frame should show the scene and some background"
    near = neighbourhood_agrees(agree)
    for k in ("color", "depth", "normal", "albedo"):
        np.testing.assert_allclose(out[k][near], ref[k][near], rtol=0, atol=ATOL, err_msg=f"{pack} {k}")


def test_ray_chunks_are_bit_equal(scene, monkeypatch):
    gen = torch.Generator().manual_seed(0)
    jitter = torch.rand(2, H * W, 2, generator=gen)
    bounce = torch.rand(2, B, H * W, 2, generator=gen)
    cfg = dict(spp=2, bounces=1, denoise=True)
    whole = port_render(scene, jitter=jitter, bounce_draws=bounce, **cfg)
    monkeypatch.setattr(tpt, "RAY_CHUNK_BYTES", 100 * 4 * B * tpt.FACE_CHUNK)  # 100 rays: 8 chunks, one ragged
    assert tpt.ray_chunk_size(B) == 100
    chunked = port_render(scene, jitter=jitter, bounce_draws=bounce, **cfg)
    for k in whole:
        assert np.array_equal(whole[k], chunked[k]), k


def test_coplanar_ties_go_to_the_first_face():
    """Faces 3 and 600 are copies of face 0 (600 in the second face chunk),
    so a ray through them hits three coplanar faces at one t: inside a chunk
    the first index wins, across chunks only a strictly nearer hit replaces
    it. Rays also hit faces 5 and 700 (copies) alone."""
    rng = np.random.default_rng(1)
    F = 800
    tri = rng.uniform(-1, 1, (1, F, 3, 3)).astype(np.float32)
    tri[..., 2] = rng.uniform(-30, -20, (1, F, 3))  # far behind the test faces
    tri[0, 0] = [[-1, -1, -2], [1, -1, -2], [0, 1, -2]]
    tri[0, 3] = tri[0, 600] = tri[0, 0]
    tri[0, 5] = [[2, 2, -3], [4, 2, -3], [3, 4, -3]]
    tri[0, 700] = tri[0, 5]
    tri0 = tri[:, :, 0]
    e1, e2 = tri[:, :, 1] - tri0, tri[:, :, 2] - tri0
    dirs = np.array([[[0, 0, -1], [3 / 3.2, 2.6 / 3.2, -1.0], [0.1, -0.2, -1]]], np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.zeros((1, 3, 3), np.float32)
    jt, jf = jpt._ray_mesh(*(jnp.asarray(a) for a in (origins, dirs, tri0, e1, e2)))
    tt, tf = tpt.ray_mesh(*(torch.as_tensor(a) for a in (origins, dirs, tri0, e1, e2)))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tf[0, 0] == 0 and tf[0, 1] == 5


def test_render_seed_and_default_draws(scene):
    """The render seed is the reference's: the 32-bit sum of the bits of
    qpos[:, 0]; the default draws depend on it alone."""
    qpos = scene["base"].scene.data.qpos
    ref = np.asarray(jnp.sum(jax.lax.bitcast_convert_type(jnp.asarray(qpos[:, :1].numpy()).ravel(), jnp.int32))
                     .astype(jnp.uint32))
    seed = tpt.render_seed(qpos)
    assert int(seed) == int(ref)
    j0, u0 = tpt.render_draws(seed, 0, B, 10, True)
    j0b, _ = tpt.render_draws(seed.clone(), 0, B, 10, True)
    j1, _ = tpt.render_draws(seed, 1, B, 10, True)
    jo, _ = tpt.render_draws(seed + 1, 0, B, 10, True)
    assert torch.equal(j0, j0b) and not torch.equal(j0, j1) and not torch.equal(j0, jo)
    assert u0.shape == (B, 10, 2) and 0 <= float(u0.min()) and float(u0.max()) < 1


def test_camera_rt_branch(scene):
    """A camera with an rt pack path-traces through ``capture``: the draws
    handed to ``get_obs`` give the pathtrace frame, and the texture contract
    is the rasterizer's."""
    cam = scene["cam"]
    cam.config.shader_pack = "rt-fast"
    try:
        gen = torch.Generator().manual_seed(2)
        jitter = torch.rand(2, H * W, 2, generator=gen)
        obs = cam.get_obs(rgb=True, depth=True, segmentation=True, draws=dict(jitter=jitter))
        ref = port_render(scene, jitter=jitter, seed=scene["base"].scene.render_seed(), **tpt.RT_PACKS["rt-fast"])
        assert obs["rgb"].dtype == torch.uint8 and obs["rgb"].shape == (B, H, W, 3)
        np.testing.assert_array_equal(obs["rgb"].numpy(), (np.clip(ref["color"], 0, 1) * 255).astype(np.uint8))
        np.testing.assert_array_equal(obs["segmentation"][..., 0].numpy(), ref["seg"].astype(np.int16))
        assert obs["depth"].dtype == torch.int16
        again = cam.get_obs(rgb=True)  # the draws from the render seed: a pure function of the state
        assert torch.equal(again["rgb"], cam.get_obs(rgb=True)["rgb"])
    finally:
        cam.config.shader_pack = "minimal"
