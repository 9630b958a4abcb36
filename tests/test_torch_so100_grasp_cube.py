"""The port's SO100GraspCube-v1 digital twin against the JAX package's, at 2
envs on the CPU.

- With ``domain_randomization=False``: one JAX env (its solver's bf16 cast
  made an identity) and the port's env from its state after the reset
  inside ``make`` take a zero-action step and a seeded random
  ``pd_joint_target_delta_pos`` step: obs within 1e-4, qpos within 1e-5,
  reward and info equal (float info within 1e-4), ``contact.overflow == 0``.
- With it on, and a greenscreen path that does not exist (a second JAX env,
  built but never stepped): the cube's per-env half sizes and frictions
  equal the JAX env's exactly, in the model and the host tables; the keep
  lookup over segmentation ids is equal; both use the procedural overlay,
  bit-equal; ``_green_screen_rgb`` on the same rgb and segmentation arrays
  is bit-equal; ``sample_camera_poses`` and ``batched_look_at``, fed the
  same draws, agree within 1e-6; the fov is the one scalar the reference
  draws from ``RandomState(2031)`` (ROADMAP section 3).
- The port alone: each step re-poses every env's camera mount inside its
  prism, to poses distinct across envs, and the camera follows it; a
  partial reset moves (and re-keys) only the mounts of the envs it resets.
- A greenscreen file that exists but cannot be read without PIL raises an
  ``ImportError`` naming the file.
"""
import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.envs.tasks.digital_twins import base_env as jtwin
from maniskill_tpu.envs.tasks.digital_twins.so100_arm import grasp_cube as jgrasp
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.envs.tasks.digital_twins import base_env as ttwin
from maniskill_tpu_torch.envs.tasks.digital_twins.so100_arm import grasp_cube as tgrasp

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_steps_match, f32_reference_solver, one_torch_thread,
)

B = 2
UID = "SO100GraspCube-v1"
MISSING = "/nonexistent/greenscreen.png"
DR_KW = dict(num_envs=B, obs_mode="state", greenscreen_overlay_path=MISSING)


def test_step_matches_reference_without_randomization(f32_reference_solver):
    kw = dict(num_envs=B, obs_mode="state", domain_randomization=False)
    je = jmake(UID, **kw)
    te = tmake(UID, device="cpu", **kw)
    jb, tb = je.unwrapped, te.unwrapped
    assert tb.control_mode == jb.control_mode == "pd_joint_target_delta_pos"
    assert [link.name for link in tb.agent.robot.links] == [link.name for link in jb.agent.robot.links]
    assert_models_equal(tb.scene.model, jb.scene.model)
    rng = np.random.default_rng(7)
    actions = [np.zeros((B, 6), np.float32), rng.uniform(-1, 1, (B, 6)).astype(np.float32)]
    assert_steps_match(je, te, actions, 1e-4, 1e-5, UID)
    assert np.abs(np.asarray(jb.scene.data.qvel)).max() > 0.1, "nothing moved"
    np.testing.assert_array_equal(tb.camera_mount.pose.raw_pose.numpy(), np.asarray(jb.camera_mount.pose.raw_pose))


@pytest.fixture(scope="module")
def randomized():
    """(JAX env, port env), both with domain randomization and a missing
    greenscreen file; the JAX env is never stepped."""
    return jmake(UID, **DR_KW).unwrapped, tmake(UID, device="cpu", **DR_KW).unwrapped


def test_randomized_tables_and_greenscreen_match_reference(randomized):
    jb, tb = randomized
    assert_models_equal(tb.scene.model, jb.scene.model)
    gids = tb.cube.geom_ids
    np.testing.assert_array_equal(tb.scene.model.geom_size[:, gids].numpy(),
                                  np.asarray(jb.scene.model.geom_size)[:, gids])
    np.testing.assert_array_equal(tb.scene.model.geom_friction.numpy(), np.asarray(jb.scene.model.geom_friction))
    np.testing.assert_array_equal(tb.cube_half_sizes.numpy(), np.asarray(jb.cube_half_sizes))
    np.testing.assert_array_equal(tb.scene.host_geom_size, jb.scene.host_geom_size)
    assert len(set(tb.host_cube_half_sizes.tolist())) == B, "one cube size for all envs"
    np.testing.assert_array_equal(tb._keep_lut.numpy(), np.asarray(jb._keep_lut))
    keep = set(np.nonzero(tb._keep_lut.numpy())[0].tolist())
    assert keep == {tb.cube.per_scene_id} | {link.per_scene_id for link in tb.agent.robot.links}
    assert tb.overlay_sources == {"base_camera": "procedural"}
    overlay = tb._rgb_overlay_images["base_camera"]
    np.testing.assert_array_equal(overlay.numpy(), np.asarray(jb._rgb_overlay_images["base_camera"]))
    np.testing.assert_array_equal(ttwin.procedural_overlay_image(96, 64, seed=3),
                                  jtwin.procedural_overlay_image(96, 64, seed=3))
    assert tb._sensor_configs["base_camera"].fov == jb._sensor_configs["base_camera"].fov
    assert tb._sensor_configs["base_camera"].fov != 52 * np.pi / 180

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (B, 128, 128, 3), dtype=np.uint8)
    seg = rng.integers(-1, tb._keep_lut.shape[0] + 3, (B, 128, 128, 1)).astype(np.int16)
    for mode in ("background", "debug"):
        tb.rgb_overlay_mode = jb.rgb_overlay_mode = mode
        want = np.asarray(jb._green_screen_rgb(rgb, seg, jb._rgb_overlay_images["base_camera"]))
        got = tb._green_screen_rgb(torch.as_tensor(rgb), torch.as_tensor(seg), overlay).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=mode)
    tb.rgb_overlay_mode = jb.rgb_overlay_mode = "background"


class _Draws:
    """A stand-in generator that hands out fixed draws in order."""

    def __init__(self, *draws):
        self.draws = list(draws)

    def uniform(self, low, high, size):
        return self.draws.pop(0)

    normal = uniform


def test_camera_poses_match_reference(randomized):
    import jax.numpy as jnp

    jb, tb = randomized
    rng = np.random.default_rng(1)
    unit = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    noise = rng.normal(0, 1e-3, (5, 3)).astype(np.float32)
    jpose = jb.sample_camera_poses(_Draws(jnp.asarray(unit), jnp.asarray(noise)))
    tpose = tb.sample_camera_poses(_Draws(torch.as_tensor(unit), torch.as_tensor(noise)))
    np.testing.assert_allclose(tpose.raw_pose.numpy(), np.asarray(jpose.raw_pose), rtol=0, atol=1e-6)
    eyes = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    targets = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    want = np.asarray(jgrasp.batched_look_at(jnp.asarray(eyes), jnp.asarray(targets)).raw_pose)
    got = tgrasp.batched_look_at(torch.as_tensor(eyes), torch.as_tensor(targets)).raw_pose.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_mounts_jitter_per_step_and_partial_reset_rekeys_only_reset_envs():
    n = 4
    env = tmake(UID, num_envs=n, obs_mode="state", device="cpu")
    base = env.unwrapped
    cfg = base.domain_randomization_config
    center = torch.tensor(base.base_camera_settings["pos"])
    env.reset(seed=0)
    zero = torch.zeros(n, 6)
    poses = [base.camera_mount.pose.raw_pose.clone()]
    for _ in range(2):
        env.step(zero)
        p = base.camera_mount.pose.raw_pose.clone()
        off = (p[:, :3] - center).abs()
        assert bool((off <= torch.tensor(cfg.max_camera_offset) + 1e-6).all()), off
        assert len({tuple(row) for row in p.tolist()}) == n, "mount poses repeat across envs"
        assert bool((p != poses[-1]).any(dim=1).all()), "a mount kept its pose over a step"
        cam = base._sensors["base_camera"]
        torch.testing.assert_close(cam.world_pose().raw_pose, p, rtol=0, atol=1e-6)
        poses.append(p)
    keys = base.scene.get_extra("cam_key").clone()
    env.reset(options=dict(env_idx=[1, 3]))
    p = base.camera_mount.pose.raw_pose
    keys_after = base.scene.get_extra("cam_key")
    for i in range(n):
        moved = bool((p[i] != poses[-1][i]).any())
        rekeyed = bool(keys_after[i] != keys[i])
        assert moved == rekeyed == (i in (1, 3)), (i, moved, rekeyed)


def test_existing_overlay_without_pil_names_the_file(tmp_path, monkeypatch):
    import builtins

    path = tmp_path / "background.png"
    path.write_bytes(b"not read")
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="background.png"):
        ttwin.load_overlay_image(str(path), 8, 8)
