"""The port's sensors and camera-pose helpers against the JAX package's, on
the CPU.

- ``StereoDepthCamera`` on PickCube-v1 at 2 envs and 48x64, from one state
  (the JAX env's after the reset inside ``make``): rgb and segmentation
  equal, and the int16 stereo depth equal except at disparity-quantization
  ties, which sit at most one quantization level apart on under 0.1% of the
  pixels (the count is printed); some pixels are occlusion shadows (0) in
  both.
- The randomization helpers (``batched_look_at``,
  ``make_camera_rectangular_prism``, ``noised_look_at``) and the rotation
  functions (``random_quaternions``, ``euler2quat``,
  ``euler_angles_to_quaternion``, ``quaternion_slerp``, the 6d pair) with
  the JAX package's draws handed over as tensors, within 1e-6.
- The port's one ``batched_look_at`` agrees with the JAX SO100 task's
  private copy on that task's camera poses, which is why the port's task
  imports it.
"""
import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.envs.utils import randomization as jrand
from maniskill_tpu.utils.geometry import rotation_conversions as jrc
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.envs.utils import randomization as trand
from maniskill_tpu_torch.utils.geometry import rotation_conversions as trc

from test_torch_common import one_torch_thread, tree  # noqa: F401

B = 2
H, W = 48, 64
TOL = 1e-6
TIE_SHARE_MAX = 1e-3


def _cfg(pkg):
    mod = __import__(f"{pkg}.sensors.depth_camera", fromlist=["StereoDepthCameraConfig"])
    from maniskill_tpu_torch.utils.scene_utils import look_at

    pose = look_at([0.35, 0.3, 0.35], [0.0, 0.0, 0.05]).raw_pose
    return mod.StereoDepthCameraConfig("stereo", np.asarray(pose), W, H, np.pi / 3, 0.01, 10.0)


@pytest.fixture(scope="module")
def stereo_frames():
    from maniskill_tpu.sensors.depth_camera import StereoDepthCamera as JStereo
    from maniskill_tpu_torch.sensors.depth_camera import StereoDepthCamera as TStereo

    je = jmake("PickCube-v1", num_envs=B, obs_mode="state")
    te = tmake("PickCube-v1", num_envs=B, obs_mode="state", device="cpu")
    state = tree(je.unwrapped.get_state_dict(), np.array)
    te.reset(seed=1, options=dict(reset_to_env_states=tree(state, torch.as_tensor)))
    jcam = JStereo(_cfg("maniskill_tpu"), je.unwrapped.scene)
    tcam = TStereo(_cfg("maniskill_tpu_torch"), te.unwrapped.scene)
    jobs = {k: np.asarray(v) for k, v in jcam.get_obs(rgb=True, depth=True, segmentation=True).items()}
    tobs = {k: v.numpy() for k, v in tcam.get_obs(rgb=True, depth=True, segmentation=True).items()}
    return jobs, tobs, tcam


def test_stereo_depth_matches_reference(stereo_frames):
    jobs, tobs, cam = stereo_frames
    assert sorted(tobs) == sorted(jobs) == ["depth", "rgb", "segmentation"]
    np.testing.assert_array_equal(tobs["rgb"], jobs["rgb"])
    np.testing.assert_array_equal(tobs["segmentation"], jobs["segmentation"])
    td, jd = tobs["depth"], jobs["depth"]
    assert td.dtype == jd.dtype == np.int16 and td.shape == (B, H, W, 1)
    # a disparity-quantization tie lands one level up or down: compare the
    # levels the two depths quantize to
    step = cam.fx * cam.baseline / 0.05 / cam.disparity_levels

    def level(d):
        z = d.astype(np.float64) / 1000.0
        return np.where(d > 0, np.round(cam.fx * cam.baseline / np.maximum(z, 1e-9) / step), 0)

    ties = td != jd
    print(f"stereo depth: {int(ties.sum())} of {td.size} pixels differ (quantization ties)")
    assert ties.mean() < TIE_SHARE_MAX
    assert np.abs(level(td) - level(jd))[ties].max(initial=0) <= 1
    valid = (jd > 0) & (td > 0)
    assert valid.mean() > 0.5 and (jobs["segmentation"][..., 0] > 0).mean() > 0.5
    # occlusion shadows: foreground pixels the stereo check invalidated
    shadow = (jobs["segmentation"] > 0) & (jd == 0)
    assert shadow.sum() > 0 and np.array_equal(shadow, (tobs["segmentation"] > 0) & (td == 0))


def test_stereo_depth_is_two_renders_of_one_mesh(stereo_frames):
    _, tobs, cam = stereo_frames
    right = cam.right_view_matrix()
    left = cam._view_matrix()
    np.testing.assert_allclose((left - right).numpy()[:, 0, 3], cam.baseline, rtol=1e-6)
    no_depth = cam.get_obs(rgb=True, depth=False)
    assert "depth" not in no_depth
    np.testing.assert_array_equal(no_depth["rgb"].numpy(), tobs["rgb"])


def test_batched_look_at_matches_reference():
    import jax.numpy as jnp
    from maniskill_tpu.envs.tasks.digital_twins.so100_arm import grasp_cube as jgrasp

    rng = np.random.default_rng(0)
    eyes = rng.uniform(-1, 1, (32, 3)).astype(np.float32)
    targets = rng.uniform(-1, 1, (32, 3)).astype(np.float32)
    targets[0] = eyes[0] + np.array([0, 0, 0.5], np.float32)  # looking straight down the up axis
    want = np.asarray(jrand.batched_look_at(jnp.asarray(eyes), jnp.asarray(targets)).raw_pose)
    got = trand.batched_look_at(torch.as_tensor(eyes), torch.as_tensor(targets)).raw_pose.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the SO100 camera's box and target: the one function agrees with the
    # JAX task's private copy, so the port's task uses it
    base, target = np.array([0.5, 0.3, 0.35], np.float32), np.array([0.3, 0.0, 0.1], np.float32)
    eyes = base + rng.uniform(-0.025, 0.025, (64, 3)).astype(np.float32)
    targets = target + rng.normal(0, 1e-3, (64, 3)).astype(np.float32)
    want = np.asarray(jgrasp.batched_look_at(jnp.asarray(eyes), jnp.asarray(targets)).raw_pose)
    got = trand.batched_look_at(torch.as_tensor(eyes), torch.as_tensor(targets)).raw_pose.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_camera_randomization_matches_reference():
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(3)
    n = 16
    eyes_j = jrand.make_camera_rectangular_prism(key, n, scale=(0.2, 0.1, 0.3), center=(0.5, 0.0, 0.4), theta=0.7)
    u = np.array(jax.random.uniform(key, (n, 3)))
    eyes_t = trand.make_camera_rectangular_prism(n, scale=(0.2, 0.1, 0.3), center=(0.5, 0.0, 0.4), theta=0.7,
                                                 uniform=torch.as_tensor(u))
    np.testing.assert_allclose(eyes_t.numpy(), np.asarray(eyes_j), rtol=0, atol=TOL)
    k_t, k_r = jax.random.split(key)
    tn = np.array(jax.random.normal(k_t, (n, 3)))
    rn = np.array(jax.random.normal(k_r, (n,)))
    want = jrand.noised_look_at(key, eyes_j, [0.0, 0.0, 0.1], look_at_noise=0.02, view_axis_rot_noise=0.3)
    got = trand.noised_look_at(eyes_t, [0.0, 0.0, 0.1], look_at_noise=0.02, view_axis_rot_noise=0.3,
                               target_normal=torch.as_tensor(tn), roll_normal=torch.as_tensor(rn))
    np.testing.assert_allclose(got.raw_pose.numpy(), np.asarray(want.raw_pose), rtol=0, atol=TOL)
    # drawn from a generator, the shapes and the box hold
    g = torch.Generator().manual_seed(0)
    eyes = trand.make_camera_rectangular_prism(n, scale=(0.2, 0.2, 0.2), generator=g)
    assert eyes.shape == (n, 3) and float(eyes.abs().max()) <= 0.1 * np.sqrt(2) + 1e-6
    assert trand.noised_look_at(eyes, [1.0, 0, 0], generator=g).raw_pose.shape == (n, 7)


def test_rotation_functions_match_reference():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(5)
    normal = np.array(jax.random.normal(key, (64, 4)))
    np.testing.assert_allclose(trc.random_quaternions(64, normal=torch.as_tensor(normal)).numpy(),
                               np.asarray(jrc.random_quaternions(key, 64)), rtol=0, atol=TOL)
    q = trc.random_quaternions(1000, generator=torch.Generator().manual_seed(0))
    assert bool((q[:, 0] >= 0).all()) and torch.allclose(q.norm(dim=-1), torch.ones(1000))
    e = rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)
    for conv in ("XYZ", "ZYX", "YXZ", "ZYZ"):
        np.testing.assert_allclose(trc.euler_angles_to_quaternion(torch.as_tensor(e), conv).numpy(),
                                   np.asarray(jrc.euler_angles_to_quaternion(jnp.asarray(e), conv)),
                                   rtol=0, atol=TOL, err_msg=conv)
    for axes in ("sxyz", "rxyz"):
        np.testing.assert_allclose(trc.euler2quat(*torch.as_tensor(e).T, axes=axes).numpy(),
                                   np.asarray(jrc.euler2quat(*e.T, axes=axes)), rtol=0, atol=TOL, err_msg=axes)
    np.testing.assert_allclose(trc.euler2quat(0.1, -0.2, 0.3).numpy(), np.asarray(jrc.euler2quat(0.1, -0.2, 0.3)),
                               rtol=0, atol=TOL)
    q0 = np.array(jrc.random_quaternions(jax.random.PRNGKey(6), 64))
    q1 = np.array(jrc.random_quaternions(jax.random.PRNGKey(7), 64))
    q1[:8] = q0[:8]  # the small-angle branch
    q1[8:12] = -q0[8:12]  # the antipodal sign flip
    t = rng.uniform(0, 1, (64, 1)).astype(np.float32)
    np.testing.assert_allclose(trc.quaternion_slerp(torch.as_tensor(q0), torch.as_tensor(q1), torch.as_tensor(t)).numpy(),
                               np.asarray(jrc.quaternion_slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(t))),
                               rtol=0, atol=TOL)
    d6 = rng.normal(0, 1, (64, 6)).astype(np.float32)
    m = trc.rotation_6d_to_matrix(torch.as_tensor(d6))
    # two normalizations and a cross product: 1-2 float32 ulps apart
    np.testing.assert_allclose(m.numpy(), np.asarray(jrc.rotation_6d_to_matrix(jnp.asarray(d6))), rtol=0,
                               atol=2 * TOL)
    np.testing.assert_array_equal(trc.matrix_to_rotation_6d(m).numpy(),
                                  np.asarray(jrc.matrix_to_rotation_6d(jnp.asarray(m.numpy()))))
    np.testing.assert_allclose(trc.rotation_6d_to_matrix(trc.matrix_to_rotation_6d(m)).numpy(), m.numpy(), atol=2 * TOL)


def test_batched_rng_random_quaternions():
    from maniskill_tpu_torch.envs.utils.randomization import BatchedRNG

    rng = BatchedRNG.from_seeds(torch.arange(64))
    yaw = trand.random_quaternions(rng, lock_x=True, lock_y=True, bounds=(0.0, np.pi / 2))
    assert yaw.shape == (64, 4) and bool((yaw[:, 1:3] == 0).all())
    ang = 2 * torch.atan2(yaw[:, 3], yaw[:, 0])
    assert bool((ang >= 0).all() & (ang <= np.pi / 2 + 1e-6).all())
    free = trand.random_quaternions(rng)
    assert torch.allclose(free.norm(dim=-1), torch.ones(64))
