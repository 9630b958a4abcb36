"""Tests of the PyTorch port that need a CUDA card: the hand-written kernels
against their plain torch versions, and the slice running through them.

They skip without a card. This file imports no JAX, so it also runs on the
GPU machine, which has none (see README, "PyTorch/CUDA port").
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _faces(rng, B, F, H, W, band_rows=None):
    ylo, yhi = (0, H) if band_rows is None else band_rows
    rmax = 30.0 if band_rows is None else 4.0
    cx = rng.uniform(-5, W + 5, (B, F, 1))
    cy = rng.uniform(ylo, yhi, (B, F, 1))
    r = rng.uniform(2.0, rmax, (B, F, 1))
    ang = rng.uniform(0, 2 * np.pi, (B, F, 1)) + np.array([0, 2.1, 4.2]) + rng.uniform(-0.3, 0.3, (B, F, 3))
    return (
        (cx + r * np.cos(ang)).astype(np.float32),
        (cy + r * np.sin(ang)).astype(np.float32),
        rng.uniform(0.2, 2.0, (B, F, 3)).astype(np.float32),
        (rng.uniform(size=(B, F)) < 0.9).astype(np.int32),
        rng.uniform(size=(B, F, 3)).astype(np.float32),
        rng.integers(0, 50, F).astype(np.int32),
    )


@pytest.mark.parametrize(
    "B,F,H,W,band_rows",
    [(16, 288, 128, 128, None), (2, 3000, 40, 200, None), (2, 1500, 32, 128, (2.0, 12.0))],
    ids=["slice-like", "ragged", "band-overflow"],
)
def test_raster_kernel_matches_plain(cuda, B, F, H, W, band_rows):
    """Bit-equal 1/z depth, equal seg and rgb on every pixel, equal dropped."""
    from maniskill_tpu_torch.render import tiled_rasterizer as tr

    args = [torch.as_tensor(a, device=cuda) for a in _faces(np.random.default_rng(F), B, F, H, W, band_rows)]
    launches = tr.KERNEL.launches
    zk, sk, rk, dk = tr.rasterize_tiles(*args, H, W)
    zp, sp, rp, dp = tr.rasterize_tiles_ref(*args, H, W)
    assert tr.KERNEL.launches == launches + 1
    assert int(dk) == int(dp)
    assert torch.equal(sk, sp) and torch.equal(rk, rp)
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))


def test_slice_steps_through_the_kernel(cuda):
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.render import tiled_rasterizer as tr

    env = make("CartpoleBalanceBenchmark-v1", num_envs=16, obs_mode="rgb",
               control_mode="pd_joint_delta_pos", device=cuda)
    launches = tr.KERNEL.launches
    env.reset(seed=0)
    for _ in range(3):
        obs, *_ = env.step(torch.zeros(16, 1, device=cuda))
    assert tr.KERNEL.launches == launches + 4
    rgb = obs["sensor_data"]["base_camera_0"]["rgb"]
    assert rgb.shape == (16, 128, 128, 3) and rgb.is_cuda
    assert torch.isfinite(env.unwrapped.scene.data.qpos).all()


def test_pick_cube_state_step(cuda):
    """PickCube-v1 state on the card: finite, no dropped contacts, and the
    table carries the resting cube's weight (0.064 kg x 9.81)."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make

    env = make("PickCube-v1", num_envs=16, obs_mode="state", control_mode="pd_joint_delta_pos",
               device=cuda)
    base = env.unwrapped
    env.reset(seed=0)
    for _ in range(5):
        obs, *_ = env.step(torch.zeros(16, 8, device=cuda))
    data = base.scene.data
    assert obs.is_cuda and torch.isfinite(obs).all()
    assert torch.isfinite(data.qpos).all() and torch.isfinite(data.qvel).all()
    assert data.contact.overflow.tolist() == [0] * 16
    force = base.scene.get_pairwise_contact_forces(base.table_scene.table, base.cube)
    torch.testing.assert_close(force[:, 2], torch.full((16,), 0.064 * 9.81, device=cuda),
                               rtol=0.02, atol=0)


def test_pick_cube_rgb_through_the_kernel(cuda):
    """The PickCube-v1 rgb path launches the kernel once per frame, and the
    last frame re-rendered through the plain version agrees."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.physics.kinematics import geom_poses
    from maniskill_tpu_torch.render import tiled_rasterizer as tr
    from maniskill_tpu_torch.render.rasterizer import tiled_inputs

    n = 8
    env = make("PickCube-v1", num_envs=n, obs_mode="rgb", control_mode="pd_joint_delta_pos",
               device=cuda)
    base = env.unwrapped
    launches = tr.KERNEL.launches
    env.reset(seed=0)
    for _ in range(2):
        obs, *_ = env.step(torch.zeros(n, 8, device=cuda))
    assert tr.KERNEL.launches == launches + 3
    rgb = obs["sensor_data"]["base_camera"]["rgb"]
    cam = base._sensors["base_camera"]
    mesh = cam._get_mesh(tuple(base._hidden_objects))
    gpos, gquat = geom_poses(base.scene.model, base.scene.data)
    inputs = tiled_inputs(mesh, mesh.world_vertices(gpos, gquat), cam._view_matrix(), cam.proj,
                          128, 128, lights=base.scene.lights)
    _, sp, rp, dp = tr.rasterize_tiles_ref(*inputs, 128, 128)
    assert int(dp) == 0
    assert torch.equal((torch.clamp(rp, 0, 1) * 255).to(torch.uint8), rgb)
    assert (sp >= 0).float().mean() > 0.5
