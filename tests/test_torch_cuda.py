"""Tests of the PyTorch port that need a CUDA card: the hand-written kernels
against their plain torch versions, the slices running through them, and
the IK on the card.

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


def test_raster_kernel_walks_a_band_past_1024_faces(cuda):
    """A band list of several thousand entries (the reference's Pallas list
    stops at 1,024) is walked whole in one launch: bit-equal to the plain
    version, nothing dropped."""
    from maniskill_tpu_torch.render import tiled_rasterizer as tr

    H, W = 48, 320
    args = [torch.as_tensor(a, device=cuda) for a in _faces(np.random.default_rng(7), 4, 5000, H, W, (18.0, 30.0))]
    table, valid = tr.face_records(*args)
    _, counts, _ = tr.bin_faces(args[0], args[1], valid, H, W)
    assert int(counts.max()) > 4 * 1024, counts
    launches = tr.KERNEL.launches
    zk, sk, rk, dk = tr.rasterize_tiles(*args, H, W)
    zp, sp, rp, dp = tr.rasterize_tiles_ref(*args, H, W)
    assert tr.KERNEL.launches == launches + 1
    assert int(dk) == int(dp) == 0
    assert torch.equal(sk, sp) and torch.equal(rk, rp)
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))


SETUP_CASES = [
    # (B, F, H, W, band_rows): the raster tests' shapes, then one env, F not a
    # multiple of 32, H not a multiple of 16, W not a multiple of the 32-column
    # tile, and a band past 1,024 entries
    (16, 288, 128, 128, None), (2, 3000, 40, 200, None), (2, 1500, 32, 128, (2.0, 12.0)),
    (1, 1000, 64, 96, None), (3, 333, 50, 70, None), (2, 2500, 48, 100, (18.0, 30.0)),
]
SETUP_IDS = ["slice-like", "ragged", "band-overflow", "one-env", "odd-sizes", "band-past-1024"]


def _plain_setup(tr, args, H, W):
    table, valid = tr.face_records(*args)
    idx, counts, _ = tr.bin_faces(args[0], args[1], valid, H, W)
    return table, valid, idx, counts


@pytest.mark.parametrize("B,F,H,W,band_rows", SETUP_CASES, ids=SETUP_IDS)
def test_raster_setup_matches_plain(cuda, B, F, H, W, band_rows):
    """raster_setup's table bits, validity, whole (B, T, F) id lists and
    counts equal face_records' and bin_faces' (corners on pixel centres and
    degenerate faces mixed in)."""
    from maniskill_tpu_torch.render import tiled_rasterizer as tr

    rng = np.random.default_rng(F + H)
    faces = list(_faces(rng, B, F, H, W, band_rows))
    faces[0][:, ::7] = np.round(faces[0][:, ::7]) + 0.5
    faces[1][:, ::11, 2] = faces[1][:, ::11, 0]  # some faces degenerate or slivers
    faces[0][:, ::11, 2] = faces[0][:, ::11, 0]
    args = [torch.as_tensor(a, device=cuda) for a in faces]
    launches = tr.SETUP.launches
    table, valid, idx, counts = tr.SETUP(*args, H, W)
    assert tr.SETUP.launches == launches + 1
    p_table, p_valid, p_idx, p_counts = _plain_setup(tr, args, H, W)
    torch.cuda.synchronize()
    assert torch.equal(table.view(torch.int32), p_table.view(torch.int32))
    assert torch.equal(valid, p_valid)
    assert torch.equal(idx, p_idx) and torch.equal(counts, p_counts)
    if band_rows is not None:
        assert int(counts.max()) > 1024


@pytest.mark.parametrize("B,F,H,W,band_rows", SETUP_CASES, ids=SETUP_IDS)
def test_raster_tiles_matches_plain(cuda, B, F, H, W, band_rows):
    """raster_tiles on the plain table and lists: 1/z bits, seg and rgb equal
    to raster_bands_ref's on every pixel."""
    from maniskill_tpu_torch.render import tiled_rasterizer as tr

    args = [torch.as_tensor(a, device=cuda) for a in _faces(np.random.default_rng(F + W), B, F, H, W, band_rows)]
    table, _, idx, counts = _plain_setup(tr, args, H, W)
    launches = tr.KERNEL.launches
    iz, seg, rgb = tr.KERNEL(table, idx, counts, H, W)
    assert tr.KERNEL.launches == launches + 1
    p_iz, p_seg, p_rgb = tr.raster_bands_ref(table, idx, counts, H, W)
    torch.cuda.synchronize()
    assert torch.equal(iz.view(torch.int32), p_iz.view(torch.int32))
    assert torch.equal(seg, p_seg) and torch.equal(rgb, p_rgb)
    assert (seg >= 0).float().mean() > 0.2


def test_rasterize_tiles_launches_each_kernel_once_per_frame(cuda):
    from maniskill_tpu_torch.render import tiled_rasterizer as tr

    args = [torch.as_tensor(a, device=cuda) for a in _faces(np.random.default_rng(3), 4, 500, 64, 64)]
    counts = (tr.SETUP.launches, tr.KERNEL.launches)
    for _ in range(3):
        tr.rasterize_tiles(*args, 64, 64)
    assert (tr.SETUP.launches, tr.KERNEL.launches) == (counts[0] + 3, counts[1] + 3)
    cpu = [a.cpu() for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        tr.SETUP(*cpu, 64, 64)
    assert tr.SETUP.launches == counts[0] + 3


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


def test_pick_single_ycb_state_step_makes_no_sync(cuda):
    """PickSingleYCB-v1 state on the card (a different convex-hull object in
    each env): a control step makes no host sync; the state stays finite and
    no contact is dropped."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make

    n = 16
    env = make("PickSingleYCB-v1", num_envs=n, obs_mode="state", control_mode="pd_joint_delta_pos",
               device=cuda)
    base = env.unwrapped
    zero = torch.zeros(n, 8, device=cuda)
    env.reset(seed=0)
    env.step(zero)  # builds the lazy tables (contact signs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        obs, *_ = env.step(zero)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    data = base.scene.data
    assert base.scene.model.hull_verts.shape[0] == n and len(set(base.model_ids)) > 1
    assert obs.is_cuda and torch.isfinite(obs).all()
    assert torch.isfinite(data.qpos).all() and torch.isfinite(data.qvel).all()
    assert data.contact.overflow.tolist() == [0] * n


@pytest.mark.parametrize("env_id", ["OpenCabinetDrawer-v1", "OpenCabinetDoor-v1"])
def test_cabinet_tables_on_card_equal_cpu(cuda, env_id):
    """The procedural cabinets' per-env tables (joint frames, limits, geom
    sizes and offsets, the task's targets and handles) built on the card
    equal those built on the CPU; a control step with the Fetch makes no
    host sync and the state stays finite."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make

    n = 16
    envs = {dev: make(env_id, num_envs=n, obs_mode="state", device=dev) for dev in ("cpu", cuda)}
    cpu, card = envs["cpu"].unwrapped, envs[cuda].unwrapped
    for f in ("body_pos", "dof_limit", "geom_size", "geom_pos"):
        want = getattr(cpu.scene.model, f)
        assert want.shape[0] == n, f
        torch.testing.assert_close(getattr(card.scene.model, f).cpu(), want, rtol=0, atol=0, msg=f)
    for f in ("target_slot", "target_onehot", "handle_local", "slot_limits", "active_mask"):
        torch.testing.assert_close(getattr(card, f).cpu(), getattr(cpu, f), rtol=0, atol=0, msg=f)
    torch.testing.assert_close(card.cabinet.qlimits.cpu(), cpu.cabinet.qlimits, rtol=0, atol=0)
    env = envs[cuda]
    zero = torch.zeros(n, 13, device=cuda)
    env.reset(seed=0)
    env.step(zero)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        obs, reward, *_ = env.step(zero)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    data = card.scene.data
    assert obs.is_cuda and torch.isfinite(obs).all() and torch.isfinite(reward).all()
    assert torch.isfinite(data.qpos).all() and data.contact.overflow.tolist() == [0] * n


@pytest.mark.parametrize("env_id", ["AnymalC-Reach-v1", "MS-HumanoidWalk-v1"])
def test_locomotion_step_makes_no_sync(cuda, env_id):
    """A URDF-loaded quadruped (whose reward reads per-link contact forces)
    and the humanoid (a FREE root over chains of 1e-4 kg dummy bodies) on
    the card: a control step makes no host sync; the obs and state stay
    finite; the per-link forces equal the per-body queries."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make

    n = 16
    env = make(env_id, num_envs=n, obs_mode="state", control_mode="pd_joint_delta_pos", device=cuda)
    base = env.unwrapped
    robot = base.agent.robot
    zero = torch.zeros((n,) + base.single_action_space.shape, device=cuda)
    env.reset(seed=0)
    for _ in range(3):  # builds the lazy tables (contact signs); the humanoid lands
        env.step(zero)
    robot.get_net_contact_forces()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        obs, reward, *_ = env.step(zero)
        forces = robot.get_net_contact_forces()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    data = base.scene.data
    assert obs.is_cuda and torch.isfinite(obs).all() and torch.isfinite(reward).all()
    assert torch.isfinite(data.qpos).all() and torch.isfinite(data.qvel).all()
    assert data.contact.overflow.tolist() == [0] * n
    per_body = torch.stack([base.scene.net_contact_forces_for_bodies([link.body_id]) for link in robot.links], 1)
    torch.testing.assert_close(forces, per_body, rtol=0, atol=1e-4)
    assert forces[..., 2].sum(1).min().item() > 0  # the feet carry the robot


def test_pick_single_ycb_rgb_through_the_kernel(cuda):
    """One PickSingleYCB-v1 rgb frame over per-env hull meshes goes through
    the kernel once per camera; re-rendered through the plain version its
    rgb is equal and the object's segmentation id is present."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.physics.kinematics import geom_poses
    from maniskill_tpu_torch.render import tiled_rasterizer as tr
    from maniskill_tpu_torch.render.rasterizer import tiled_inputs

    n = 4
    env = make("PickSingleYCB-v1", num_envs=n, obs_mode="rgb", control_mode="pd_joint_delta_pos",
               device=cuda)
    base = env.unwrapped
    launches = tr.KERNEL.launches
    obs, _ = env.reset(seed=0)
    assert tr.KERNEL.launches == launches + len(base._sensors)
    cam = base._sensors["base_camera"]
    mesh = cam._get_mesh(tuple(base._hidden_objects))
    assert mesh.verts.ndim == 3 and mesh.verts.shape[0] == n
    gpos, gquat = geom_poses(base.scene.model, base.scene.data)
    inputs = tiled_inputs(mesh, mesh.world_vertices(gpos, gquat), cam._view_matrix(), cam.proj,
                          128, 128, lights=base.scene.lights)
    _, sk, _, dk = tr.rasterize_tiles(*inputs, 128, 128)
    _, sp, rp, dp = tr.rasterize_tiles_ref(*inputs, 128, 128)
    assert int(dp) == int(dk) == 0
    assert torch.equal(sk, sp)
    assert torch.equal((torch.clamp(rp, 0, 1) * 255).to(torch.uint8), obs["sensor_data"]["base_camera"]["rgb"])
    assert bool((sp == base.obj.per_scene_id).any(-1).any(-1).all())


def test_pick_cube_depth_and_segmentation_match_plain(cuda):
    """rgb+depth+segmentation through the kernel: the int16 depth equals the
    plain version's, background (0) included; segmentation agrees."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.physics.kinematics import geom_poses
    from maniskill_tpu_torch.render import tiled_rasterizer as tr
    from maniskill_tpu_torch.render.rasterizer import tiled_inputs

    n = 8
    env = make("PickCube-v1", num_envs=n, obs_mode="rgb+depth+segmentation",
               control_mode="pd_joint_delta_pos", device=cuda)
    base = env.unwrapped
    env.reset(seed=0)
    obs, *_ = env.step(torch.zeros(n, 8, device=cuda))
    cam_obs = obs["sensor_data"]["base_camera"]
    cam = base._sensors["base_camera"]
    mesh = cam._get_mesh(tuple(base._hidden_objects))
    gpos, gquat = geom_poses(base.scene.model, base.scene.data)
    inputs = tiled_inputs(mesh, mesh.world_vertices(gpos, gquat), cam._view_matrix(), cam.proj,
                          128, 128, lights=base.scene.lights)
    zp, sp, _, _ = tr.rasterize_tiles_ref(*inputs, 128, 128)
    valid = sp >= 0
    depth = torch.clamp(torch.where(valid, zp, 0.0) * 1000.0, 0, 32767).to(torch.int16)[..., None]
    assert torch.equal(depth, cam_obs["depth"])
    assert torch.equal(torch.where(valid, sp, 0).to(torch.int16)[..., None], cam_obs["segmentation"])
    assert (cam_obs["depth"] == 0).any() and (cam_obs["depth"] > 0).any()
    assert bool((cam_obs["segmentation"] == base.cube.per_scene_id).any())


def test_compute_ik_on_card(cuda):
    """Kinematics.compute_ik on the card agrees with the CPU within 1e-4 rad
    and never synchronizes the stream."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.agents.controllers.utils.kinematics import Kinematics

    arm = [f"panda_joint{i}" for i in range(1, 8)]
    out = {}
    rng = np.random.default_rng(0)
    q_off = rng.uniform(-0.15, 0.15, (16, 7)).astype(np.float32)
    q_goal_off = rng.uniform(-0.15, 0.15, (16, 7)).astype(np.float32)
    for dev in ("cpu", cuda):
        env = make("PickCube-v1", num_envs=16, obs_mode="state", control_mode="pd_joint_pos", device=dev)
        env.reset(seed=0)
        base = env.unwrapped
        kin = Kinematics(base.scene, base.agent.robot, "panda_hand_tcp", arm)
        q0 = base.scene.data.qpos[:, kin.q_idx] + torch.as_tensor(q_off, device=dev)
        xpos, xquat = kin._fk(q0 + torch.as_tensor(q_goal_off, device=dev))
        target = torch.cat([xpos[:, kin.end_body], xquat[:, kin.end_body]], -1)
        if dev != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            q = kin.compute_ik(target, q0, iterations=40)
        finally:
            if dev != "cpu":
                torch.cuda.set_sync_debug_mode("default")
        out[str(dev)] = q.cpu()
    assert (out["cpu"] - out["cuda"]).abs().max() <= 1e-4


def test_batched_rng_cpu_equals_cuda(cuda):
    """The same seeds draw the same episode on either device: uniforms and
    integers bit for bit; normals (log, sqrt, cos) within 1e-6."""
    from maniskill_tpu_torch.envs.utils.randomization.batched_rng import BatchedRNG

    seeds = torch.tensor([0, 7, -5, 2**40 + 3, 2**31 - 1, 12345])

    def draws(dev):
        rng = BatchedRNG.from_seeds(seeds.to(dev))
        return [rng.uniform(-0.1, 0.1, (2,)), rng.randint(3, 11, size=(5,)), rng.normal(0.0, 0.02, size=(9,)),
                rng.quaternions(lock_x=True, lock_y=True), rng.quaternions()]

    cpu, gpu = draws("cpu"), draws(cuda)
    for a, b in zip(cpu[:2], gpu[:2]):
        assert torch.equal(a, b.cpu())
    for a, b in zip(cpu[2:], gpu[2:]):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-6)


def test_state_train_step_on_card(cuda):
    """One PPO iteration of PickCube-v1 state on the card: finite, and every
    tensor of the iteration stays on the card."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.parallel import train

    n = 64
    env = make("PickCube-v1", num_envs=n, obs_mode="state", device=cuda)
    obs, _ = env.reset(seed=0)
    trainer = train.PPOTrainer(env, train.PPOConfig(rollout_steps=2, update_epochs=2, num_minibatches=2), obs)
    obs, elapsed, metrics = trainer.train_step(obs, torch.zeros(n, dtype=torch.int32, device=cuda))
    assert obs.is_cuda and elapsed.is_cuda and all(v.is_cuda for v in metrics.values())
    assert torch.isfinite(metrics["loss"])
    for k in ("bad_params", "bad_obs", "bad_rewards"):
        assert int(metrics[k]) == 0, k


def test_rotate_valve_rgb_through_the_kernel(cuda):
    """RotateValveLevel2-v1 rgb (per-env spoke sizes in the model, nominal
    visuals) at 4 envs: the kernel runs once per frame, and the last frame
    re-rendered through the plain version is equal."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.physics.kinematics import geom_poses
    from maniskill_tpu_torch.render import tiled_rasterizer as tr
    from maniskill_tpu_torch.render.rasterizer import tiled_inputs

    n = 4
    env = make("RotateValveLevel2-v1", num_envs=n, obs_mode="rgb", device=cuda)
    base = env.unwrapped
    assert base.scene.model.geom_size.shape[0] == n
    launches = tr.KERNEL.launches
    env.reset(seed=0)
    for _ in range(2):
        obs, *_ = env.step(torch.zeros(n, 9, device=cuda))
    assert tr.KERNEL.launches == launches + 3
    rgb = obs["sensor_data"]["base_camera"]["rgb"]
    assert rgb.shape == (n, 128, 128, 3) and rgb.is_cuda
    cam = base._sensors["base_camera"]
    mesh = cam._get_mesh(tuple(base._hidden_objects))
    gpos, gquat = geom_poses(base.scene.model, base.scene.data)
    inputs = tiled_inputs(mesh, mesh.world_vertices(gpos, gquat), cam._view_matrix(), cam.proj,
                          128, 128, lights=base.scene.lights)
    zp, sp, rp, dp = tr.rasterize_tiles_ref(*inputs, 128, 128)
    assert int(dp) == 0
    assert torch.equal((torch.clamp(rp, 0, 1) * 255).to(torch.uint8), rgb)
    valve = {link.per_scene_id for link in base.valve.links}
    seen = torch.isin(sp, torch.tensor(sorted(valve), device=cuda)).sum((1, 2))
    assert (seen > 50).all(), seen


def test_so100_grasp_cube_greenscreen_through_the_kernel(cuda):
    """SO100GraspCube-v1 rgb+segmentation (camera jitter on, the procedural
    overlay) at 16 envs: the kernel runs once per frame; the last frame
    re-rendered through the plain version gives the segmentation obs, and
    the composite equals where(keep[seg], plain rgb, overlay); the cube and
    the robot are in view in every env."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.physics.kinematics import geom_poses
    from maniskill_tpu_torch.render import tiled_rasterizer as tr
    from maniskill_tpu_torch.render.rasterizer import tiled_inputs

    n = 16
    env = make("SO100GraspCube-v1", num_envs=n, obs_mode="rgb+segmentation", device=cuda,
               greenscreen_overlay_path="/nonexistent/greenscreen.png")
    base = env.unwrapped
    assert base.overlay_sources == {"base_camera": "procedural"}
    launches = tr.KERNEL.launches
    env.reset(seed=0)
    for _ in range(2):
        obs, *_ = env.step(torch.zeros(n, 6, device=cuda))
    assert tr.KERNEL.launches == launches + 3
    cam_obs = obs["sensor_data"]["base_camera"]
    rgb, seg = cam_obs["rgb"], cam_obs["segmentation"]
    assert rgb.shape == (n, 128, 128, 3) and rgb.dtype == torch.uint8 and rgb.is_cuda
    cam = base._sensors["base_camera"]
    mesh = cam._get_mesh(tuple(base._hidden_objects))
    gpos, gquat = geom_poses(base.scene.model, base.scene.data)
    inputs = tiled_inputs(mesh, mesh.world_vertices(gpos, gquat), cam._view_matrix(), cam.proj,
                          128, 128, lights=base.scene.lights)
    _, sp, rp, dp = tr.rasterize_tiles_ref(*inputs, 128, 128)
    assert int(dp) == 0
    plain_seg = torch.where(sp >= 0, sp, 0)
    assert torch.equal(plain_seg.to(torch.int16), seg[..., 0])
    raw = (torch.clamp(rp, 0, 1) * 255).to(torch.uint8)
    keep = base._keep_lut[plain_seg.long()][..., None]
    assert torch.equal(torch.where(keep, raw, base._rgb_overlay_images["base_camera"][None]), rgb)
    for ids in ([base.cube.per_scene_id], [link.per_scene_id for link in base.agent.robot.links]):
        seen = torch.isin(sp, torch.tensor(ids, device=cuda)).sum((1, 2))
        assert (seen > 0).all(), seen


def test_bridge_twin_rgb_segmentation_through_the_kernel(cuda):
    """PutCarrotOnPlateInScene-v1 rgb+segmentation at 4 envs, its 640x480
    camera (30 bands of 16 rows): the kernel runs once per frame; on the last
    frame's inputs it is bit-equal to the plain version (1/z, seg, rgb), the
    segmentation obs is the plain version's, the composite equals
    where(keep[seg], plain rgb, overlay), and the carrot and the robot are in
    view in every env."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.physics.kinematics import geom_poses
    from maniskill_tpu_torch.render import tiled_rasterizer as tr
    from maniskill_tpu_torch.render.rasterizer import tiled_inputs

    n, H, W, cam_name = 4, 480, 640, "3rd_view_camera"
    env = make("PutCarrotOnPlateInScene-v1", num_envs=n, obs_mode="rgb+segmentation", device=cuda)
    base = env.unwrapped
    assert base.overlay_sources == {cam_name: "procedural"}
    launches = tr.KERNEL.launches
    env.reset(seed=0)
    action = torch.zeros(n, 7, device=cuda)
    action[:, 2], action[:, 6] = -0.01, -1.0
    obs, *_ = env.step(action)
    assert tr.KERNEL.launches == launches + 2
    cam_obs = obs["sensor_data"][cam_name]
    rgb, seg = cam_obs["rgb"], cam_obs["segmentation"]
    assert rgb.shape == (n, H, W, 3) and rgb.dtype == torch.uint8 and rgb.is_cuda
    cam = base._sensors[cam_name]
    mesh = cam._get_mesh(tuple(base._hidden_objects))
    gpos, gquat = geom_poses(base.scene.model, base.scene.data)
    inputs = tiled_inputs(mesh, mesh.world_vertices(gpos, gquat), cam._view_matrix(), cam.proj, H, W,
                          lights=base.scene.lights)
    zk, sk, rk, dk = tr.rasterize_tiles(*inputs, H, W)
    zp, sp, rp, dp = tr.rasterize_tiles_ref(*inputs, H, W)
    assert int(dk) == int(dp) == 0
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32)) and torch.equal(sk, sp) and torch.equal(rk, rp)
    plain_seg = torch.where(sp >= 0, sp, 0)
    assert torch.equal(plain_seg.to(torch.int16), seg[..., 0])
    raw = (torch.clamp(rp, 0, 1) * 255).to(torch.uint8)
    keep = base._keep_lut[plain_seg.long()][..., None]
    assert torch.equal(torch.where(keep, raw, base._rgb_overlay_images[cam_name][None]), rgb)
    carrot = [base.objs["bridge_carrot_generated_modified"].per_scene_id]
    for ids in (carrot, [link.per_scene_id for link in base.agent.robot.links]):
        seen = torch.isin(sp, torch.tensor(ids, device=cuda)).sum((1, 2))
        assert (seen > 0).all(), seen


def test_drive_step_on_card_equals_cpu(cuda):
    """PushCube-v1 with a world-anchored drive on the cube (as the drag CLI
    builds it) at 16 envs on the card and on the CPU from one state, the
    target lifted 0.1 m: the drive's control step makes no host sync, and
    after 2 steps qpos agrees within 1e-5."""
    from maniskill_tpu_torch.examples.teleoperation.drag_object import _DragEnvFactory

    n = 16
    envs = []
    for dev in (cuda, torch.device("cpu")):
        factory = _DragEnvFactory("PushCube-v1", "cube")
        env = factory.make(num_envs=n, obs_mode="state", device=dev)
        env.reset(seed=0)
        envs.append((env, factory.drive))
    (card, dcard), (cpu, dcpu) = envs
    state = card.get_state_dict()

    def to_cpu(x):
        return {k: to_cpu(v) for k, v in x.items()} if isinstance(x, dict) else x.cpu()

    cpu.reset(options=dict(reset_to_env_states=to_cpu(state)))
    target = card.obj.pose.raw_pose.clone()
    target[:, 2] += 0.1
    dcard.set_drive_target(target)
    dcpu.set_drive_target(target.cpu())
    zero = torch.zeros((n,) + tuple(card.single_action_space.shape), device=cuda)
    card.step(zero)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card.step(zero)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for _ in range(2):
        cpu.step(zero.cpu())
    torch.testing.assert_close(card.scene.data.qpos.cpu(), cpu.scene.data.qpos, rtol=0, atol=1e-5)
    assert bool((card.obj.pose.p[:, 2] > 0.03).all())


def test_stereo_depth_camera_through_the_kernel(cuda):
    """StereoDepthCamera on PickCube-v1 at 8 envs, 96x128: each get_obs
    launches the kernel twice (left and right eye); the int16 depth equals
    the plain version's through the same stereo code, and some foreground
    pixels are occlusion shadows."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.physics.kinematics import geom_poses
    from maniskill_tpu_torch.render import tiled_rasterizer as tr
    from maniskill_tpu_torch.render.rasterizer import tiled_inputs
    from maniskill_tpu_torch.sensors.depth_camera import StereoDepthCamera, StereoDepthCameraConfig, stereo_depth
    from maniskill_tpu_torch.utils.scene_utils import look_at

    n, H, W = 8, 96, 128
    env = make("PickCube-v1", num_envs=n, obs_mode="state", device=cuda)
    env.reset(seed=0)
    scene = env.unwrapped.scene
    pose = look_at([0.35, 0.3, 0.35], [0.0, 0.0, 0.05])
    cam = StereoDepthCamera(StereoDepthCameraConfig("stereo", pose, W, H, np.pi / 3, 0.01, 10.0), scene)
    launches = tr.KERNEL.launches
    obs = cam.get_obs(rgb=True, depth=True, segmentation=True)
    assert tr.KERNEL.launches == launches + 2
    mesh = cam._get_mesh()
    wv = mesh.world_vertices(*geom_poses(scene.model, scene.data))
    z = []
    for view in (cam._view_matrix(), cam.right_view_matrix()):
        zb, seg, _, _ = tr.rasterize_tiles_ref(*tiled_inputs(mesh, wv, view, cam.proj, H, W, lights=scene.lights),
                                               H, W)
        z.append(torch.where(seg >= 0, zb, 0.0))
    plain = stereo_depth(z[0], z[1], cam.fx, cam.baseline, cam.disparity_levels)
    assert obs["depth"].dtype == torch.int16 and torch.equal(obs["depth"], plain)
    shadow = (obs["segmentation"] > 0) & (obs["depth"] == 0)
    assert int(shadow.sum()) > 0


def test_rt_fast_frame_on_card_equals_cpu(cuda):
    """PickCube-v1's human camera in the rt-fast pack at 4 envs and 96x128 on
    the card and on the CPU from one state with the same draws (the card's
    render seed's): seg and valid agree on >= 0.999 of the pixels, color and
    depth within 1e-4 where the 3x3 neighbourhood agrees, and the card's
    frame makes no host sync."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.render import pathtracer as tpt

    n, H, W = 4, 96, 128
    cams = dict(human_render_camera_configs=dict(width=W, height=H, shader_pack="rt-fast"))
    card = make("PickCube-v1", num_envs=n, obs_mode="state", device=cuda, **cams).unwrapped
    cpu = make("PickCube-v1", num_envs=n, obs_mode="state", device="cpu", **cams).unwrapped
    card.reset(seed=0)

    def to_cpu(x):
        return {k: to_cpu(v) for k, v in x.items()} if isinstance(x, dict) else x.cpu()

    cpu.reset(options=dict(reset_to_env_states=to_cpu(card.get_state_dict())))
    seed = card.scene.render_seed()
    jitter = torch.stack([tpt.render_draws(seed, s, n, H * W, False)[0] for s in range(2)])
    bufs = []
    for env, dev in ((card, cuda), (cpu, torch.device("cpu"))):
        cam = env._human_render_cameras["render_camera"]
        _, buf = cam.capture(draws=dict(jitter=jitter.to(dev)))
        bufs.append({k: v.cpu() for k, v in buf.items()})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card._human_render_cameras["render_camera"].capture()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    k, c = bufs
    agree = (k["seg"] == c["seg"]) & (k["valid"] == c["valid"])
    assert float(agree.float().mean()) >= 0.999
    near = torch.nn.functional.max_pool2d((~agree).float()[:, None], 3, 1, 1)[:, 0] == 0
    assert float(c["valid"].float().mean()) > 0.2
    for key in ("color", "depth"):
        torch.testing.assert_close(k[key][near], c[key][near], rtol=0, atol=1e-4)


def test_sim2real_sync_on_card_makes_no_sync(cuda):
    """Sim2RealEnv over SO100GraspCube-v1 on the card with a real agent that
    reports a fixed qpos: ``_sync_sim_from_real`` (a pinned host-to-device
    copy, a column write, FK) makes no host sync, and the synced scene's
    qpos and link poses equal the CPU port's after the same sync."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.agents.base_real_agent import BaseRealAgent
    from maniskill_tpu_torch.envs.sim2real_env import Sim2RealEnv

    qpos = np.array([0.1, -0.4, 0.3, 0.2, -0.1, 0.05], np.float32)

    class Fixed(BaseRealAgent):
        def reset(self, qpos=None):
            pass

        def set_target_qpos(self, q):
            pass

        def get_qpos(self):
            return qpos

    envs = []
    for dev in (cuda, torch.device("cpu")):
        sim = make("SO100GraspCube-v1", num_envs=1, obs_mode="state", domain_randomization=False, device=dev)
        envs.append(Sim2RealEnv(sim, Fixed(), real_reset_function=lambda env, seed=None, options=None: None,
                                skip_data_checks=True))
    card, cpu = envs

    def to_cpu(x):
        return {k: to_cpu(v) for k, v in x.items()} if isinstance(x, dict) else x.cpu()

    cpu.base_sim_env.set_state_dict(to_cpu(card.base_sim_env.get_state_dict()))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card._sync_sim_from_real()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cpu._sync_sim_from_real()
    k, c = card.base_sim_env, cpu.base_sim_env
    torch.testing.assert_close(k.agent.robot.qpos.cpu()[0], torch.as_tensor(qpos), rtol=0, atol=1e-6)
    torch.testing.assert_close(k.scene.data.qpos.cpu(), c.scene.data.qpos, rtol=0, atol=1e-6)
    torch.testing.assert_close(k.agent.tcp_pose.raw_pose.cpu(), c.agent.tcp_pose.raw_pose, rtol=0, atol=1e-5)
