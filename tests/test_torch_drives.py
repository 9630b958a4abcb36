"""Parity of the port's body-body 6-dof drives with the JAX package.

- ``drive_wrenches`` against ``maniskill_tpu.physics.drives.drive_wrenches``
  on random ``Data`` at 1e-5 (relative to the largest wrench), on a scene
  with a world-anchored drive, two drives on one body, a link-to-link drive
  on an articulation, a body whose COM is off its origin, and a drive at
  rest (its wrench 0, no NaN anywhere);
- the JAX test's cube drag (tests/test_physics.py::
  test_body_drive_pulls_to_target, 300 substeps) in both packages: qpos
  within 1e-4;
- ``Drive.set_drive_target`` under a partial-reset mask, ``set_drive_property``
  and the articulation's joint-drive API against the JAX package's;
- both teleoperation CLIs with ``_read_key`` fed a key script, and
  ``interactive_panda``'s browser front end fed one posted key.
"""
import numpy as np
import pytest
import torch

from maniskill_tpu_torch import physics as tphys
from maniskill_tpu_torch.envs.scene import ManiSkillScene as TScene
from maniskill_tpu_torch.physics.drives import drive_wrenches as t_drive_wrenches
from maniskill_tpu_torch.physics.kinematics import forward_kinematics_raw
from tests.test_torch_common import f32_reference_solver, one_torch_thread  # noqa: F401

B = 3
WRENCH_TOL = 1e-5
DRAG_QPOS_TOL = 1e-4
YAW = np.array([np.cos(0.35), 0, 0, np.sin(0.35)])
REST_POSE = np.concatenate([[0.3, -0.2, 0.05], YAW])


def build_scene(scene):
    """Ground, a cube whose collision box sits off its origin (COM offset),
    a sphere, a two-link arm, and five drives (returned in order)."""
    from maniskill_tpu_torch.building.articulation_builder import LinkSpec, ShapeSpec
    from maniskill_tpu_torch.physics.types import BOX, HINGE

    g = scene.create_actor_builder()
    g.add_plane_collision()
    g.build_static(name="ground")
    b = scene.create_actor_builder()
    b.add_box_collision([0.03, 0.01, 0.0], half_size=[0.02] * 3)
    b.set_initial_pose([0.1, 0.0, 0.2, 1, 0, 0, 0])
    cube = b.build(name="cube")
    b = scene.create_actor_builder()
    b.add_sphere_collision(radius=0.03)
    b.set_initial_pose(REST_POSE)
    ball = b.build(name="ball")
    ab = scene.create_articulation_builder()
    box = [ShapeSpec(BOX, (0.02, 0.02, 0.1), (0, 0, 0.1))]
    ab.add_link(LinkSpec("base", None, collisions=box))
    ab.add_link(LinkSpec("l1", "base", HINGE, "j1", origin_pos=(0, 0, 0.2), axis=(0, 1, 0), limit=(-2, 2),
                         collisions=box))
    ab.add_link(LinkSpec("l2", "l1", HINGE, "j2", origin_pos=(0, 0, 0.2), axis=(1, 0, 0), limit=(-1, 1.5),
                         collisions=box))
    ab.set_initial_pose([-0.4, 0, 0, 1, 0, 0, 0])
    arm = ab.build("arm")
    l1, l2 = arm.links[1], arm.links[2]
    drives = [
        scene.create_drive(None, None, cube, None, stiffness=(200.0, 5.0), damping=(20.0, 0.5),
                           force_limit=(50.0, 5.0)),
        scene.create_drive(None, [0.1, 0.05, 0.3], cube, [0.01, -0.02, 0.0, *YAW], stiffness=(80.0, 3.0)),
        scene.create_drive(l1, [0.0, 0.0, 0.15], l2, [0.02, 0.0, 0.1], stiffness=(50.0, 2.0),
                           damping=(5.0, 0.2), force_limit=(1e3, 1e3)),
        scene.create_drive(None, REST_POSE, ball, None),  # at rest in the default state
        scene.create_drive(cube, None, ball, [0.0, 0.0, 0.02]),
    ]
    return cube, ball, arm, drives


@pytest.fixture(scope="module")
def scenes():
    from maniskill_tpu.envs.scene import ManiSkillScene as JScene

    js, ts = JScene(num_envs=B), TScene(num_envs=B, device="cpu")
    jparts, tparts = build_scene(js), build_scene(ts)
    js.finalize()
    ts.finalize()
    return js, ts, jparts, tparts


def test_drive_tables_match_and_the_com_is_offset(scenes):
    js, ts, (jcube, *_), _ = scenes
    jm, tm = js.model, ts.model
    for f in ("drive6_body1", "drive6_body2", "drive6_pose1", "drive6_pose2", "drive6_stiffness",
              "drive6_damping", "drive6_force_limit", "body_ipos", "body_mass", "body_inertia"):
        np.testing.assert_allclose(np.asarray(getattr(tm, f)), np.asarray(getattr(jm, f)), rtol=0, atol=1e-6,
                                   err_msg=f)
    assert tm.drive6_body1.tolist().count(0) == 3  # world-anchored
    assert list(tm.drive6_body2).count(jcube.body_id) == 2  # two drives on one body
    assert np.abs(np.asarray(tm.body_ipos)[jcube.body_id]).max() > 0.01


def _random_state(model, rng):
    q = tphys.default_qpos(model) + rng.normal(0, 0.1, model.nq).astype(np.float32)
    q = np.broadcast_to(q, (B, model.nq)) + rng.normal(0, 0.05, (B, model.nq)).astype(np.float32)
    q = np.array(q, np.float32)
    for b in range(model.nbody):
        if model.body_jnt_type[b] == tphys.FREE:
            a = model.body_q_adr[b] + 3
            q[:, a:a + 4] /= np.linalg.norm(q[:, a:a + 4], axis=-1, keepdims=True)
    v = rng.normal(0, 0.5, (B, model.nv)).astype(np.float32)
    nd = len(model.drive6_body1)
    tgt = np.concatenate([rng.normal(0, 0.1, (B, nd, 3)), rng.normal(0, 1, (B, nd, 4))], -1).astype(np.float32)
    tgt[..., 3:] /= np.linalg.norm(tgt[..., 3:], axis=-1, keepdims=True)
    return q, v, tgt


def _wrenches(js, ts, q, v, tgt):
    import jax
    import jax.numpy as jnp
    from maniskill_tpu import physics as jphys
    from maniskill_tpu.physics.drives import drive_wrenches as j_drive_wrenches
    from maniskill_tpu.physics.kinematics import forward_kinematics_cf

    jm = js.model
    jd = jphys.make_data(jm, B)

    @jax.jit
    def run(q, v, t):
        d = jd.replace(qpos=q, qvel=v, drive6_target=t)
        return j_drive_wrenches(jm, d, forward_kinematics_cf(jm, q, v))

    want = np.asarray(run(jnp.asarray(q), jnp.asarray(v), jnp.asarray(tgt)))
    tm = ts.model
    q_t, v_t = torch.as_tensor(q), torch.as_tensor(v)
    td = tphys.make_data(tm, B).replace(qpos=q_t, qvel=v_t, drive6_target=torch.as_tensor(tgt))
    got = t_drive_wrenches(tm, td, forward_kinematics_raw(tm, q_t, v_t)).numpy()
    return got, want


def test_drive_wrenches_match_reference(scenes):
    js, ts, _, _ = scenes
    got, want = _wrenches(js, ts, *_random_state(ts.model, np.random.default_rng(0)))
    assert np.isfinite(got).all() and np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=WRENCH_TOL * np.abs(want).max())


def test_drive_at_rest_gives_no_wrench_and_no_nan(scenes):
    js, ts, _, (_, tball, _, _) = scenes
    tm = ts.model
    q = np.broadcast_to(tphys.default_qpos(tm), (B, tm.nq)).astype(np.float32).copy()
    adr = int(tm.body_q_adr[tball.body_id])
    q[:, adr:adr + 7] = REST_POSE  # the rest drive's frames coincide
    v = np.zeros((B, tm.nv), np.float32)
    tgt = np.broadcast_to(np.array([0, 0, 0, 1, 0, 0, 0], np.float32), (B, len(tm.drive6_body1), 7)).copy()
    got, want = _wrenches(js, ts, q, v, tgt)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=WRENCH_TOL * np.abs(want).max())
    # the ball's wrench is the rest drive's plus the cube-ball drive's; drop
    # the second by zeroing its gains
    tm0 = tm.replace(drive6_stiffness=tm.drive6_stiffness * torch.tensor([1, 1, 1, 1, 0.0])[:, None])
    td = tphys.make_data(tm0, B).replace(qpos=torch.as_tensor(q))
    w = t_drive_wrenches(tm0, td, forward_kinematics_raw(tm0, td.qpos, td.qvel))
    assert bool(torch.isfinite(w).all()) and float(w[:, tball.body_id].abs().max()) < 1e-5


def _drag_scene(scene):
    b = scene.create_actor_builder()
    b.add_plane_collision()
    b.build_static(name="ground")
    bb = scene.create_actor_builder()
    bb.add_box_collision(half_size=[0.02] * 3)
    bb.set_initial_pose([0, 0, 0.02, 1, 0, 0, 0])
    cube = bb.build(name="cube")
    drive = scene.create_drive(None, None, cube, None, stiffness=(200.0, 5.0), damping=(20.0, 0.5),
                               force_limit=(50.0, 5.0))
    return cube, drive


def test_cube_drag_matches_reference(f32_reference_solver):  # noqa: F811
    import jax
    import jax.numpy as jnp
    from maniskill_tpu import physics as jphys
    from maniskill_tpu.envs.scene import ManiSkillScene as JScene

    n = 2
    js, ts = JScene(num_envs=n), TScene(num_envs=n, device="cpu")
    (jcube, jdrive), (tcube, tdrive) = _drag_scene(js), _drag_scene(ts)
    jm, tm = js.finalize(), ts.finalize()
    adr = int(tm.body_q_adr[tcube.body_id])
    q0 = tphys.default_qpos(tm)
    q0[adr:adr + 7] = [0, 0, 0.02, 1, 0, 0, 0]
    target = [0.2, 0.1, 0.3, 1, 0, 0, 0]

    jd = jphys.make_data(jm, n)
    js.bind(jd.replace(qpos=jnp.broadcast_to(jnp.asarray(q0), jd.qpos.shape)))
    jdrive.set_drive_target(jnp.asarray(target))

    @jax.jit
    def run(d):
        d = jphys.forward(jm, d)  # primes the contact pytree of the scan's carry
        return jax.lax.scan(lambda d, _: (jphys.step(jm, d), None), d, None, length=300)[0]

    want = np.asarray(run(js.data).qpos)

    td = tphys.make_data(tm, n)
    ts.bind(td.replace(qpos=torch.as_tensor(q0).expand(n, tm.nq).clone()))
    tdrive.set_drive_target(np.asarray(target, np.float32))
    d = tphys.forward(tm, ts.data)
    for _ in range(300):
        d = tphys.step(tm, d)
    got = d.qpos.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=DRAG_QPOS_TOL)
    np.testing.assert_allclose(got[:, adr:adr + 2], [[0.2, 0.1]] * n, atol=0.01)


def test_masked_drive_target_and_drive_property_match_reference(scenes):
    import jax.numpy as jnp
    from maniskill_tpu import physics as jphys

    js, ts, (_, _, _, jdrives), (_, _, _, tdrives) = scenes
    js.bind(jphys.make_data(js.model, B))
    ts.bind(tphys.make_data(ts.model, B))
    rng = np.random.default_rng(1)
    for k in range(2):
        pose = np.concatenate([rng.normal(0, 0.1, (B, 3)), rng.normal(0, 1, (B, 4))], -1).astype(np.float32)
        pose[:, 3:] /= np.linalg.norm(pose[:, 3:], axis=-1, keepdims=True)
        mask = np.array([True, False, True]) if k else None
        js._reset_mask = None if mask is None else jnp.asarray(mask)
        ts._reset_mask = None if mask is None else torch.as_tensor(mask)
        jdrives[1].set_drive_target(jnp.asarray(pose))
        tdrives[1].set_drive_target(torch.as_tensor(pose))
        np.testing.assert_array_equal(ts.data.drive6_target.numpy(), np.asarray(js.data.drive6_target))
        np.testing.assert_array_equal(tdrives[1].drive_target.raw_pose.numpy(),
                                      np.asarray(jdrives[1].drive_target.raw_pose))
    # the masked-out env kept the first pose
    assert not np.allclose(ts.data.drive6_target[1, 1].numpy(), pose[1])
    js._reset_mask = ts._reset_mask = None
    for dj, dt in ((jdrives[2], tdrives[2]), (jdrives[0], tdrives[0])):
        kw = dict(stiffness=123.0, angular_stiffness=4.5, damping=6.0, angular_damping=0.7, force_limit=(9.0, 2.0))
        dj.set_drive_property(**kw)
        dt.set_drive_property(**kw)
    for f in ("drive6_stiffness", "drive6_damping", "drive6_force_limit"):
        np.testing.assert_array_equal(getattr(ts.model, f).numpy(), np.asarray(getattr(js.model, f)), err_msg=f)


def test_joint_drive_api_matches_reference(scenes):
    import jax.numpy as jnp
    from maniskill_tpu import physics as jphys

    js, ts, (_, _, jarm, _), (_, _, tarm, _) = scenes
    js.bind(jphys.make_data(js.model, B))
    ts.bind(tphys.make_data(ts.model, B))
    assert tarm.max_dof == jarm.max_dof == 2
    assert tarm.get_link("l2").body_id == jarm.get_link("l2").body_id
    rng = np.random.default_rng(2)
    t = rng.normal(0, 1, (B, 2)).astype(np.float32)
    for arm, arr in ((jarm, jnp.asarray), (tarm, torch.as_tensor)):
        arm.set_joint_drive_targets(arr(t))
        arm.set_joint_drive_velocity_targets(arr(t[:, ::-1].copy()))
        arm.set_joint_drive_targets(arr(t[:, :1] * 3), joints=[arm.active_joints[1]])
        arm.active_joints[0].set_drive_target(0.25)
        arm.active_joints[1].set_drive_velocity_target(arr(t[:, 0]))
        arm.active_joints[1].set_drive_properties(40.0, 4.0, 12.0)
    np.testing.assert_array_equal(tarm.drive_targets.numpy(), np.asarray(jarm.drive_targets))
    np.testing.assert_array_equal(tarm.drive_velocity_targets.numpy(), np.asarray(jarm.drive_velocity_targets))
    for j in range(2):
        np.testing.assert_array_equal(tarm.active_joints[j].drive_target.numpy(),
                                      np.asarray(jarm.active_joints[j].drive_target))
        np.testing.assert_array_equal(tarm.active_joints[j].limits.numpy(), np.asarray(jarm.active_joints[j].limits))
    for f in ("drive_kp", "drive_kd", "drive_force_limit"):
        np.testing.assert_array_equal(getattr(ts.model, f).numpy(), np.asarray(getattr(js.model, f)), err_msg=f)


def _keys(monkeypatch, module, script):
    it = iter(script)
    monkeypatch.setattr(module, "_read_key", lambda: next(it))


def test_drag_object_cli_follows_the_keys(monkeypatch, tmp_path):
    from maniskill_tpu_torch.examples.teleoperation import drag_object

    _keys(monkeypatch, drag_object, "rrrrr" + "wwwww" + "q")
    out = drag_object.main(["--device", "cpu"])
    tg, pos = out["targets"], out["positions"]
    assert tg.shape == pos.shape == (10, 3)
    np.testing.assert_allclose(tg[-1] - tg[0], [0.1, 0.0, 0.08], atol=1e-6)
    assert pos[-1, 0] - pos[4, 0] > 0.07 and pos[4, 2] - pos[0, 2] > 0.05
    assert np.abs(pos[-1] - tg[-1]).max() < 0.01
    # one step with its frame saved (a PNG, or .npy without Pillow)
    _keys(monkeypatch, drag_object, "aq")
    drag_object.main(["--device", "cpu", "--save-frames", str(tmp_path)])
    assert [p.name for p in tmp_path.iterdir()] in (["00001.png"], ["00001.npy"])


def test_interactive_panda_cli_moves_the_tcp(monkeypatch):
    from maniskill_tpu_torch.examples.teleoperation import interactive_panda

    _keys(monkeypatch, interactive_panda, "wwrrgq")
    out = interactive_panda.main(["--device", "cpu"])
    tcp = out["tcp"]
    assert tcp.shape == (5, 3) and np.isfinite(out["reward"]).all()
    assert tcp[1, 0] - tcp[0, 0] > 0.02 and tcp[3, 2] - tcp[1, 2] > 0.02
    # the browser front end (a free port): one posted key, one step
    import json
    import urllib.request

    def post_w(viewer):
        req = urllib.request.Request(f"http://127.0.0.1:{viewer.port}/api/event", method="POST",
                                     data=json.dumps({"type": "key", "key": "w"}).encode())
        urllib.request.urlopen(req, timeout=30).close()

    out = interactive_panda.main(["--device", "cpu", "--browser", "0", "--max-steps", "1"], on_start=post_w)
    assert out["tcp"].shape == (1, 3) and out["tcp"][0, 0] - out["tcp0"][0] > 0.02
