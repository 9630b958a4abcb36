"""PegInsertionSide-v1's per-env geometry in the port against the JAX
package, at 4 envs on the CPU (one JAX env, made once with its solver's bf16
cast made an identity).

Both packages draw the per-env peg half-sizes and hole radii with numpy
from ``geometry_seed=5``, so they hold the same arrays.
- The per-env tables: ``geom_size`` and ``geom_pos`` (B, G, 3) equal the JAX
  package's; the JAX ``Model`` bridged through ``model_from_numpy`` carries
  them across unchanged; the port's ``_after_reconfigure`` fed the JAX
  env's drawn arrays writes the same tables.
- ``geom_poses_from`` with the (B, G, 3) ``geom_pos`` against the JAX
  ``geom_poses`` on the same poses, within 1e-6 m.
- Each peg set halfway into its own hole (its head at the hole's mid-plane,
  1 mm off its axis in y and -2 mm in z): ``physics.forward``'s peg-plate
  contact rows, the live mask equal and depth, pos and normal within 1e-6.
- 3 control steps of the same random ``pd_joint_pos`` actions (the arm's
  joints within 0.05 rad of where they are, the gripper anywhere) from a
  settled state (the port's reset and 8 steps holding the arm, bridged
  into the JAX env): obs and the normalized dense reward within 1e-4.
- One rgb frame of the base camera: the render mesh equals the JAX
  package's (nominal visuals in every env, as the JAX package draws them),
  segmentation agrees on >= 0.999 of the pixels and rgb is equal where it
  agrees.
- ``solve_peg_insertion_side``'s and ``solve_plug_charger``'s first two
  target poses (PegInsertionSide: the hover above the grasp and the grasp;
  PlugCharger: the pass above the receptacle and the hover) from one bridged
  state: positions within 1e-5 m and quaternions within 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu import physics as jphys
from maniskill_tpu.physics.kinematics import geom_poses as jgeom_poses
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch import physics as tphys
from maniskill_tpu_torch.physics.kinematics import geom_poses_from

from test_torch_common import f32_reference_solver, numpy_fields, one_torch_thread, tree  # noqa: F401

B = 4
UID = "PegInsertionSide-v1"
KW = dict(num_envs=B, obs_mode="state_dict", control_mode="pd_joint_pos", geometry_seed=5)
DEAD = -1e5  # depth below this is a BAD_DEPTH row
HOLE_OFFSET = (0.001, -0.002)  # the peg's axis off the hole's, in the block's y and z (m)


def _state(src):
    return tree(src, lambda v: torch.as_tensor(np.array(v)))


@pytest.fixture(scope="module")
def envs(f32_reference_solver):
    """(JAX env, port env), the port set to the JAX env's state after the
    reset inside make."""
    je = jmake(UID, **KW)
    te = tmake(UID, device="cpu", **KW)
    te.reset(seed=3, options=dict(reset_to_env_states=_state(je.unwrapped.get_state_dict())))
    return je, te


def peg_in_hole_qpos(base):
    """The port's qpos with each env's peg halfway into its own hole."""
    L = base.peg_half_sizes[:, 0]
    off = torch.zeros(base.num_envs, 7)
    off[:, 0] = -L
    off[:, 1], off[:, 2] = HOLE_OFFSET
    off[:, 3] = 1.0
    peg = base.box.pose * off
    qpos = base.scene.data.qpos.clone()
    qa = base.peg._q_adr
    qpos[:, qa:qa + 7] = peg.raw_pose
    return qpos


def test_per_env_tables_match_reference(envs):
    je, te = envs
    jb, tb = je.unwrapped, te.unwrapped
    jm, tm = jb.scene.model, tb.scene.model
    assert tm.geom_pos.shape == tm.geom_size.shape == (B, tm.ngeom, 3)
    np.testing.assert_array_equal(tb.peg_half_sizes.numpy(), np.asarray(jb.peg_half_sizes))
    np.testing.assert_array_equal(tb.box_hole_radii.numpy(), np.asarray(jb.box_hole_radii))
    for f in ("geom_size", "geom_pos"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), err_msg=f)
        bridged = tphys.model_from_numpy(numpy_fields(jm), "cpu")
        np.testing.assert_array_equal(getattr(bridged, f).numpy(), np.asarray(getattr(jm, f)), err_msg=f)
    # the sizes differ per env, the plates' offsets follow the hole radius
    peg_gid = int(tb.peg.geom_ids[0])
    assert len(np.unique(tm.geom_size[:, peg_gid, 0].numpy())) == B
    # the port's _after_reconfigure, fed the JAX env's drawn arrays, writes
    # the same tables
    fresh = tmake(UID, device="cpu", **dict(KW, geometry_seed=11)).unwrapped
    assert not np.array_equal(fresh.scene.model.geom_size.numpy(), np.asarray(jm.geom_size))
    fresh._host_peg_half_sizes = np.asarray(jb.peg_half_sizes)
    fresh._host_hole_radii = np.asarray(jb.box_hole_radii)
    fresh._after_reconfigure({})
    for f in ("geom_size", "geom_pos"):
        np.testing.assert_array_equal(getattr(fresh.scene.model, f).numpy(), np.asarray(getattr(jm, f)), err_msg=f)


def test_geom_poses_with_per_env_offsets_match_reference(envs):
    """``geom_poses_from`` over a (B, G, 3) ``geom_pos`` against the JAX
    ``geom_poses``, the pegs in their holes: within 1e-6 m."""
    je, te = envs
    jb, tb = je.unwrapped, te.unwrapped
    qpos = peg_in_hole_qpos(tb)
    jd = jax.jit(jphys.forward)(jb.scene.model, jb.scene.data.replace(qpos=jax.numpy.asarray(qpos.numpy())))
    jpos, jquat = jax.jit(jgeom_poses)(jb.scene.model, jd)
    tpos, tquat = geom_poses_from(tb.scene.model, torch.as_tensor(np.array(jd.xpos)),
                                  torch.as_tensor(np.array(jd.xquat)))
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tquat.numpy(), np.asarray(jquat), rtol=0, atol=1e-6)
    # the plates sit at their env's offsets: per env, not the nominal ones
    hole = [int(g) for g in tb.box.geom_ids if tb.scene.mb.geoms[g].collision][:4]
    nominal = tphys.geom_poses(dataclasses.replace(tb.scene.model, geom_pos=tb.scene.model.geom_pos[0]),
                               tb.scene.data)[0]
    assert not torch.allclose(tpos[1:, hole], nominal[1:, hole])


def test_peg_in_hole_contacts_match_reference(envs):
    """With each peg halfway into its own hole, ``physics.forward``'s
    peg-plate contact rows equal: the live mask, and depth, pos and normal
    within 1e-6."""
    je, te = envs
    jb, tb = je.unwrapped, te.unwrapped
    qpos = peg_in_hole_qpos(tb)
    jc = jax.jit(jphys.forward)(jb.scene.model, jb.scene.data.replace(qpos=jax.numpy.asarray(qpos.numpy()))).contact
    tc = tphys.forward(tb.scene.model, tb.scene.data.replace(qpos=qpos)).contact
    gb = np.asarray(tb.scene.model.geom_body)
    np.testing.assert_array_equal(tc.geom1, np.asarray(jc.geom1))
    np.testing.assert_array_equal(tc.geom2, np.asarray(jc.geom2))
    bodies = {gb[tc.geom1[k]] for k in range(len(tc.geom1))} | {gb[tc.geom2[k]] for k in range(len(tc.geom2))}
    assert {tb.peg.body_id, tb.box.body_id} <= bodies
    pair = ((gb[tc.geom1] == tb.peg.body_id) & (gb[tc.geom2] == tb.box.body_id)) | (
        (gb[tc.geom1] == tb.box.body_id) & (gb[tc.geom2] == tb.peg.body_id))
    tdepth, jdepth = tc.depth.numpy()[:, pair], np.asarray(jc.depth)[:, pair]
    live = jdepth > DEAD
    np.testing.assert_array_equal(tdepth > DEAD, live)
    assert (live.sum(1) > 0).all() and (tdepth[live] > -0.01).any()
    for k in ("depth", "pos", "normal"):
        np.testing.assert_allclose(getattr(tc, k).numpy()[:, pair][live], np.asarray(getattr(jc, k))[:, pair][live],
                                   rtol=0, atol=1e-6, err_msg=k)


def test_settled_steps_match_reference(envs):
    """3 control steps of the same random actions from a settled state."""
    je, te = envs
    jb, tb = je.unwrapped, te.unwrapped
    te.reset(seed=2022)
    hold = torch.cat([tb.agent.robot.qpos[:, :7], torch.ones(B, 1)], -1)
    for _ in range(8):
        te.step(hold)
    state = tb.get_state_dict()
    jobs, _ = je.reset(seed=2022, options=dict(reset_to_env_states=tree(state, lambda v: jax.numpy.asarray(v.numpy()))))
    tobs, _ = te.reset(seed=2022, options=dict(reset_to_env_states=state))
    rng = np.random.default_rng(11)
    arm = tb.agent.robot.qpos[:, :7].numpy()
    for _ in range(3):
        action = np.concatenate([arm + rng.uniform(-0.05, 0.05, (B, 7)), rng.uniform(-1, 1, (B, 1))], 1)
        action = action.astype(np.float32)
        jobs, jrew, _, _, jinfo = je.step(action)
        tobs, trew, _, _, tinfo = te.step(torch.as_tensor(action))
    for path, jv in jax.tree_util.tree_leaves_with_path(jobs):
        tv = tobs
        for p in path:
            tv = tv[p.key]
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-4, err_msg=f"obs{path}")
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tinfo["success"].numpy(), np.asarray(jinfo["success"]))
    assert tb.scene.data.contact.overflow.tolist() == [0] * B


def test_rgb_frame_matches_reference(envs):
    from maniskill_tpu_torch.physics.kinematics import geom_poses
    from maniskill_tpu_torch.render.rasterizer import rasterize

    je, _ = envs
    jb = je.unwrapped
    te = tmake(UID, device="cpu", **dict(KW, obs_mode="rgb"))
    te.reset(seed=0, options=dict(reset_to_env_states=_state(jb.get_state_dict())))
    tb = te.unwrapped
    jcam, tcam = jb._sensors["base_camera"], tb._sensors["base_camera"]
    jmesh = jcam._get_mesh(tuple(jb._hidden_objects))
    tmesh = tcam._get_mesh(tuple(tb._hidden_objects))
    # nominal visuals: one vertex table for every env, equal to the JAX one
    np.testing.assert_array_equal(tmesh.verts.numpy(), np.asarray(jmesh.verts))
    np.testing.assert_array_equal(tmesh.faces, np.asarray(jmesh.faces))
    np.testing.assert_array_equal(tmesh.face_color.numpy(), np.asarray(jmesh.face_color))
    np.testing.assert_array_equal(tmesh.face_seg.numpy(), np.asarray(jmesh.face_seg))

    def jax_frame(data):
        jb.scene.bind(data)
        return jcam.get_obs(rgb=True, segmentation=True, hidden_actors=jb._hidden_objects)

    data = jb.scene.data
    jobs = {k: np.asarray(v) for k, v in jax.jit(jax_frame)(data).items()}
    jb.scene.bind(data)  # the trace left a tracer bound
    gpos, gquat = geom_poses(tb.scene.model, tb.scene.data)
    buf = rasterize(tmesh, tmesh.world_vertices(gpos, gquat), tcam._view_matrix(), tcam.proj, 128, 128,
                    lights=tb.scene.lights)
    tseg = buf["seg"].numpy()
    trgb = tb.get_obs()["sensor_data"]["base_camera"]["rgb"].numpy()
    same = tseg == jobs["segmentation"][..., 0]
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_array_equal(trgb[same], jobs["rgb"][same])
    for actor in (tb.peg, tb.box):
        assert ((tseg == actor.per_scene_id).sum((1, 2)) > 20).all()  # in view in every env


@pytest.mark.parametrize("uid", [UID, "PlugCharger-v1"])
def test_solution_first_moves_match_reference(uid, envs, monkeypatch):
    """The two solutions' first two target poses from one bridged state
    (PegInsertionSide: the module's envs; PlugCharger: its own, made with
    ``pd_joint_pos`` too)."""
    from maniskill_tpu.examples.motionplanning import panda_solver as jps
    from maniskill_tpu.examples.motionplanning import solutions as jsol
    from maniskill_tpu_torch.examples.motionplanning import panda_solver as tps
    from maniskill_tpu_torch.examples.motionplanning import solutions as tsol

    if uid == UID:
        je, te = envs
    else:
        kw = dict(num_envs=B, obs_mode="state_dict", control_mode="pd_joint_pos")
        je, te = jmake(uid, **kw), tmake(uid, device="cpu", **kw)
    te.reset(seed=0, options=dict(reset_to_env_states=_state(je.unwrapped.get_state_dict())))
    name = {UID: "solve_peg_insertion_side", "PlugCharger-v1": "solve_plug_charger"}[uid]
    poses = first_moves_match(monkeypatch, jps, tps, lambda: getattr(jsol, name)(je), lambda: getattr(tsol, name)(te))
    hover, grasp = poses
    assert (hover[:, 2] > grasp[:, 2] + 0.05).all()


class Stop(Exception):
    pass


def first_moves_match(monkeypatch, jps, tps, jsolve, tsolve, n=2, tol=1e-5):
    """The first ``n`` target poses the two planners' ``move_to_pose`` get
    are within ``tol`` (positions and quaternions); returns them (port)."""
    poses = {}
    for name, ps, solve in (("jax", jps, jsolve), ("torch", tps, tsolve)):
        poses[name] = []

        def recorder(self, pose7, *args, _out=poses[name], **kwargs):
            _out.append(np.array(pose7.tolist(), np.float64))
            if len(_out) == n:
                raise Stop

        monkeypatch.setattr(ps.PandaMotionPlanningSolver, "move_to_pose", recorder)
        monkeypatch.setattr(ps.PandaMotionPlanningSolver, "open_gripper", lambda self, steps=6: None)
        with pytest.raises(Stop):
            solve()
    assert len(poses["jax"]) == len(poses["torch"]) == n
    for jpose, tpose in zip(poses["jax"], poses["torch"]):
        np.testing.assert_allclose(tpose, jpose, rtol=0, atol=tol)
    return poses["torch"]
