"""PickSingleYCB-v1 and PickClutterYCB-v1 in the port against the JAX
package, on the CPU, at 4 envs holding different YCB stand-ins (one JAX env
per task, made once per module or test, its solver's bf16 cast made an
identity).

Parity goes by state: the port starts from the JAX env's state through
``reset_to_env_states``, or takes the JAX env's ``Model`` and ``Data``
bridged across.
- PickSingleYCB: the per-env hull tables, masses and candidate pairs equal.
  After 3 control steps of the same seeded ``pd_joint_pos`` actions:
  obs and the normalized dense reward within 1e-4, ``evaluate``'s flags
  equal, except the object's pose in envs holding a cylinder stand-in,
  held within 5e-3. Those rock on their padded hull proxies: resting flat,
  the deepest-4 manifold picks among vertices whose depths differ only by
  round-off, so a 1e-9 difference after one substep selects other contact
  points (ROADMAP, known reference faults).
- One rgb frame of the base camera: the port's plain path against the JAX
  package's rasterizer: segmentation agrees on >= 0.999 of the pixels and
  rgb is equal where it agrees; the port's render mesh (per-env vertex
  table, faces, colours, ids) equals the JAX package's.
- PickClutterYCB (hull-hull pairs, the ``target_idx`` extra): the obs after
  the reset within 1e-6, and one physics substep from the JAX env's Model
  and Data bridged across, each env's second object set down on its first:
  the same contact rows (live mask equal; depth,
  pos and normal within 1e-5), ``contact.overflow`` equal, qpos within
  1e-5. Objects resting on and against each other meet the same near ties,
  so their poses part by up to ~1e-2 m within one control step and are not
  compared after it.
- ``solve_pick_single_ycb``: the first two target poses (hover, grasp) from
  the same state, positions within 1e-5 m and grasp quaternions within 1e-5.
- One env reconfigures on every full reset (port only): the object drawn is
  the JAX package's draw from the same seed.
"""
import numpy as np
import pytest
import torch

import jax
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu import physics as jphys
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch import physics as tphys

from test_torch_common import f32_reference_solver, jax_cooking, numpy_fields, one_torch_thread, tree  # noqa: F401

# the JAX package's cooking library, loaded once it is whole
pytestmark = pytest.mark.usefixtures("jax_cooking")

B = 4
KW = dict(num_envs=B, obs_mode="state_dict", control_mode="pd_joint_pos")
ROCKING = ("002_master_chef_can", "005_tomato_soup_can")
DEAD = -1e5  # depth below this is a BAD_DEPTH row


def _bridged_substep(jb, qpos=None):
    """One physics substep of the JAX env's current Model and Data (with
    ``qpos`` in place of its own when given) in both packages: the same
    contact rows (live mask equal, depth, pos and normal within 1e-5),
    overflow equal, qpos within 1e-5. Returns the port's (Model, Data)
    after it."""
    jm, jd = jb.scene.model, jb.scene.data
    if qpos is not None:
        jd = jd.replace(qpos=jax.numpy.asarray(qpos))
    tm = tphys.model_from_numpy(numpy_fields(jm), "cpu")
    c = jd.contact
    tcon = tphys.Contact(geom1=np.asarray(c.geom1), geom2=np.asarray(c.geom2), **{
        k: torch.as_tensor(np.array(getattr(c, k)))
        for k in ("pos", "normal", "depth", "friction", "restitution", "impulse", "overflow")})
    jd2 = jax.jit(jphys.step)(jm, jd)
    td2 = tphys.step(tm, tphys.data_from_numpy(numpy_fields(jd), "cpu", contact=tcon))
    jc, tc = jd2.contact, td2.contact
    np.testing.assert_array_equal(tc.geom1, np.asarray(jc.geom1))
    live = np.asarray(jc.depth) > DEAD
    np.testing.assert_array_equal(tc.depth.numpy() > DEAD, live)
    for k in ("depth", "pos", "normal"):
        np.testing.assert_allclose(getattr(tc, k).numpy()[live], np.asarray(getattr(jc, k))[live],
                                   rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tc.overflow.numpy(), np.asarray(jc.overflow))
    np.testing.assert_allclose(td2.qpos.numpy(), np.asarray(jd2.qpos), rtol=0, atol=1e-5)
    return tm, td2


@pytest.fixture(scope="module")
def ycb_envs(f32_reference_solver):
    """(JAX env, port env) of PickSingleYCB-v1, the port set to the JAX
    env's state after its reset."""
    je = jmake("PickSingleYCB-v1", **KW)
    te = tmake("PickSingleYCB-v1", device="cpu", **KW)
    # the JAX env's state after the reset inside make (a second reset with
    # the post-reset data would compile the reset again)
    te.reset(seed=3, options=dict(reset_to_env_states=_state_of(je)))
    return je, te


def _state_of(je):
    return tree(je.unwrapped.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))


def _assert_obs_close(tobs, jobs, what):
    for path, jv in jax.tree_util.tree_leaves_with_path(jobs):
        tv = tobs
        for p in path:
            tv = tv[p.key]
        tv = tv.numpy() if isinstance(tv, torch.Tensor) else tv
        np.testing.assert_allclose(tv.astype(np.float32), np.asarray(jv, np.float32),
                                   rtol=0, atol=1e-4, err_msg=f"{what} obs{path}")


def test_pick_single_ycb_matches_reference(ycb_envs):
    je, te = ycb_envs
    jb, tb = je.unwrapped, te.unwrapped
    assert list(tb.model_ids) == list(jb.model_ids) and len(set(tb.model_ids)) >= 3
    jm, tm = jb.scene.model, tb.scene.model
    for f in ("hull_verts", "hull_dirs", "body_mass", "geom_hull", "pair_geom1", "pair_geom2", "geom_type"):
        jv, tv = np.asarray(getattr(jm, f)), getattr(tm, f)
        np.testing.assert_array_equal(tv.numpy() if isinstance(tv, torch.Tensor) else tv, jv, err_msg=f)
    assert tm.hull_verts.shape[0] == B and tm.max_active_contacts == jm.max_active_contacts
    np.testing.assert_array_equal(tb.object_zs.numpy(), np.asarray(jb.object_zs))

    je.reset(seed=4)
    te.reset(seed=4, options=dict(reset_to_env_states=_state_of(je)))
    rng = np.random.default_rng(11)
    q0 = np.asarray(jb.agent.robot.qpos)[:, :7]
    for _ in range(3):
        action = np.concatenate([q0 + rng.uniform(-0.2, 0.2, (B, 7)), rng.uniform(-1, 1, (B, 1))], 1)
        action = action.astype(np.float32)
        jobs, jrew, jterm, _, jinfo = je.step(action)
        tobs, trew, tterm, _, tinfo = te.step(torch.as_tensor(action))
    rocking = np.isin(tb.model_ids, ROCKING)
    assert rocking.any() and not rocking.all()
    for k in ("obj_pose", "tcp_to_obj_pos", "obj_to_goal_pos"):
        jv, tv = np.asarray(jobs["extra"][k]), tobs["extra"][k].numpy()
        np.testing.assert_allclose(tv[rocking], jv[rocking], rtol=0, atol=5e-3, err_msg=k)
        jobs["extra"][k], tobs["extra"][k] = jv[~rocking], tv[~rocking]
    _assert_obs_close(tobs, jobs, "PickSingleYCB")
    np.testing.assert_allclose(trew.numpy()[~rocking], np.asarray(jrew)[~rocking], rtol=0, atol=1e-4)
    np.testing.assert_allclose(trew.numpy()[rocking], np.asarray(jrew)[rocking], rtol=0, atol=5e-3)
    for k in ("success", "is_obj_placed", "is_robot_static", "is_grasped"):
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]), err_msg=k)
    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
    assert tb.scene.data.contact.overflow.tolist() == np.asarray(jb.scene.data.contact.overflow).tolist()


def test_pick_single_ycb_rgb_matches_reference(ycb_envs):
    from maniskill_tpu_torch.physics.kinematics import geom_poses
    from maniskill_tpu_torch.render.rasterizer import rasterize

    je, _ = ycb_envs
    jb = je.unwrapped
    te = tmake("PickSingleYCB-v1", device="cpu", **dict(KW, obs_mode="rgb"))
    te.reset(seed=0, options=dict(reset_to_env_states=_state_of(je)))
    tb = te.unwrapped
    jcam, tcam = jb._sensors["base_camera"], tb._sensors["base_camera"]
    jmesh = jcam._get_mesh(tuple(jb._hidden_objects))
    tmesh = tcam._get_mesh(tuple(tb._hidden_objects))
    assert tmesh.verts.shape == (B,) + np.asarray(jmesh.verts).shape
    np.testing.assert_array_equal(tmesh.verts.numpy(), np.asarray(jmesh.verts_b))
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
    trgb = te.unwrapped.get_obs()["sensor_data"]["base_camera"]["rgb"].numpy()
    same = tseg == jobs["segmentation"][..., 0]
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_array_equal(trgb[same], jobs["rgb"][same])
    obj = tb.obj.per_scene_id
    assert ((tseg == obj).sum((1, 2)) > 20).all()  # every env's object is in view


def test_pick_clutter_ycb_matches_reference(f32_reference_solver):
    je = jmake("PickClutterYCB-v1", **KW)
    te = tmake("PickClutterYCB-v1", device="cpu", **KW)
    jobs = je.unwrapped._init_raw_obs  # of the reset inside make; its state is the current one
    state = _state_of(je)
    state["extras"] = {"target_idx": torch.as_tensor(np.array(je.unwrapped.scene.data.extras["target_idx"]))}
    tobs, _ = te.reset(seed=5, options=dict(reset_to_env_states=state))
    jb, tb = je.unwrapped, te.unwrapped
    for path, jv in jax.tree_util.tree_leaves_with_path(jobs):
        tv = tobs
        for p in path:
            tv = tv[p.key]
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6, err_msg=f"obs{path}")
    np.testing.assert_array_equal(tb.scene.model.hull_verts.numpy(), np.asarray(jb.scene.model.hull_verts))
    assert tb.scene.get_sim_state()["extras"]["target_idx"].tolist() == np.asarray(
        jb.scene.data.extras["target_idx"]).tolist()
    # each env's second object set down on its first, so hull-hull pairs touch
    qpos = np.array(jb.scene.data.qpos)
    a0, a1 = (int(jb.scene.model.body_q_adr[o.body_id]) for o in jb.objs[:2])
    qpos[:, a1:a1 + 3] = qpos[:, a0:a0 + 3] + [0.02, 0.01, 0.06]
    tm, td = _bridged_substep(jb, qpos)
    gtype = np.asarray(tm.geom_type)
    hull_hull = (gtype[td.contact.geom1] == 6) & (gtype[td.contact.geom2] == 6)
    assert (td.contact.depth.numpy()[:, hull_hull] > -0.01).any()  # hull-hull pairs in touch


def test_pick_single_ycb_grasp_matches_reference(ycb_envs, monkeypatch):
    from maniskill_tpu.examples.motionplanning import panda_solver as jps
    from maniskill_tpu.examples.motionplanning import solutions as jsol

    from maniskill_tpu_torch.examples.motionplanning import panda_solver as tps
    from maniskill_tpu_torch.examples.motionplanning import solutions as tsol

    class Stop(Exception):
        pass

    def recorder(calls):
        def move_to_pose(self, pose7, *args, **kwargs):
            calls.append(np.array(pose7))
            if len(calls) == 2:
                raise Stop
        return move_to_pose

    je, te = ycb_envs
    je.reset(seed=6)
    te.reset(seed=6, options=dict(reset_to_env_states=_state_of(je)))
    poses = {}
    for name, ps, sol, env in (("jax", jps, jsol, je), ("torch", tps, tsol, te)):
        poses[name] = []
        monkeypatch.setattr(ps.PandaMotionPlanningSolver, "move_to_pose", recorder(poses[name]))
        monkeypatch.setattr(ps.PandaMotionPlanningSolver, "open_gripper", lambda self, steps=6: None)
        with pytest.raises(Stop):
            sol.solve_pick_single_ycb(env)
    for (jpose, tpose) in zip(poses["jax"], poses["torch"]):
        np.testing.assert_allclose(tpose[:, :3], jpose[:, :3], rtol=0, atol=1e-5)
        np.testing.assert_allclose(tpose[:, 3:], jpose[:, 3:], rtol=0, atol=1e-5)
    hover, grasp = poses["torch"]
    assert (hover[:, 2] > grasp[:, 2] + 0.05).all() and len({tuple(q.round(3)) for q in grasp[:, 3:]}) > 1


def test_single_env_draws_a_new_object_each_reset():
    """With one env PickSingleYCB reconfigures on every full reset, as the
    JAX package: the object is drawn from the main RNG just seeded (the JAX
    package's ``np.random.RandomState(seed).choice`` over the model ids); a
    partial reset keeps it, and ``reconfiguration_freq=0`` never redraws."""
    ids = tmake("PickSingleYCB-v1", num_envs=1, device="cpu").unwrapped.all_model_ids

    def drawn(seed):
        return list(np.random.RandomState(seed).choice(ids, size=1, replace=True))

    env = tmake("PickSingleYCB-v1", num_envs=1, obs_mode="state", device="cpu")
    base = env.unwrapped
    for seed in (5, 11):
        obs, _ = env.reset(seed=seed)
        assert list(base.model_ids) == drawn(seed) and torch.isfinite(obs).all()
        hulls = base.scene.model.hull_verts[0]
        env.reset(seed=seed + 1, options=dict(env_idx=[0]))
        assert list(base.model_ids) == drawn(seed) and torch.equal(base.scene.model.hull_verts[0], hulls)
    assert drawn(5) != drawn(11)
    fixed = tmake("PickSingleYCB-v1", num_envs=1, reconfiguration_freq=0, device="cpu").unwrapped
    first = list(fixed.model_ids)
    fixed.reset(seed=5)
    assert list(fixed.model_ids) == first == drawn(2022)
