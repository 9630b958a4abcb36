"""Parity of the PyTorch port's physics (maniskill_tpu_torch.physics) with the
JAX package's, on the CPU.

Both packages get the same state, made with numpy ("parity by state, not by
seed"): the JAX Model is read out as numpy and bridged into the port with
``model_from_numpy``. Two scenes: the cartpole of CartpoleBalanceBenchmark-v1
(slide + hinge, one joint limit, no collision pairs) and a small scene with a
free ball, a hinge-slide chain with springs and limits, a kinematic free body
and a ground plane (plane-sphere contacts).

Tolerance: atol 1e-5, scaled by the compared field's largest magnitude where
that exceeds 1 (``_close``): a few dozen f32 ulps of accumulated rounding, as
the two packages contract sums and fuse multiply-adds differently.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from maniskill_tpu import physics as jphys
from maniskill_tpu.envs.scene import ManiSkillScene as JScene
from maniskill_tpu.envs.tasks.control.cartpole import CartPoleRobot as JCartPole
from maniskill_tpu.physics import dynamics as jdyn
from maniskill_tpu.physics import kinematics as jkin
from maniskill_tpu.physics import solver as jsolver
from maniskill_tpu.physics.collision import collide as jcollide
from maniskill_tpu.physics.types import Contact as JContact
from maniskill_tpu.physics.types import HArray

from maniskill_tpu_torch import physics as tphys
from maniskill_tpu_torch.envs.scene import ManiSkillScene as TScene
from maniskill_tpu_torch.envs.tasks.control.cartpole import CartPoleRobot as TCartPole
from maniskill_tpu_torch.physics import dynamics as tdyn
from maniskill_tpu_torch.physics import kinematics as tkin
from maniskill_tpu_torch.physics import solver as tsolver
from maniskill_tpu_torch.physics.collision import collide as tcollide
from maniskill_tpu_torch.physics.types import BOX, CYLINDER, FREE, HINGE, KINEMATIC, PLANE, SLIDE, SPHERE

from test_torch_common import f32_reference_solver, one_torch_thread  # noqa: F401

jstep = importlib.import_module("maniskill_tpu.physics.step")
tstep = importlib.import_module("maniskill_tpu_torch.physics.step")

ATOL = 1e-5
B = 8


# ---------------------------------------------------------------------------
# scenes, built the same way through each package's builders
# ---------------------------------------------------------------------------
def _cartpole(scene_cls, robot_cls, **kw):
    scene = scene_cls(num_envs=B, sim_timestep=1.0 / 120, solver_iterations=4, **kw)
    agent = robot_cls(scene, control_mode="pd_joint_delta_pos")
    wall = scene.create_actor_builder()
    wall.add_box_visual(half_size=(1e-3, 20, 10), color=(0.3, 0.3, 0.3, 1))
    wall.set_initial_pose(np.array([1, 0, 1, 0.7071068, 0, 0, 0.7071068]))
    wall.build_static(name="wall")
    scene.model = scene.finalize()
    agent._setup_controllers()
    return scene.model


def _free_scene(mb):
    # contype/conaffinity keep the sphere-sphere pair out
    mb.add_geom(0, PLANE, [0, 0, 0], friction=0.8, contype=3, conaffinity=3)
    ball = mb.add_body("ball", jnt_type=FREE, mass=0.5, inertia=[2e-3, 2.5e-3, 3e-3],
                       ipos=[0.01, 0, 0], iquat=[0.9238795, 0, 0, 0.3826834])
    mb.add_geom(ball, SPHERE, [0.1], friction=0.6, restitution=0.5, contype=1, conaffinity=1)
    arm = mb.add_body("arm", parent=0, jnt_type=HINGE, pos=[0.5, 0, 1.0], jnt_axis=[0, 1, 0],
                      mass=1.0, ipos=[0, 0, -0.25], limit=(-1.0, 1.0), damping=0.1,
                      armature=0.01, stiffness=2.0, springref=0.1)
    slider = mb.add_body("slider", parent=arm, jnt_type=SLIDE, pos=[0, 0, -0.5],
                         quat=[0.9238795, 0, 0.3826834, 0], jnt_axis=[0, 0, 1], mass=0.3,
                         limit=(-0.2, 0.2))
    mb.add_geom(slider, SPHERE, [0.05], friction=0.4, contype=2, conaffinity=2)
    kin = mb.add_body("pusher", jnt_type=FREE, body_type=KINEMATIC, mass=1.0)
    mb.add_geom(kin, BOX, [0.1, 0.1, 0.1], collision=False, contype=0, conaffinity=0)
    return mb


def _numpy_fields(obj):
    """A JAX Model/Data read out as host values, keyed by field name."""
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


def _to_numpy(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.fixture(scope="module", params=["cartpole", "free"])
def scene(request):
    """(name, JAX model, port model bridged from it, port model from the
    port's own builder)."""
    if request.param == "cartpole":
        jm = _cartpole(JScene, JCartPole)
        tm_built = _cartpole(TScene, TCartPole, device="cpu")
    else:
        jm = _free_scene(jphys.ModelBuilder(timestep=0.01, solver_iterations=8)).finalize()
        tm_built = _free_scene(tphys.ModelBuilder(timestep=0.01, solver_iterations=8)).finalize("cpu")
    tm = tphys.model_from_numpy(_numpy_fields(jm), "cpu")
    return request.param, jm, tm, tm_built


def _state(name, seed=0):
    """Random per-env state for the scene, as numpy."""
    rng = np.random.default_rng(seed)
    if name == "cartpole":
        qpos = np.stack([rng.uniform(-1.85, 1.85, B), rng.uniform(-3, 3, B)], -1)
        qvel = rng.normal(0, 2, (B, 2))
        # at / past the slider limits, moving into them
        qpos[:4, 0] = [1.795, -1.799, 1.81, -1.805]
        qvel[:4, 0] = [3.0, -3.0, 0.5, -0.5]
        nbody = 4
    else:
        quat = rng.normal(size=(B, 2, 4))
        quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
        ball = np.concatenate([rng.uniform(-0.3, 0.3, (B, 2)), rng.uniform(0.06, 0.12, (B, 1)), quat[:, 0]], -1)
        pusher = np.concatenate([rng.uniform(-1, 1, (B, 3)), quat[:, 1]], -1)
        joints = np.stack([rng.uniform(-1.1, 1.1, B), rng.uniform(-0.25, 0.25, B)], -1)
        qpos = np.concatenate([ball, joints, pusher], -1)
        qvel = rng.normal(0, 1, (B, 14))
        nbody = 5
    nv = qvel.shape[1]
    # PD targets near the current positions (the cartpole slider's kp=2000
    # would otherwise swamp the limit rows)
    target = qpos[:, :nv] + rng.uniform(-0.1, 0.1, (B, nv))
    return dict(
        qpos=qpos.astype(np.float32),
        qvel=qvel.astype(np.float32),
        drive_target=target.astype(np.float32),
        qf_applied=rng.normal(0, 0.5, (B, nv)).astype(np.float32),
        xfrc_applied=rng.normal(0, 0.5, (B, nbody, 6)).astype(np.float32),
    )


def _datas(jm, tm, st):
    jd = jphys.make_data(jm, B).replace(**{k: jnp.asarray(v) for k, v in st.items()})
    td = tphys.make_data(tm, B).replace(**{k: torch.as_tensor(v) for k, v in st.items()})
    return jax.jit(jkin.forward_kinematics)(jm, jd), tkin.forward_kinematics(tm, td)


def _close(a, b, atol=ATOL, what=""):
    """|b - a| <= atol * max(1, max|a|): atol absolute for fields of order
    one, relative to the field's largest entry above that (PD torques reach
    ~1e3, inverse mass matrices ~1e2, where 1e-5 absolute is below f32
    resolution)."""
    a, b = _to_numpy(a), _to_numpy(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(1.0, float(np.abs(a).max())) if a.size else 1.0
    np.testing.assert_allclose(b, a, rtol=0, atol=atol * scale, err_msg=what)


# ---------------------------------------------------------------------------
# (a) builder tables
# ---------------------------------------------------------------------------
def test_builder_tables_match_reference(scene):
    """The port's ModelBuilder gives the JAX builder's Model, field by field:
    integer/bool tables exactly, floats within 1e-7."""
    _, jm, _, tm = scene
    for f in dataclasses.fields(jm):
        jv, tv = getattr(jm, f.name), getattr(tm, f.name)
        if jv is None or tv is None:
            assert jv is None and tv is None, f.name
            continue
        if isinstance(jv, (tuple, str, int, float)):
            assert jv == tv, (f.name, jv, tv)
            continue
        jv, tv = np.asarray(jv), _to_numpy(tv)
        assert jv.shape == tv.shape, (f.name, jv.shape, tv.shape)
        if jv.dtype.kind in "biu":
            np.testing.assert_array_equal(tv, jv, err_msg=f.name)
        else:
            np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-7, err_msg=f.name)


# ---------------------------------------------------------------------------
# (b) kinematics, dynamics, limits, collision, solve, step on the bridged model
# ---------------------------------------------------------------------------
JAX_FNS = (jkin, jdyn, jsolver, jcollide, jstep)
PORT_FNS = (tkin, tdyn, tsolver, tcollide, tstep)


def _pipeline(fns, m, d):
    """Every ported physics function, applied in order by one package."""
    kin, dyn, sol, collide, stp = fns
    d = kin.forward_kinematics(m, d)
    ax, an = kin.dof_frames(m, d)
    jl, jr = kin.body_jacobians(m, d, ax, an)
    gp, gq = kin.geom_poses(m, d)
    M, bias = dyn.mass_matrix_and_bias(m, d)
    Minv, qvel_pred, qacc = dyn.smooth_dynamics(m, d)
    sign, depth, _ = sol.limit_rows(m, d)
    contact = collide(m, d)
    contact_jac = sol.contact_jacobians(m, d, contact)
    qvel, solved = sol.solve(m, d, Minv, qvel_pred, contact)
    out = dict(
        xpos=d.xpos, xquat=d.xquat, cvel=d.cvel, dof_axis=ax, dof_anchor=an,
        jac_lin=jl, jac_rot=jr, geom_pos=gp, geom_quat=gq, M=M, bias=bias,
        actuation=dyn.actuation(m, d), joint_positions=dyn.joint_positions(m, d),
        Minv=Minv, qvel_pred=qvel_pred, smooth_qacc=qacc, limit_sign=sign, limit_depth=depth,
        contact=contact, contact_jac=contact_jac, solve_qvel=qvel, solved=solved,
    )
    for _ in range(3):
        d = stp.step(m, d)
    out.update(step_qpos=d.qpos, step_qvel=d.qvel, step_qacc=d.qacc,
               forward_xpos=stp.forward(m, d).xpos)
    return out


@pytest.fixture(scope="module")
def results(scene, f32_reference_solver):
    """(scene name, JAX pipeline outputs, port pipeline outputs), once per scene."""
    name, jm, tm, _ = scene
    st = _state(name)
    jd = jphys.make_data(jm, B).replace(**{k: jnp.asarray(v) for k, v in st.items()})
    td = tphys.data_from_numpy(_numpy_fields(jd), "cpu")  # the Data bridge
    jout = jax.jit(lambda m, d: _pipeline(JAX_FNS, m, d))(jm, jd)
    return name, jout, _pipeline(PORT_FNS, tm, td)


def _compare(results, keys, atol=ATOL):
    _, jout, tout = results
    for k in keys:
        _close(jout[k], tout[k], atol=atol, what=k)


def test_forward_kinematics(results):
    _compare(results, ["xpos", "xquat", "cvel", "dof_axis", "dof_anchor",
                       "jac_lin", "jac_rot", "geom_pos", "geom_quat"])


def test_mass_matrix_and_bias(results):
    _compare(results, ["M", "bias", "actuation", "joint_positions", "Minv", "qvel_pred",
                       "smooth_qacc"])


@pytest.mark.parametrize("mixed_scales", [False, True])
def test_spd_inverse(mixed_scales):
    """Well-conditioned SPD matrices: atol 1e-5. Mixed diagonal scales (arm
    links vs fingers, the reason for the Jacobi equilibration): the inverse
    spans 1e-1..1e5, so compare relative to each entry's row/column scale."""
    rng = np.random.default_rng(1)
    n = 7
    q, _ = np.linalg.qr(rng.normal(size=(16, n, n)))
    A = q @ (rng.uniform(0.5, 3.0, (16, n))[..., None] * np.swapaxes(q, 1, 2))
    if mixed_scales:
        d = 10.0 ** rng.uniform(-2.5, 1, (16, n))
        A = A * np.sqrt(d)[:, :, None] * np.sqrt(d)[:, None, :]
    A = A.astype(np.float32)
    ji = np.asarray(jax.jit(jdyn.spd_inverse)(jnp.asarray(A)))
    ti = tdyn.spd_inverse(torch.as_tensor(A)).numpy()
    if not mixed_scales:
        _close(ji, ti)
    else:
        scale = np.sqrt(np.abs(np.diagonal(ji, axis1=1, axis2=2)))
        norm = scale[:, :, None] * scale[:, None, :]
        np.testing.assert_allclose(ti / norm, ji / norm, rtol=0, atol=1e-4)


def test_limit_rows(results):
    _compare(results, ["limit_sign", "limit_depth"])
    assert (np.asarray(results[1]["limit_depth"]) > -0.01).any(), "no limit row is active"


def test_collide(results):
    name, jout, tout = results
    jc, tc = jout["contact"], tout["contact"]
    np.testing.assert_array_equal(tc.geom1, np.asarray(jc.geom1))
    np.testing.assert_array_equal(tc.geom2, np.asarray(jc.geom2))
    for field in ("pos", "normal", "depth", "friction", "restitution", "impulse", "overflow"):
        _close(getattr(jc, field), getattr(tc, field), what=field)
    _close(jout["contact_jac"], tout["contact_jac"], what="contact jacobians")
    if name == "free":
        assert (np.asarray(jc.depth) > 0).any(), "no contact is touching in the test state"


def test_solve(results):
    """Joint-limit rows (both scenes) and plane-sphere contact rows (free)."""
    _, jout, tout = results
    _compare(results, ["solve_qvel"])
    assert not np.allclose(np.asarray(jout["solve_qvel"]), np.asarray(jout["qvel_pred"])), \
        "the solve changed nothing"
    jc, tc = jout["solved"], tout["solved"]
    _close(jc.impulse, tc.impulse, what="impulse")
    np.testing.assert_array_equal(tc.overflow.numpy(), np.asarray(jc.overflow))


def test_step(results):
    """Three chained substeps, then forward."""
    _compare(results, ["step_qpos", "step_qvel", "step_qacc", "forward_xpos"])


# ---------------------------------------------------------------------------
# (c) contact rows from a hand-made contact set
# ---------------------------------------------------------------------------
def _hand_made_solve(fns, m, d, con):
    _, dyn, sol, _, _ = fns
    Minv, qvel_pred, _ = dyn.smooth_dynamics(m, d)
    return sol.solve(m, d, Minv, qvel_pred, con)


@pytest.mark.parametrize("max_active", [0, 4])
def test_solve_hand_made_contacts(max_active, f32_reference_solver):
    """Six contacts between the static wall (geom 2) and the cart / pole
    (geoms 0, 1) of the cartpole, fed identically to both solvers, with a
    previous step's impulses for the warm start; max_active=4 exercises the
    top-K compaction (distinct depths, so both pick the same 4 of the 5 live
    contacts and report overflow 1)."""
    jm = _cartpole(JScene, JCartPole).replace(max_active_contacts=max_active)
    tm = tphys.model_from_numpy(_numpy_fields(jm), "cpu")
    rng = np.random.default_rng(3)
    C = 6
    n = rng.normal(size=(B, C, 3))
    c = dict(
        pos=rng.uniform([-0.3, -0.2, 0.8], [0.3, 0.2, 1.8], (B, C, 3)),
        normal=n / np.linalg.norm(n, axis=-1, keepdims=True),
        depth=np.stack([rng.permutation([0.04, 0.02, 0.01, 0.005, 0.001, -0.005]) for _ in range(B)]),
        friction=rng.uniform(0.2, 1.0, (B, C)),
        restitution=rng.uniform(0.0, 0.6, (B, C)),
        impulse=np.zeros((B, C, 3)),
        overflow=np.zeros(B, np.int32),
    )
    c = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in c.items()}
    prev = rng.normal(0, 0.05, (B, C, 3)).astype(np.float32)
    g1, g2 = np.full(C, 2, np.int32), np.array([0, 1, 0, 1, 0, 1], np.int32)

    def jcon(**kw):
        return JContact(HArray(g1), HArray(g2), **{k: jnp.asarray(v) for k, v in dict(c, **kw).items()})

    def tcon(**kw):
        return tphys.Contact(g1, g2, **{k: torch.as_tensor(v) for k, v in dict(c, **kw).items()})

    st = _state("cartpole", seed=4)
    st["qvel"] = st["qvel"] * 3.0  # fast enough for restitution to bounce
    jd, td = _datas(jm, tm, st)
    jd, td = jd.replace(contact=jcon(impulse=prev)), td.replace(contact=tcon(impulse=prev))
    jq, jc = jax.jit(lambda m, d, con: _hand_made_solve(JAX_FNS, m, d, con))(jm, jd, jcon())
    tq, tc = _hand_made_solve(PORT_FNS, tm, td, tcon())
    _close(jq, tq, what="qvel")
    _close(jc.impulse, tc.impulse, what="impulse")
    np.testing.assert_array_equal(tc.overflow.numpy(), np.asarray(jc.overflow))
    assert np.abs(np.asarray(jc.impulse)).max() > 1e-3, "no contact row carried an impulse"
    np.testing.assert_array_equal(tc.overflow.numpy(), np.full(B, 1 if max_active else 0))


def test_collide_raises_for_unported_pair():
    """A candidate pair whose kind has no narrowphase (here box-cylinder,
    which the builder never emits) raises, naming the pair."""
    mb = tphys.ModelBuilder()
    a = mb.add_body("a", jnt_type=FREE)
    mb.add_geom(a, BOX, [0.1, 0.1, 0.1])
    b = mb.add_body("b", jnt_type=FREE)
    mb.add_geom(b, BOX, [0.1, 0.1, 0.1])
    m = mb.finalize("cpu")
    m = m.replace(geom_type=np.array([BOX, CYLINDER], np.int32))
    d = tkin.forward_kinematics(m, tphys.make_data(m, 2))
    with pytest.raises(NotImplementedError, match="box-cylinder"):
        tcollide(m, d)
