"""Parity of the port's primitive narrowphase (maniskill_tpu_torch.physics.
collision) and top-K contact compaction with the JAX package's, on the CPU.

Every pair function of ``_DISPATCH`` gets the same poses and sizes, made with
numpy from a seed, at B=64: random rows plus rows built to hit the branches
that decide on exact comparisons (face-aligned resting boxes whose corner
depths and SAT overlaps tie exactly, edge-on incident faces of ``box_box``,
separated pairs that give ``BAD_DEPTH`` rows, a capsule lying parallel to a
box face). Tolerance: atol 1e-5, scaled by the field's magnitude where that
exceeds 1, on pos, normal and depth of live rows; the dead-row masks are
equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from maniskill_tpu import physics as jphys
from maniskill_tpu.envs.scene import ManiSkillScene as JScene
from maniskill_tpu.envs.tasks.control.cartpole import CartPoleRobot as JCartPole
from maniskill_tpu.physics import collision as jcol
from maniskill_tpu.physics import dynamics as jdyn
from maniskill_tpu.physics import kinematics as jkin
from maniskill_tpu.physics import solver as jsolver
from maniskill_tpu.physics.types import Contact as JContact
from maniskill_tpu.physics.types import HArray

from maniskill_tpu_torch import physics as tphys
from maniskill_tpu_torch.physics import collision as tcol
from maniskill_tpu_torch.physics import dynamics as tdyn
from maniskill_tpu_torch.physics import kinematics as tkin
from maniskill_tpu_torch.physics import solver as tsolver
from maniskill_tpu_torch.physics.plan import model_plan
from maniskill_tpu_torch.physics.types import BOX, CAPSULE, CYLINDER, PLANE, SPHERE
from maniskill_tpu_torch.utils.common import top_k_stable

from test_torch_common import f32_solver  # noqa: F401

ATOL = 1e-5
B = 64
DEAD = -1e5  # depth below this is a BAD_DEPTH row


def _close(a, b, atol=ATOL, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(1.0, float(np.abs(a).max())) if a.size else 1.0
    np.testing.assert_allclose(b, a, rtol=0, atol=atol * scale, err_msg=what)


def _quat(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _zrot(angle):
    return np.array([np.cos(angle / 2), 0.0, 0.0, np.sin(angle / 2)])


def _size(rng, t, n):
    if t == PLANE:
        return np.zeros((n, 3))
    if t in (SPHERE,):
        return np.stack([rng.uniform(0.02, 0.2, n), np.zeros(n), np.zeros(n)], -1)
    if t in (CAPSULE, CYLINDER):
        return np.stack([rng.uniform(0.02, 0.1, n), rng.uniform(0.02, 0.2, n), np.zeros(n)], -1)
    return rng.uniform(0.01, 0.3, (n, 3))


def _inputs(t1, t2, seed=0):
    """(p1, q1, s1, p2, q2, s2) as float32 numpy, B rows."""
    rng = np.random.default_rng(seed + 10 * t1 + t2)
    p1 = rng.uniform(-0.2, 0.2, (B, 3))
    p2 = p1 + rng.uniform(-0.25, 0.25, (B, 3))
    q1, q2 = _quat(rng, B), _quat(rng, B)
    s1, s2 = _size(rng, t1, B), _size(rng, t2, B)
    ident = np.array([1.0, 0, 0, 0])
    # separated pairs: far apart (dead rows where the function has them)
    p2[:4] = p1[:4] + np.array([3.0, 2.0, 1.0])
    if (t1, t2) == (BOX, BOX):
        # rows 4-11: a 2 cm cube resting face-down on a table top (exact
        # corner-depth and SAT ties), axis-aligned and yawed
        for r, yaw in zip(range(4, 12), [0.0, 0.0, 0.3, 1.1, np.pi / 2, np.pi, 0.0, 0.7]):
            p1[r], q1[r], s1[r] = [-0.12, 0, -0.025], ident, [0.7, 0.8, 0.025]
            p2[r] = [0.05 * (r - 8), 0.02 * (r - 6), 0.02 - 1e-3 * (1 + r % 3)]
            q2[r], s2[r] = _zrot(yaw), [0.02, 0.02, 0.02]
        # rows 12-15: edge-on incident face (a 1e-5 box, |det| < 1e-9)
        for r in range(12, 16):
            p1[r], q1[r], s1[r] = [0, 0, 0], ident, [0.1, 0.1, 0.05]
            p2[r], s2[r] = [0.01 * r - 0.13, 0.0, 0.05], [1e-5, 1e-5, 1e-5]
        # rows 16-19: finger pads pinching a cube
        for r in range(16, 20):
            p1[r], q1[r], s1[r] = [0.0, 0.0, 0.02], _zrot(0.2 * r), [0.02, 0.02, 0.02]
            p2[r] = [0.0, 0.0, 0.02] + np.array([0, 0.02 + 0.0075 - 2e-3, 0.002 * (r - 17)])
            q2[r], s2[r] = _zrot(0.2 * r), [0.011, 0.0075, 0.028]
    if (t1, t2) == (BOX, CAPSULE):
        # rows 4-9: a capsule lying parallel to a box's top face
        lie = np.array([np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0])  # z axis -> x
        for r in range(4, 10):
            p1[r], q1[r], s1[r] = [0, 0, -0.025], ident, [0.3, 0.3, 0.025]
            p2[r], q2[r], s2[r] = [0.02 * r - 0.1, 0.01, 0.05 - 1e-3 * (r - 4)], lie, [0.05, 0.1, 0]
    if t1 == PLANE:
        # rows 4-9: an upright ground plane with the body resting on it
        bottom = {SPHERE: s2[:, 0], BOX: s2[:, 2], CAPSULE: s2[:, 0] + s2[:, 1], CYLINDER: s2[:, 1]}[t2]
        for r in range(4, 10):
            p1[r], q1[r] = [0, 0, -0.3], ident
            p2[r, 2] = -0.3 + bottom[r] - 1e-3
            q2[r] = ident if r < 7 else _zrot(0.4 * r)
    return [x.astype(np.float32) for x in (p1, q1, s1, p2, q2, s2)]


@pytest.mark.parametrize(
    "pair", sorted(tcol._DISPATCH), ids=lambda p: f"{tcol._TYPE_NAMES[p[0]]}-{tcol._TYPE_NAMES[p[1]]}"
)
def test_narrowphase_matches_reference(pair):
    args = _inputs(*pair)
    jout = jax.jit(jcol._DISPATCH[pair])(*[jnp.asarray(a) for a in args])
    tout = tcol._DISPATCH[pair](*[torch.as_tensor(a) for a in args])
    assert len(jout) == len(tout) == tcol.contacts_per_pair(*pair)
    n_live = 0
    for i, ((jp, jn, jd), (tp, tn, td)) in enumerate(zip(jout, tout)):
        jd, td = np.asarray(jd), td.numpy()
        live = jd > DEAD
        np.testing.assert_array_equal(td > DEAD, live, err_msg=f"dead rows of point {i}")
        n_live += int(live.sum())
        _close(jd[live], td[live], what=f"depth {i}")
        _close(np.asarray(jp)[live], tp.numpy()[live], what=f"pos {i}")
        _close(np.broadcast_to(np.asarray(jn), np.asarray(jp).shape)[live],
               tn.expand(tp.shape).numpy()[live], what=f"normal {i}")
    assert n_live > 0
    if pair in ((BOX, BOX), (PLANE, BOX)):
        # the structured rows touch, and the far rows are dead
        assert (np.asarray(jout[0][2])[4:8] > 0).all()
        assert (np.asarray(jout[0][2])[:4] <= DEAD).all() or pair == (PLANE, BOX)


def test_plane_box_ties_keep_reference_order():
    """A box resting face-down has four corners at exactly the same depth;
    the four kept candidates come in the reference's order (lower corner
    index first)."""
    args = _inputs(PLANE, BOX)
    jout = jax.jit(jcol.plane_box)(*[jnp.asarray(a) for a in args])
    tout = tcol.plane_box(*[torch.as_tensor(a) for a in args])
    depths = np.stack([np.asarray(d) for _, _, d in jout], -1)[4:7]
    assert (depths == depths[:, :1]).all(), "the resting rows do not tie"
    for (jp, _, _), (tp, _, _) in zip(jout, tout):
        np.testing.assert_array_equal(tp.numpy()[4:7], np.asarray(jp)[4:7])


def test_top_k_stable_matches_xla_top_k():
    x = np.array([[1, 3, 3, 2, 3, 3, 0, 3], [0, 0, 0, 0, 1, 1, 1, 1]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    tv, ti = top_k_stable(torch.as_tensor(x), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti[0].tolist() == [1, 2, 4, 5]


# ---------------------------------------------------------------------------
# top-K compaction inside the solver with tied depths
# ---------------------------------------------------------------------------
@pytest.fixture
def f32_reference_solver():
    """The reference solver's bf16 cast made an identity (see
    tests/test_torch_common.py), so both sides run the same f32 algorithm."""
    with f32_solver():
        yield


def _numpy_fields(obj):
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


def test_solver_compaction_ties_match_reference(f32_reference_solver):
    """Eight contacts between the cartpole's static wall and its cart/pole,
    seven of them live and five of those tied at the greatest depth, K = 4:
    both solvers keep the same four candidate rows (lower id first on ties),
    give the same impulses in the same full candidate slots, and report
    overflow 3. ``torch.topk`` keeps other rows here."""
    scene = JScene(num_envs=4, sim_timestep=1.0 / 120, solver_iterations=8)
    agent = JCartPole(scene, control_mode="pd_joint_delta_pos")
    wall = scene.create_actor_builder()
    wall.add_box_visual(half_size=(1e-3, 20, 10))
    wall.build_static(name="wall")
    scene.model = scene.finalize()
    agent._setup_controllers()
    jm = scene.model.replace(max_active_contacts=4)
    tm = tphys.model_from_numpy(_numpy_fields(jm), "cpu")
    nb = 4
    rng = np.random.default_rng(7)
    C = 8
    n = rng.normal(size=(nb, C, 3))
    c = dict(
        pos=rng.uniform([-0.3, -0.2, 0.8], [0.3, 0.2, 1.8], (nb, C, 3)),
        normal=n / np.linalg.norm(n, axis=-1, keepdims=True),
        depth=np.tile(np.array([0.01, 0.03, 0.03, 0.02, 0.03, 0.03, -0.05, 0.03]), (nb, 1)),
        friction=rng.uniform(0.2, 1.0, (nb, C)),
        restitution=np.zeros((nb, C)),
        impulse=np.zeros((nb, C, 3)),
        overflow=np.zeros(nb, np.int32),
    )
    c = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in c.items()}
    g1, g2 = np.full(C, 2, np.int32), np.array([0, 1] * 4, np.int32)
    qpos = np.stack([rng.uniform(-1, 1, nb), rng.uniform(-1, 1, nb)], -1).astype(np.float32)
    qvel = rng.normal(0, 1, (nb, 2)).astype(np.float32)

    jd = jkin.forward_kinematics(jm, jphys.make_data(jm, nb).replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel)))
    td = tkin.forward_kinematics(tm, tphys.make_data(tm, nb).replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel)))
    jcon = JContact(HArray(g1), HArray(g2), **{k: jnp.asarray(v) for k, v in c.items()})
    tcon = tphys.Contact(g1, g2, **{k: torch.as_tensor(v) for k, v in c.items()})

    def jsolve(m, d, con):
        Minv, qvel_pred, _ = jdyn.smooth_dynamics(m, d)
        return jsolver.solve(m, d, Minv, qvel_pred, con)

    jq, jc = jax.jit(jsolve)(jm, jd, jcon)
    Minv, qvel_pred, _ = tdyn.smooth_dynamics(tm, td)
    tq, tc = tsolver.solve(tm, td, Minv, qvel_pred, tcon)
    kept_j = np.abs(np.asarray(jc.impulse)).sum(-1) > 0
    kept_t = np.abs(tc.impulse.numpy()).sum(-1) > 0
    np.testing.assert_array_equal(kept_t, kept_j)
    assert kept_j[:, [1, 2, 4, 5]].any() and not kept_j[:, [0, 3, 6, 7]].any()
    _close(jc.impulse, tc.impulse, what="impulse")
    _close(jq, tq, what="qvel")
    np.testing.assert_array_equal(tc.overflow.numpy(), np.asarray(jc.overflow))
    assert tc.overflow.tolist() == [3] * nb


def test_collide_plan_is_built_once():
    """The pair groups and their index tensors are built once per model, in
    its device plan; a copy of the model that changes no topology keeps the
    plan, and one that changes the geom types gets a new one."""
    mb = tphys.ModelBuilder()
    mb.add_geom(0, PLANE, [0, 0, 0])
    a = mb.add_body("a")
    mb.add_geom(a, BOX, [0.1, 0.1, 0.1])
    b = mb.add_body("b")
    mb.add_geom(b, CAPSULE, [0.05, 0.1, 0])
    m = mb.finalize("cpu")
    plan = model_plan(m)
    assert model_plan(m) is plan
    assert [(t1, t2) for t1, t2, _, _ in plan.pair_groups] == [(PLANE, BOX), (PLANE, CAPSULE), (BOX, CAPSULE)]
    d = tkin.forward_kinematics(m, tphys.make_data(m, 2))
    con = tcol.collide(m, d)
    assert con.depth.shape == (2, 4 + 2 + 3)
    assert con.geom1 is plan.contact_geom1 and plan.owns(con)
    assert plan.weights_for(con) is plan.contact_weights
    assert model_plan(m.replace(contact_slop=0.003, drive_kp=m.drive_kp * 2)) is plan
    m2 = m.replace(geom_type=m.geom_type.copy())
    assert model_plan(m2) is not plan
