# Frozen copy of maniskill_tpu_torch/physics/collision.py at the benchmark's first version:
# the benchmark's plain reference. It imports nothing of the program and is
# never edited to follow it.
"""Batched analytic narrowphase for primitive geoms and contact-set assembly
(counterpart of maniskill_tpu/physics/collision.py).

Every candidate pair (fixed at model build) expands to a fixed number of
candidate contact points; invalid points carry depth << 0 and are masked in
the solver. Pairs are grouped by (type1, type2) and each group is one batched
call over a gathered (B, P, ...) pair axis. The groups and their index
tensors are part of the model's device plan (``physics/plan.py``), so a
substep copies nothing from the host.

Convex hull proxies (geom type HULL) go through the support-function SAT
(``_support_sat``; a primitive entering a hull pair becomes a vertex cloud
with a margin radius) and ``plane_hull``. Their per-group hull ids and
operand constants are in the device plan; the hull vertex and normal
tables are read from the model at each call, since per-env tables are
written after the plan may have been built. A pair kind with no
narrowphase raises in ``collide`` naming the pair.

Conventions: ``normal`` points from geom1 toward geom2 (the direction to push
geom2 to separate; impulse +λ·n acts on body(geom2)); ``depth`` > 0 means
penetration; pairs are ordered so geom_type[g1] <= geom_type[g2].
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .common import top_k_stable
from . import rotation_conversions as rc
from .kinematics import geom_poses, geom_poses_from
from .plan import model_plan
from .types import BOX, CAPSULE, CYLINDER, HULL, PLANE, SPHERE, Contact, Data, Model

# A contact candidate: (pos (B, P, 3), normal (B, P, 3), depth (B, P))
Cand = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

BAD_DEPTH = -1e6

# speculative-contact margin: candidates within this separation stay live
# (negative depth) so the solver keeps persistent rows and warm starts across
# micro-separations. Must cover Model.contact_margin.
MARGIN = 0.012

_TYPE_NAMES = {
    PLANE: "plane", SPHERE: "sphere", BOX: "box", CAPSULE: "capsule",
    CYLINDER: "cylinder", HULL: "hull",
}

# points each type pair expands to (the reference's contacts_per_pair); the
# model builder reads this to size the candidate set
HULL_CONTACTS = 4
_POINTS = {
    (PLANE, SPHERE): 1,
    (PLANE, BOX): 4,
    (PLANE, CAPSULE): 2,
    (PLANE, CYLINDER): 8,
    (SPHERE, SPHERE): 1,
    (SPHERE, BOX): 1,
    (SPHERE, CAPSULE): 1,
    (BOX, BOX): 8,
    (BOX, CAPSULE): 3,
    (CAPSULE, CAPSULE): 1,
    (PLANE, HULL): 4,
    (SPHERE, HULL): HULL_CONTACTS,
    (BOX, HULL): HULL_CONTACTS,
    (CAPSULE, HULL): HULL_CONTACTS,
    (CYLINDER, HULL): HULL_CONTACTS,
    (HULL, HULL): HULL_CONTACTS,
}


def _unit(x: torch.Tensor, axis: int) -> torch.Tensor:
    """A unit world axis shaped like ``x`` (..., 3)."""
    e = torch.zeros_like(x)
    e[..., axis] = 1.0
    return e


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def _to_local(p, gpos, gquat):
    return rc.quaternion_apply(rc.quaternion_conjugate(gquat), p - gpos)


def _from_local_dir(d, gquat):
    return rc.quaternion_apply(gquat, d)


def _box_sdf_local(p: torch.Tensor, half: torch.Tensor):
    """Signed distance + outward normal of a box at local point(s) p.

    p: (..., 3), half: (..., 3). Returns (dist (...,), normal (..., 3)).
    """
    q = torch.abs(p) - half
    outside = torch.clamp(q, min=0.0)
    dist_out = _norm(outside)
    dist_in = torch.clamp(q.amax(-1), max=0.0)
    dist = dist_out + dist_in

    # outward normal: outside -> gradient of ||max(q,0)||; inside -> axis of
    # least penetration, signed by the point's octant
    n_out = outside / torch.clamp(dist_out[..., None], min=1e-9)
    n_in = torch.zeros_like(p).scatter_(-1, torch.argmax(q, -1, keepdim=True), 1.0)
    n = torch.where((dist_out > 0.0)[..., None], n_out, n_in)
    n = n * torch.sign(torch.where(p == 0.0, 1.0, p))
    # renormalize (sign() can zero a component exactly on a face center)
    n = n / torch.clamp(_norm(n, keepdim=True), min=1e-9)
    return dist, n


def _plane_normal(gquat: torch.Tensor) -> torch.Tensor:
    return rc.quaternion_apply(gquat, _unit(gquat[..., :3], 2))


def _plane_height(p, gpos, n):
    """Signed height of point(s) above the plane."""
    return torch.sum((p - gpos) * n, -1)


def plane_sphere(p1, q1, s1, p2, q2, s2) -> List[Cand]:
    n = _plane_normal(q1)
    h = _plane_height(p2, p1, n)
    return [(p2 - n * h[..., None], n, s2[..., 0] - h)]


def plane_box(p1, q1, s1, p2, q2, s2) -> List[Cand]:
    """The 4 deepest of the 8 corners (a face manifold needs 4)."""
    n = _plane_normal(q1)
    # the 8 corners' local offsets, x sign slowest and minus first (the
    # reference's corner order), made without a constant from the host
    h = torch.stack([-s2, s2], -2)  # (..., 2, 3)
    shp = s2.shape[:-1] + (2, 2, 2)
    local = torch.stack([
        h[..., :, None, None, 0].expand(shp),
        h[..., None, :, None, 1].expand(shp),
        h[..., None, None, :, 2].expand(shp),
    ], -1).reshape(s2.shape[:-1] + (8, 3))
    corner8 = p2[..., None, :] + rc.quaternion_apply(q2[..., None, :], local)
    depth8 = -_plane_height(corner8, p1[..., None, :], n[..., None, :])  # (..., 8)
    top_d, top_i = top_k_stable(depth8, 4)
    top_c = torch.gather(corner8, -2, top_i[..., None].expand(top_i.shape + (3,)))
    return [(top_c[..., i, :], n, top_d[..., i]) for i in range(4)]


def plane_capsule(p1, q1, s1, p2, q2, s2) -> List[Cand]:
    n = _plane_normal(q1)
    r, hl = s2[..., 0], s2[..., 1]
    axis = rc.quaternion_apply(q2, _unit(p2, 2))
    out = []
    for sgn in (-1.0, 1.0):
        end = p2 + axis * (sgn * hl)[..., None]
        h = _plane_height(end, p1, n)
        out.append((end - n * h[..., None], n, r - h))
    return out


def plane_cylinder(p1, q1, s1, p2, q2, s2) -> List[Cand]:
    """4 rim points per cap (8 candidates)."""
    n = _plane_normal(q1)
    r, hl = s2[..., 0:1], s2[..., 1:2]
    R = rc.quaternion_to_matrix(q2)
    ax, ay, az = R[..., :, 0], R[..., :, 1], R[..., :, 2]
    out = []
    for sgn in (-1.0, 1.0):
        cap = p2 + az * (sgn * hl)
        for ca, cb in ((1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0)):
            pt = cap + ax * (r * ca) + ay * (r * cb)
            out.append((pt, n, -_plane_height(pt, p1, n)))
    return out


def sphere_sphere(p1, q1, s1, p2, q2, s2) -> List[Cand]:
    d = p2 - p1
    dist = _norm(d)
    n = d / torch.clamp(dist[..., None], min=1e-9)
    depth = s1[..., 0] + s2[..., 0] - dist
    return [(p1 + n * (s1[..., 0:1] - 0.5 * depth[..., None]), n, depth)]


def _sphere_vs_box(center, radius, bp, bq, bs) -> Cand:
    """Sphere (geom1 side) vs box (geom2 side): the normal pushes the BOX away."""
    dist, n_l = _box_sdf_local(_to_local(center, bp, bq), bs)
    n_w = _from_local_dir(n_l, bq)
    # n_w points from the box surface toward the sphere center
    clipped = torch.minimum(torch.maximum(dist, -radius), radius)
    return (center - n_w * clipped[..., None], -n_w, radius - dist)


def sphere_box(p1, q1, s1, p2, q2, s2) -> List[Cand]:
    return [_sphere_vs_box(p1, s1[..., 0], p2, q2, s2)]


def sphere_capsule(p1, q1, s1, p2, q2, s2) -> List[Cand]:
    r2, hl = s2[..., 0], s2[..., 1]
    axis = rc.quaternion_apply(q2, _unit(p2, 2))
    t = torch.minimum(torch.maximum(torch.sum((p1 - p2) * axis, -1), -hl), hl)
    d = p2 + axis * t[..., None] - p1
    dist = _norm(d)
    n = d / torch.clamp(dist[..., None], min=1e-9)
    depth = s1[..., 0] + r2 - dist
    return [(p1 + n * (s1[..., 0:1] - 0.5 * depth[..., None]), n, depth)]


def _col(R: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Column j (...,) of R (..., 3, 3) -> (..., 3)."""
    return torch.gather(R, -1, j[..., None, None].expand(R.shape[:-1] + (1,)))[..., 0]


def _entry(s: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Entry j (...,) of s (..., 3) -> (...,)."""
    return torch.gather(s, -1, j[..., None])[..., 0]


def box_box(p1, q1, s1, p2, q2, s2) -> List[Cand]:
    """Box-box via face-axis SAT normal + reference-face clip manifold.

    The separating-axis test over the 6 face normals picks one contact
    normal (the minimum-overlap axis). The manifold is the face-clip
    construction: project the incident face onto the reference face plane,
    then emit the 4 incident-face corners clamped into the reference face
    rect and the 4 reference rect corners inside the projected incident face,
    with depth from the incident-plane equation at each point. Edge-edge
    cases are approximated by the clamped corners. 8 static rows. Columns and
    entries are picked with ``gather`` where the reference contracts with
    one-hot vectors.
    """
    R1 = rc.quaternion_to_matrix(q1)  # (..., 3, 3), columns = box axes
    R2 = rc.quaternion_to_matrix(q2)
    d = p2 - p1

    axes = [R1[..., :, i] for i in range(3)] + [R2[..., :, i] for i in range(3)]
    overlaps, signed = [], []
    for a in axes:
        r1 = sum(torch.abs(torch.sum(a * R1[..., :, i], -1)) * s1[..., i] for i in range(3))
        r2 = sum(torch.abs(torch.sum(a * R2[..., :, i], -1)) * s2[..., i] for i in range(3))
        dist = torch.sum(d * a, -1)
        overlaps.append(r1 + r2 - torch.abs(dist))
        signed.append(dist)
    overlaps = torch.stack(overlaps, -1)  # (..., 6)
    signed = torch.stack(signed, -1)
    sep, k = torch.min(overlaps, -1)  # min overlap (< 0: separated), first index on ties
    axes_st = torch.stack(axes, -2)  # (..., 6, 3)
    a_min = torch.gather(axes_st, -2, k[..., None, None].expand(k.shape + (1, 3)))[..., 0, :]
    sgn = torch.sign(_entry(signed, k))
    sgn = torch.where(sgn == 0.0, 1.0, sgn)
    n = a_min * sgn[..., None]  # from box1 toward box2

    separated = sep < -MARGIN
    ref_is_1 = k < 3

    def sel(a, b):
        return torch.where(ref_is_1[..., None], a, b)

    # reference box = owner of the SAT axis; incident box = the other
    p_r, p_i = sel(p1, p2), sel(p2, p1)
    s_r, s_i = sel(s1, s2), sel(s2, s1)
    R_r = torch.where(ref_is_1[..., None, None], R1, R2)
    R_i = torch.where(ref_is_1[..., None, None], R2, R1)
    n_ri = sel(n, -n)  # from the ref box toward the inc box

    # reference face frame: a = SAT axis, (u, v) = the other two box axes
    a_idx = k % 3
    u_idx, v_idx = (a_idx + 1) % 3, (a_idx + 2) % 3
    u, v = _col(R_r, u_idx), _col(R_r, v_idx)
    su, sv, sa = _entry(s_r, u_idx), _entry(s_r, v_idx), _entry(s_r, a_idx)
    c_face = p_r + n_ri * sa[..., None]  # ref face center (face toward inc)

    # incident face: the inc-box axis most anti-parallel to n_ri
    dots = torch.sum(R_i * n_ri[..., :, None], -2)  # (..., 3)
    j = torch.argmax(torch.abs(dots), -1)
    e1_idx, e2_idx = (j + 1) % 3, (j + 2) % 3
    dj = _entry(dots, j)
    f_sign = -torch.sign(torch.where(dj == 0.0, 1.0, dj))
    f_n = _col(R_i, j) * f_sign[..., None]  # inc face normal, toward ref
    e1, e2 = _col(R_i, e1_idx), _col(R_i, e2_idx)
    sj, he1, he2 = _entry(s_i, j), _entry(s_i, e1_idx), _entry(s_i, e2_idx)
    c_inc = p_i + f_n * sj[..., None]

    # incident-face corners in (s, t, h): ref-face tangent coords + height
    # along n_ri (h < 0 = penetrating below the ref face)
    def proj(pt):
        rel = pt - c_face
        return torch.sum(rel * u, -1), torch.sum(rel * v, -1), torch.sum(rel * n_ri, -1)

    csigns = ((-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0))
    cs, ct, ch = [], [], []
    for sx, sy in csigns:
        s_, t_, h_ = proj(c_inc + e1 * (sx * he1)[..., None] + e2 * (sy * he2)[..., None])
        cs.append(s_)
        ct.append(t_)
        ch.append(h_)

    # incident plane in ref coords: h(s, t) = h0 + beta*(s-s0) + gamma*(t-t0)
    As, At, Ah = cs[1] - cs[0], ct[1] - ct[0], ch[1] - ch[0]
    Bs, Bt, Bh = cs[3] - cs[0], ct[3] - ct[0], ch[3] - ch[0]
    det = As * Bt - At * Bs
    degen = torch.abs(det) < 1e-9  # incident face edge-on to the ref face
    det_safe = torch.where(degen, 1.0, det)
    beta = torch.where(degen, 0.0, (Ah * Bt - Bh * At) / det_safe)
    gamma = torch.where(degen, 0.0, (As * Bh - Bs * Ah) / det_safe)

    def h_at(s_, t_):
        return ch[0] + beta * (s_ - cs[0]) + gamma * (t_ - ct[0])

    # inside test for the projected incident face (a parallelogram): solve
    # pt - center = alpha*(A/2) + tau*(B/2); inside iff |alpha|,|tau| <= 1
    mcs = 0.25 * sum(cs)
    mct = 0.25 * sum(ct)
    tol_a = 1.0 + 2.0 * MARGIN / torch.clamp(torch.sqrt(As * As + At * At), min=1e-6)
    tol_b = 1.0 + 2.0 * MARGIN / torch.clamp(torch.sqrt(Bs * Bs + Bt * Bt), min=1e-6)

    def in_inc(s_, t_):
        ds_, dt_ = s_ - mcs, t_ - mct
        alpha = 2.0 * (ds_ * Bt - dt_ * Bs) / det_safe
        tau = 2.0 * (At * ds_ - As * dt_) / det_safe
        return (~degen) & (torch.abs(alpha) <= tol_a) & (torch.abs(tau) <= tol_b)

    rows = []  # (s, t, h, valid)
    # rows 1-4: incident corners clamped into the reference face rect
    for i in range(4):
        s_cl = torch.minimum(torch.maximum(cs[i], -su), su)
        t_cl = torch.minimum(torch.maximum(ct[i], -sv), sv)
        # a clamped point must still lie on the incident patch; an unclamped
        # corner is on it by construction
        moved = (torch.abs(s_cl - cs[i]) > 1e-7) | (torch.abs(t_cl - ct[i]) > 1e-7)
        ok = torch.where(moved, in_inc(s_cl, t_cl), True)
        rows.append((s_cl, t_cl, torch.where(moved, h_at(s_cl, t_cl), ch[i]), ok))
    # rows 5-8: reference rect corners inside the projected incident face
    for sx, sy in csigns:
        s0, t0 = sx * su, sy * sv
        rows.append((s0, t0, h_at(s0, t0), in_inc(s0, t0)))

    # drop near-coincident rows (a duplicated point would double its impulse)
    scale = torch.clamp(torch.maximum(su, sv), min=1e-3)
    eps2 = (1e-3 * scale) ** 2
    out = []
    for m, (s_m, t_m, h_m, ok_m) in enumerate(rows):
        dup = torch.zeros_like(ok_m)
        for l in range(m):
            s_l, t_l, _, ok_l = rows[l]
            dup = dup | (((s_m - s_l) ** 2 + (t_m - t_l) ** 2 < eps2) & ok_l)
        depth = torch.where(ok_m & ~dup & ~separated, -h_m, BAD_DEPTH)
        pos = (c_face + u * s_m[..., None] + v * t_m[..., None]
               + n_ri * torch.clamp(h_m, max=0.0)[..., None])
        out.append((pos, n, depth))
    return out


def box_capsule(p1, q1, s1, p2, q2, s2) -> List[Cand]:
    """The capsule segment sampled at its ends and middle, each as sphere-vs-box."""
    r, hl = s2[..., 0], s2[..., 1]
    axis = rc.quaternion_apply(q2, _unit(p2, 2))
    out = []
    for t in (-1.0, 0.0, 1.0):
        pos, n, depth = _sphere_vs_box(p2 + axis * (t * hl)[..., None], r, p1, q1, s1)
        # _sphere_vs_box treats the sphere as geom1; the capsule is geom2
        out.append((pos, -n, depth))
    return out


def capsule_capsule(p1, q1, s1, p2, q2, s2) -> List[Cand]:
    r1, h1 = s1[..., 0], s1[..., 1]
    r2, h2 = s2[..., 0], s2[..., 1]
    a1 = rc.quaternion_apply(q1, _unit(p1, 2))
    a2 = rc.quaternion_apply(q2, _unit(p2, 2))

    def clip(x, h):
        return torch.minimum(torch.maximum(x, -h), h)

    # closest points between the segments (clamped coordinates)
    d = p2 - p1
    a1d = torch.sum(a1 * d, -1)
    a2d = torch.sum(a2 * d, -1)
    a12 = torch.sum(a1 * a2, -1)
    denom = 1.0 - a12 * a12
    t1 = torch.where(denom > 1e-6, (a1d - a12 * a2d) / torch.clamp(denom, min=1e-6), 0.0)
    t1 = clip(t1, h1)
    t2 = clip(torch.sum((p1 + a1 * t1[..., None] - p2) * a2, -1), h2)
    t1 = clip(torch.sum((p2 + a2 * t2[..., None] - p1) * a1, -1), h1)
    c1 = p1 + a1 * t1[..., None]
    delta = p2 + a2 * t2[..., None] - c1
    dist = _norm(delta)
    n = delta / torch.clamp(dist[..., None], min=1e-9)
    depth = r1 + r2 - dist
    return [(c1 + n * (r1[..., None] - 0.5 * depth[..., None]), n, depth)]


# ======================================================================
# convex hull narrowphase (geom type HULL): support-function SAT
# ======================================================================
# Convex shapes are vertex clouds (building/cooking.py). A primitive in a
# hull pair becomes an equivalent cloud with a margin radius (sphere = 1
# vertex + r, capsule = 2 + r, box = 8 corners, cylinder = 16 rim points).
# The contact normal is the minimum-penetration axis over both clouds'
# facet normals (each signed both ways) and the centre line; the manifold
# is the 4 deepest vertices of the incident cloud along it.

_BOX_CORNERS = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32
)  # (8, 3)
_CYL_RIM = np.stack(
    [np.cos(np.pi / 4 * np.arange(8)), np.sin(np.pi / 4 * np.arange(8)), np.zeros(8)], -1
).astype(np.float32)  # (8, 3)


def hull_group_tables(t1: int, i1: np.ndarray, i2: np.ndarray, geom_hull: np.ndarray, device) -> dict:
    """Device tables of one (t1, HULL) pair group, built once into the
    model's plan: the hull ids of its HULL sides and the local vertex cloud
    and facet normals of a primitive first side."""
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    P = len(i1)
    out = {"h2": t(geom_hull[i2], torch.int64)}
    if t1 == HULL:
        out["h1"] = t(geom_hull[i1], torch.int64)
    elif t1 == BOX:
        out["verts1"] = t(_BOX_CORNERS)
        out["dirs1"] = t(np.eye(3, dtype=np.float32)[None].repeat(P, 0))
    elif t1 == CAPSULE:
        out["verts1"] = t([[0.0, 0, -1], [0.0, 0, 1]])
        out["dirs1"] = t(np.array([[[0.0, 0, 1]]], np.float32).repeat(P, 0))
    elif t1 == CYLINDER:
        out["verts1"] = t(np.concatenate([_CYL_RIM + [0, 0, 1.0], _CYL_RIM + [0, 0, -1.0]], 0))
        out["dirs1"] = t(np.concatenate([_CYL_RIM[:4], [[0, 0, 1.0]]], 0)[None].repeat(P, 0))
    elif t1 not in (PLANE, SPHERE):
        raise ValueError(f"geom type {t1} cannot enter a hull pair")
    return out


def _hull_table(table: torch.Tensor, hid: torch.Tensor) -> torch.Tensor:
    """Rows ``hid`` (P,) of a hull table (NH, N, 3) -> (P, N, 3), or of a
    per-env one (B, NH, N, 3) -> (B, P, N, 3)."""
    return table[:, hid] if table.ndim == 4 else table[hid]


def _as_hull_operand(model: Model, ttype: int, tables: dict, side: int, size: torch.Tensor):
    """(verts, dirs, margin) of one side of a hull pair: local verts
    (B, P, V, 3) or (P, V, 3), facet normals (P, D, 3) or (B, P, D, 3) or
    None, margin radius (B, P) or None (zero)."""
    if ttype == HULL:
        hid = tables[f"h{side}"]
        return _hull_table(model.hull_verts, hid), _hull_table(model.hull_dirs, hid), None
    if ttype == BOX:
        return tables["verts1"] * size[..., None, :], tables["dirs1"], None
    if ttype == SPHERE:
        return torch.zeros_like(size[..., None, :]), None, size[..., 0]
    if ttype == CAPSULE:
        return tables["verts1"] * size[..., 1:2, None], tables["dirs1"], size[..., 0]
    if ttype == CYLINDER:
        scale = torch.stack([size[..., 0], size[..., 0], size[..., 1]], -1)  # (B, P, 3)
        return tables["verts1"] * scale[..., None, :], tables["dirs1"], None
    raise ValueError(f"geom type {ttype} cannot enter a hull pair")


def _world_cloud(p, q, v):
    """Local cloud (P, V, 3) or (B, P, V, 3) at poses p (B, P, 3), q (B, P, 4)."""
    v = v.expand(p.shape[:2] + v.shape[-2:])
    return p[:, :, None] + rc.quaternion_apply(q[:, :, None], v)


def _pad_verts(x: torch.Tensor, V: int) -> torch.Tensor:
    """Pad axis 2 of x (B, P, n, ...) to V by repeating its first entry."""
    if x.shape[2] == V:
        return x
    return torch.cat([x] + [x[:, :, :1]] * (V - x.shape[2]), 2)


def _support_sat(pA, qA, vA, dA, rA, pB, qB, vB, dB, rB) -> List[Cand]:
    """Generic convex-convex narrowphase: HULL_CONTACTS candidates.

    pX (B,P,3), qX (B,P,4), vX local verts (B,P,V,3) or (P,V,3), dX local
    candidate normals (P,D,3), (B,P,D,3) or None, rX margin (B,P) or None.
    """
    B, P = pA.shape[:2]
    wA = _world_cloud(pA, qA, vA)  # (B, P, VA, 3)
    wB = _world_cloud(pB, qB, vB)
    zero = torch.zeros_like(pA[..., 0])
    r2 = ((zero if rA is None else rA) + (zero if rB is None else rB))[:, :, None]

    def wdirs(q, d):
        d = d[None] if d.ndim == 3 else d
        d = d.expand((B, P) + d.shape[-2:])
        return rc.quaternion_apply(q[:, :, None], d)

    cands = []
    nA = 0
    if dA is not None:
        cands.append(wdirs(qA, dA))
        nA = dA.shape[-2]
    if dB is not None:
        cands.append(wdirs(qB, dB))
    cl = pB - pA
    cands.append((cl / torch.clamp(_norm(cl, keepdim=True), min=1e-9))[:, :, None])
    dirs = torch.cat(cands, 2)  # (B, P, D, 3)
    D = dirs.shape[2]

    dotA = torch.einsum("bpvk,bpdk->bpdv", wA, dirs)
    dotB = torch.einsum("bpvk,bpdk->bpdv", wB, dirs)
    # penetration pushing B along +d / along -d
    penP = dotA.amax(-1) - dotB.amin(-1) + r2
    penN = dotB.amax(-1) - dotA.amin(-1) + r2
    pen2 = torch.cat([penP, penN], -1)  # (B, P, 2D)
    k = torch.argmin(pen2, -1)  # the first minimum, as jnp.argmin
    pen = torch.gather(pen2, -1, k[..., None])[..., 0]
    is_neg = k >= D
    kd = torch.where(is_neg, k - D, k)
    dstar = torch.gather(dirs, 2, kd[..., None, None].expand(B, P, 1, 3))[:, :, 0]
    n = torch.where(is_neg[..., None], -dstar, dstar)  # (B, P, 3) pushes B out

    # supports along n; per-vertex penetration of each cloud into the other
    ndotA = torch.einsum("bpvk,bpk->bpv", wA, n)
    ndotB = torch.einsum("bpvk,bpk->bpv", wB, n)
    depthB_v = ndotA.amax(-1)[..., None] + r2 - ndotB  # B verts into A
    depthA_v = ndotA + r2 - ndotB.amin(-1)[..., None]  # A verts into B

    # incident cloud: an axis from A's facet normals makes A's face the
    # reference and B incident; B's normals and the centre line make A
    # incident
    fromA = kd < nA  # (B, P)
    V = max(wA.shape[2], wB.shape[2])
    depth_v = torch.where(fromA[..., None], _pad_verts(depthB_v, V), _pad_verts(depthA_v, V))
    verts_v = torch.where(fromA[..., None, None], _pad_verts(wB, V), _pad_verts(wA, V))
    kk = min(HULL_CONTACTS, V)
    top_d, top_i = top_k_stable(depth_v, kk)  # (B, P, kk)
    top_v = torch.gather(verts_v, 2, top_i[..., None].expand(top_i.shape + (3,)))
    separated = pen < -MARGIN
    out = [(top_v[:, :, i], n, torch.where(separated, BAD_DEPTH, top_d[..., i])) for i in range(kk)]
    while len(out) < HULL_CONTACTS:
        out.append((top_v[:, :, 0], n, torch.full_like(pen, BAD_DEPTH)))
    return out


def plane_hull(model: Model, tables: dict, p1, q1, s1, p2, q2, s2) -> List[Cand]:
    """Plane vs convex hull: the 4 deepest proxy vertices below the plane."""
    n = _plane_normal(q1)
    w = _world_cloud(p2, q2, _hull_table(model.hull_verts, tables["h2"]))  # (B, P, V, 3)
    depth = -torch.sum((w - p1[:, :, None]) * n[:, :, None], -1)  # (B, P, V)
    top_d, top_i = top_k_stable(depth, 4)
    top_w = torch.gather(w, 2, top_i[..., None].expand(top_i.shape + (3,)))
    return [(top_w[:, :, i], n, top_d[..., i]) for i in range(4)]


def hull_pair(model: Model, tables: dict, t1: int, p1, q1, s1, p2, q2, s2) -> List[Cand]:
    """(SPHERE | BOX | CAPSULE | CYLINDER | HULL) vs HULL."""
    vA, dA, rA = _as_hull_operand(model, t1, tables, 1, s1)
    vB, dB, rB = _as_hull_operand(model, HULL, tables, 2, s2)
    return _support_sat(p1, q1, vA, dA, rA, p2, q2, vB, dB, rB)


# (type1, type2) -> fn(p1, q1, s1, p2, q2, s2) -> [(pos, normal, depth), ...]
_DISPATCH: Dict[Tuple[int, int], Callable] = {
    (PLANE, SPHERE): plane_sphere,
    (PLANE, BOX): plane_box,
    (PLANE, CAPSULE): plane_capsule,
    (PLANE, CYLINDER): plane_cylinder,
    (SPHERE, SPHERE): sphere_sphere,
    (SPHERE, BOX): sphere_box,
    (SPHERE, CAPSULE): sphere_capsule,
    (BOX, BOX): box_box,
    (BOX, CAPSULE): box_capsule,
    (CAPSULE, CAPSULE): capsule_capsule,
}


def contacts_per_pair(t1: int, t2: int) -> int:
    return _POINTS.get((t1, t2), 0)


def collide(model: Model, data: Data, kin=None) -> Contact:
    """Run the narrowphase for all candidate pairs -> static-shape Contact set.

    ``kin`` is the (xpos, xquat, v, w) tuple from ``forward_kinematics_raw``;
    when given, geom poses derive from it instead of from data.xpos.
    """
    B = data.batch_size
    dev = data.qpos.device
    plan = model_plan(model)
    fns = []
    for gi, (t1, t2, _, _) in enumerate(plan.pair_groups):
        tables = plan.hull_tables.get(gi)
        if tables is not None and t1 == PLANE:
            fn = _bind(plane_hull, model, tables)
        elif tables is not None:
            fn = _bind(hull_pair, model, tables, t1)
        else:
            fn = _DISPATCH.get((t1, t2))
        if fn is None:
            raise NotImplementedError(
                f"narrowphase for {_TYPE_NAMES.get(t1, t1)}-{_TYPE_NAMES.get(t2, t2)} "
                "pairs is not ported yet"
            )
        fns.append(fn)
    if not fns:
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return Contact(
            geom1=plan.contact_geom1, geom2=plan.contact_geom2,
            pos=z(B, 0, 3), normal=z(B, 0, 3), depth=z(B, 0), friction=z(B, 0),
            restitution=z(B, 0), impulse=z(B, 0, 3), overflow=z(B, dtype=torch.int32),
        )

    if kin is not None:
        gpos, gquat = geom_poses_from(model, kin[0], kin[1])
    else:
        gpos, gquat = geom_poses(model, data)
    size = model.geom_size.expand((B,) + tuple(model.geom_size.shape[-2:]))
    fric = model.geom_friction.expand(B, model.ngeom)
    rest = (
        torch.zeros(B, model.ngeom, device=dev)
        if model.geom_restitution is None
        else model.geom_restitution.expand(B, model.ngeom)
    )

    pos_l, n_l, d_l, f_l, e_l = [], [], [], [], []
    for fn, (_, _, i1, i2) in zip(fns, plan.pair_groups):
        cands = fn(gpos[:, i1], gquat[:, i1], size[:, i1], gpos[:, i2], gquat[:, i2], size[:, i2])
        mu = 0.5 * (fric[:, i1] + fric[:, i2])  # (B, P)
        en = 0.5 * (rest[:, i1] + rest[:, i2])  # (B, P) PhysX average combine
        for cp, cn, cd in cands:
            pos_l.append(cp)
            n_l.append(cn.expand(cp.shape))
            d_l.append(cd)
            f_l.append(mu)
            e_l.append(en)

    C = len(plan.contact_geom1)
    return Contact(
        geom1=plan.contact_geom1,
        geom2=plan.contact_geom2,
        pos=torch.cat(pos_l, 1),
        normal=torch.cat(n_l, 1),
        depth=torch.cat(d_l, 1),
        friction=torch.cat(f_l, 1),
        restitution=torch.cat(e_l, 1),
        impulse=torch.zeros(B, C, 3, device=dev),
        overflow=torch.zeros(B, dtype=torch.int32, device=dev),
    )


def _bind(fn, *head):
    return lambda *args: fn(*head, *args)
