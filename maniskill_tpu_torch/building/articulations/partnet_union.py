"""Per-env heterogeneous PartNet-Mobility cabinets (counterpart of
maniskill_tpu/building/articulations/partnet_union.py).

Every env samples its own real model. As with the procedural cabinets
(building/articulations/cabinet.py), ONE static-topology articulation with
MAX_DRAWER_SLOTS prismatic and MAX_DOOR_SLOTS revolute slots stands for all
of them; per-env tables (convex-hull vertex tables, joint origins, joint
limits) are scattered from each env's model. A slot an env's model lacks is
"parked": limits [0, 0] and a centimetre hull recessed inside the shell
(self-collisions are filtered, so parked hulls make no contacts).

Hinge direction is normalised at ingest: a door with URDF axis (0, 0, -1)
and limits [0, u] is exactly a +z hinge with limits [-u, 0], so every door
slot shares the +z axis and the sign of each env's limits encodes the hinge
side; the static topology never changes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ...physics.types import HINGE, HULL, SLIDE

MAX_DRAWER_SLOTS = 2
MAX_DOOR_SLOTS = 2
UNION_SLOTS = MAX_DRAWER_SLOTS + MAX_DOOR_SLOTS
_PARK_HALF = 0.004  # parked-slot hull half extent


@dataclasses.dataclass
class SlotSpec:
    """One movable link of a real model, normalized into slot form."""

    kind: str  # "drawer" | "door"
    origin: np.ndarray  # (3,) joint origin in the base-link frame
    limits: np.ndarray  # (2,) lo/hi; doors may be [-u, 0] (right hinge)
    hulls: np.ndarray  # (K, V, 3) link-frame convex hulls (pos folded in)
    handle_local: np.ndarray  # (3,) handle point in the link frame


@dataclasses.dataclass
class PartnetModelSpec:
    """Host-side normalized description of one cooked PartNet model."""

    model_id: str
    base_hulls: np.ndarray  # (Kb, V, 3)
    slots: List[SlotSpec]
    root_z: float  # base-link height putting the model's bbox on the ground
    base_origin: np.ndarray  # (3,) fixed base-link offset from the root


def _link_hulls(spec) -> np.ndarray:
    """Collect a LinkSpec's HULL collisions as (K, V, 3) with the collision
    pose offset folded into the vertices (per-env tables carry verts only)."""
    out = []
    for c in spec.collisions:
        if c.type == HULL and c.hull is not None:
            out.append(np.asarray(c.hull, np.float32) + np.asarray(c.pos, np.float32))
    assert out, f"link {spec.name} has no cooked hulls"
    return np.stack(out)


def _handle_local(spec) -> np.ndarray:
    """Front-face center of the link's collision AABB (the graspable
    handle point)."""
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    for c in spec.collisions:
        if c.hull is not None:
            v = np.asarray(c.hull) + np.asarray(c.pos)
        else:
            half = np.asarray(c.size, float)
            v = np.asarray(c.pos) + np.stack([half, -half])
        lo = np.minimum(lo, v.min(axis=0))
        hi = np.maximum(hi, v.max(axis=0))
    return np.array([hi[0], 0.5 * (lo[1] + hi[1]), 0.5 * (lo[2] + hi[2])], np.float32)


def load_partnet_model_spec(scene, model_id: str) -> PartnetModelSpec:
    """Cook one PartNet URDF and normalize it into slot form."""
    from .partnet_mobility import get_partnet_mobility_builder

    builder, meta = get_partnet_mobility_builder(scene, model_id)
    specs = {s.name: s for s in builder.links}

    base_hulls, slots = [], []
    base_origin = np.zeros(3, np.float32)
    for s in builder.links:
        if s.joint_type == SLIDE:
            lim = s.limit
            lim = (
                (0.0, 1.0)
                if lim is None or not np.all(np.isfinite(lim))
                else (float(lim[0]), float(lim[1]))
            )
            slots.append(
                SlotSpec(
                    kind="drawer",
                    origin=np.asarray(s.origin_pos, np.float32),
                    limits=np.asarray(lim, np.float32),
                    hulls=_link_hulls(s),
                    handle_local=_handle_local(s),
                )
            )
        elif s.joint_type == HINGE:
            lim = s.limit
            lim = (
                (0.0, np.pi / 2)
                if lim is None or not np.all(np.isfinite(lim))
                else (float(lim[0]), float(lim[1]))
            )
            axis = np.asarray(s.axis, np.float32)
            hulls = _link_hulls(s)
            handle = _handle_local(s)
            origin = np.asarray(s.origin_pos, np.float32)
            if axis[2] < 0:
                # -z hinge == +z hinge with negated angle range: mirror the
                # link geometry about the joint (y -> -y, angle -> -angle
                # keeps world motion identical for a z-hinge)
                lim = (-lim[1], -lim[0])
                hulls = hulls * np.array([1, -1, 1], np.float32)
                handle = handle * np.array([1, -1, 1], np.float32)
            slots.append(
                SlotSpec(
                    kind="door",
                    origin=origin,
                    limits=np.asarray(lim, np.float32),
                    hulls=hulls,
                    handle_local=handle,
                )
            )
        else:
            # fixed links aggregate into the base shell, with their chain
            # offset folded into the hull verts
            if s.collisions:
                off = np.asarray(s.origin_pos, np.float32) if s.parent else 0.0
                for h in _link_hulls(s):
                    base_hulls.append(h + off)
                if s.parent:
                    base_origin = np.asarray(s.origin_pos, np.float32)

    bbox = meta.get("bbox")
    scale = float(meta.get("scale", 1.0))
    root_z = -bbox["min"][2] * scale if bbox else 0.4
    return PartnetModelSpec(
        model_id=str(model_id),
        base_hulls=np.stack(base_hulls),
        slots=slots,
        root_z=float(root_z),
        base_origin=base_origin,
    )


def _pad_hulls(hulls: np.ndarray, k: int) -> np.ndarray:
    """Pad (K0, V, 3) to (k, V, 3) by repeating the first hull (duplicate
    geometry is collision-exact and render-harmless)."""
    if hulls.shape[0] >= k:
        return hulls[:k]
    reps = np.repeat(hulls[:1], k - hulls.shape[0], axis=0)
    return np.concatenate([hulls, reps], axis=0)


def _park_hulls(k: int, v: int) -> np.ndarray:
    """Tiny hull cloud for a parked (inactive) slot."""
    corners = np.stack(
        np.meshgrid(*([[-_PARK_HALF, _PARK_HALF]] * 3), indexing="ij"), axis=-1
    ).reshape(8, 3)
    verts = np.concatenate([corners, np.repeat(corners[:1], v - 8, axis=0)])
    return np.repeat(verts[None], k, axis=0).astype(np.float32)


@dataclasses.dataclass
class PartnetUnionMeta:
    base_body: int
    base_link: object
    slot_links: list
    slot_joints: list
    kinds: List[str]  # per-slot "drawer"/"door"

    @property
    def slot_bodies(self) -> np.ndarray:
        return np.array([l.body_id for l in self.slot_links], np.int32)

    @property
    def slot_dofs(self) -> np.ndarray:
        return np.array([j.dof_adr for j in self.slot_joints], np.int32)

    @property
    def slot_qadrs(self) -> np.ndarray:
        return np.array([j.q_adr for j in self.slot_joints], np.int32)


def build_partnet_union(scene, specs: List[PartnetModelSpec], name="cabinet"):
    """Build the union articulation sized for ``specs``' maxima."""
    from ..articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec
    from ..cooking import HULL_MAX_VERTS

    kb = max(s.base_hulls.shape[0] for s in specs)
    ks = max(
        (sl.hulls.shape[0] for s in specs for sl in s.slots), default=1
    )
    v = HULL_MAX_VERTS

    wood = (0.54, 0.39, 0.27, 1.0)
    face = (0.72, 0.58, 0.40, 1.0)

    def hull_shapes(hulls, color):
        from ..cooking import hull_face_dirs

        return [
            ShapeSpec(HULL, (1, 1, 1), hull=h, hull_dirs=hull_face_dirs(h),
                      friction=1.0, color=color)
            for h in hulls
        ]

    b = ArticulationBuilder(scene)
    b.disable_self_collisions = True
    base0 = _pad_hulls(specs[0].base_hulls, kb)
    shapes = hull_shapes(base0, wood)
    b.add_link(LinkSpec("cabinet_base", None, collisions=shapes, visuals=shapes))

    kinds = []
    for k in range(MAX_DRAWER_SLOTS):
        park = _park_hulls(ks, v)
        shapes = hull_shapes(park, face)
        b.add_link(
            LinkSpec(
                f"drawer_{k}", "cabinet_base", SLIDE, f"drawer_{k}_joint",
                origin_pos=(-0.05, 0, 0), axis=(1, 0, 0), limit=(0.0, 0.0),
                damping=5.0, mass=2.0, inertia=np.full(3, 0.05),
                collisions=shapes, visuals=shapes,
            )
        )
        kinds.append("drawer")
    for k in range(MAX_DOOR_SLOTS):
        park = _park_hulls(ks, v)
        shapes = hull_shapes(park, face)
        b.add_link(
            LinkSpec(
                f"door_{k}", "cabinet_base", HINGE, f"door_{k}_joint",
                origin_pos=(-0.05, 0, 0), axis=(0, 0, 1), limit=(0.0, 0.0),
                damping=2.0, mass=1.5, inertia=np.full(3, 0.04),
                collisions=shapes, visuals=shapes,
            )
        )
        kinds.append("door")
    b.set_initial_pose(np.array([0.1, 0, specs[0].root_z, 1, 0, 0, 0]))
    art = b.build(name)

    base = art.links_map["cabinet_base"]
    slot_links = [art.links_map[f"drawer_{k}"] for k in range(MAX_DRAWER_SLOTS)] + [
        art.links_map[f"door_{k}"] for k in range(MAX_DOOR_SLOTS)
    ]
    slot_joints = [
        art.joints_map[f"drawer_{k}_joint"] for k in range(MAX_DRAWER_SLOTS)
    ] + [art.joints_map[f"door_{k}_joint"] for k in range(MAX_DOOR_SLOTS)]
    meta = PartnetUnionMeta(
        base_body=base.body_id,
        base_link=base,
        slot_links=slot_links,
        slot_joints=slot_joints,
        kinds=kinds,
    )
    return art, meta, (kb, ks)


@dataclasses.dataclass
class PartnetAssignment:
    """Per-env realization tables from a model assignment."""

    model_ids: List[str]  # (B,)
    active: np.ndarray  # (B, S) bool
    limits: np.ndarray  # (B, S, 2) signed dof limits (doors may be [-u,0])
    ranges: np.ndarray  # (B, S) |hi-lo| for open-fraction math
    handle_local: np.ndarray  # (B, S, 3)


def apply_partnet_models(
    scene, meta: PartnetUnionMeta, specs: Dict[str, PartnetModelSpec],
    assign: List[str], kb: int, ks: int,
) -> PartnetAssignment:
    """Scatter per-env tables for the model assignment ``assign`` (len B)."""
    from ..cooking import HULL_MAX_VERTS

    B = len(assign)
    S = UNION_SLOTS
    v = HULL_MAX_VERTS

    base_h = np.zeros((B, kb, v, 3), np.float32)
    slot_h = np.zeros((B, S, ks, v, 3), np.float32)
    origins = np.zeros((B, S, 3), np.float32)
    limits = np.zeros((B, S, 2), np.float32)
    ranges = np.zeros((B, S), np.float32)
    handle_local = np.zeros((B, S, 3), np.float32)
    active = np.zeros((B, S), bool)
    root = np.zeros((B, 3), np.float32)
    park = _park_hulls(ks, v)

    drawer_ids = [i for i, k in enumerate(meta.kinds) if k == "drawer"]
    door_ids = [i for i, k in enumerate(meta.kinds) if k == "door"]

    for i, mid in enumerate(assign):
        ms = specs[str(mid)]
        base_h[i] = _pad_hulls(ms.base_hulls, kb)
        root[i] = (0.1, 0.0, ms.root_z)
        slot_h[i] = park[None]
        origins[i] = (-0.05, 0.0, 0.0)  # parked: recessed into the shell
        nxt = {"drawer": iter(drawer_ids), "door": iter(door_ids)}
        for sl in ms.slots:
            s = next(nxt[sl.kind], None)
            if s is None:
                continue  # more parts than union slots: drop the extra
            active[i, s] = True
            slot_h[i, s] = _pad_hulls(sl.hulls, ks)
            origins[i, s] = sl.origin + ms.base_origin
            limits[i, s] = sl.limits
            ranges[i, s] = sl.limits[1] - sl.limits[0]
            handle_local[i, s] = sl.handle_local

    scene.set_per_env_hulls(meta.base_link, base_h)
    for s, link in enumerate(meta.slot_links):
        scene.set_per_env_hulls(link, slot_h[:, s])
    scene.set_per_env_body_pos(meta.slot_bodies, origins)
    scene.set_per_env_body_pos([meta.base_body], root[:, None, :])
    scene.set_per_env_dof_limits(meta.slot_dofs, limits)
    return PartnetAssignment(
        model_ids=list(assign),
        active=active,
        limits=limits,
        ranges=ranges,
        handle_local=handle_local,
    )
