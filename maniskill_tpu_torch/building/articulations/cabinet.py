"""Heterogeneous procedural cabinets (counterpart of
maniskill_tpu/building/articulations/cabinet.py).

One **union template** stands for every env's cabinet: a fixed-topology
articulation with MAX_DRAWERS prismatic and MAX_DOORS revolute slots, where
per-env parameter tables (joint origins, joint limits, geom sizes and
offsets) select which slots exist and what shape they take. A locked slot
(limits [0, 0], millimetre geoms recessed into the shell) is how an env's
cabinet has fewer links and dofs under one static shape.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ...physics.types import BOX, HINGE, SLIDE

MAX_DRAWERS = 3
MAX_DOORS = 2
NUM_SLOTS = MAX_DRAWERS + MAX_DOORS
WALL = 0.015
_TINY = 0.004  # half-size of parked (inactive) slot geoms

# variant table: the structural diversity of sampling real models. dims =
# cabinet half-extents (x depth, y width, z height); drawers = number of
# active drawer slots (stacked bottom-up); doors = number of active door
# slots (0: left-hinged, 1: right-hinged).
CABINET_VARIANTS: List[dict] = [
    dict(name="dresser3", dims=(0.18, 0.25, 0.35), drawers=3, doors=0),
    dict(name="chest2", dims=(0.20, 0.28, 0.26), drawers=2, doors=0),
    dict(name="cupboard2", dims=(0.20, 0.30, 0.30), drawers=0, doors=2),
    dict(name="combo", dims=(0.18, 0.26, 0.32), drawers=1, doors=1),
]


@dataclasses.dataclass
class CabinetMeta:
    """Static template wiring: slot -> bodies/dofs/geoms.

    Each logical shape is (collision_geom, visual_geom) — per-env sizes and
    offsets are scattered to both so physics and render stay consistent.
    dof/qpos addresses resolve lazily (wired at scene.finalize)."""

    base_body: int
    base_geoms: np.ndarray  # (6, 2) shell panel geom ids
    slot_links: list  # (5,) Link (3 drawers then 2 doors)
    slot_joints: list  # (5,) ArticulationJoint
    panel_geoms: np.ndarray  # (5, 2) body-box geom ids per slot
    handle_geoms: np.ndarray  # (5, 2) handle-bar geom ids per slot

    @property
    def slot_bodies(self) -> np.ndarray:
        return np.array([l.body_id for l in self.slot_links], np.int32)

    @property
    def slot_dofs(self) -> np.ndarray:
        return np.array([j.dof_adr for j in self.slot_joints], np.int32)

    @property
    def slot_qadrs(self) -> np.ndarray:
        return np.array([j.q_adr for j in self.slot_joints], np.int32)


@dataclasses.dataclass
class CabinetInstance:
    """Per-env realization tables (host numpy until bound to the scene)."""

    variant_ids: np.ndarray  # (B,)
    active: np.ndarray  # (B, 5) bool
    limits: np.ndarray  # (B, 5, 2)
    handle_local: np.ndarray  # (B, 5, 3) handle center in link frame
    dims: np.ndarray  # (B, 3) cabinet half-extents


def build_cabinet_template(scene, name="cabinet", base_pos=(0.0, 0.0, 0.3)):
    """Build the union-template articulation (all slots present, limited).

    Per-env tables applied later choose each env's actual structure.
    Self-collisions are disabled.
    """
    from ..articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec

    hx, hy, hz = 0.2, 0.3, 0.35  # template envelope (max over variants)
    wood = (0.54, 0.39, 0.27, 1.0)
    face = (0.72, 0.58, 0.40, 1.0)
    dark = (0.2, 0.2, 0.2, 1.0)

    b = ArticulationBuilder(scene)
    b.disable_self_collisions = True
    box = lambda hs, pos, color=wood: ShapeSpec(
        BOX, hs, pos, friction=1.0, color=color
    )
    shell = [
        box((hx, hy, WALL), (0, 0, hz - WALL)),   # top
        box((hx, hy, WALL), (0, 0, -hz + WALL)),  # bottom
        box((hx, WALL, hz), (0, -hy + WALL, 0)),  # left
        box((hx, WALL, hz), (0, hy - WALL, 0)),   # right
        box((WALL, hy, hz), (-hx + WALL, 0, 0)),  # back
        box((hx, hy, WALL), (0, 0, 0)),           # shelf (mid)
    ]
    b.add_link(LinkSpec("cabinet_base", None, collisions=shell, visuals=shell))

    for k in range(MAX_DRAWERS):
        body = [
            box((0.12, 0.2, 0.08), (0, 0, 0), face),          # drawer body
            box((0.025, 0.06, 0.012), (0.16, 0, 0), dark),    # handle bar
        ]
        b.add_link(
            LinkSpec(
                f"drawer_{k}", "cabinet_base", SLIDE, f"drawer_{k}_joint",
                origin_pos=(0, 0, -hz + (k + 0.5) * 0.2), axis=(1, 0, 0),
                limit=(0.0, 0.3), damping=5.0,
                collisions=body, visuals=body,
            )
        )
    for k in range(MAX_DOORS):
        side = -1.0 if k == 0 else 1.0  # 0: hinge on left edge, 1: right
        panel = [
            box((WALL, 0.15, 0.25), (0, -side * 0.15, 0), face),
            box((0.025, 0.012, 0.06), (0.03, -side * 0.25, 0), dark),
        ]
        b.add_link(
            LinkSpec(
                f"door_{k}", "cabinet_base", HINGE, f"door_{k}_joint",
                origin_pos=(hx, side * hy, 0), axis=(0, 0, side),
                limit=(0.0, 2.0), damping=2.0,
                collisions=panel, visuals=panel,
            )
        )
    b.set_initial_pose(np.array([*base_pos, 1, 0, 0, 0]))
    art = b.build(name)

    mb = scene.mb

    def body_geoms(body_id):
        # order of addition: collisions then visuals, each [shapes...]
        return [i for i, g in enumerate(mb.geoms) if g.body == body_id]

    base = art.links_map["cabinet_base"]
    slot_links = [art.links_map[f"drawer_{k}"] for k in range(MAX_DRAWERS)] + [
        art.links_map[f"door_{k}"] for k in range(MAX_DOORS)
    ]
    slot_joints = [
        art.joints_map[f"drawer_{k}_joint"] for k in range(MAX_DRAWERS)
    ] + [art.joints_map[f"door_{k}_joint"] for k in range(MAX_DOORS)]
    bg = body_geoms(base.body_id)  # 6 col + 6 vis
    sg = [body_geoms(l.body_id) for l in slot_links]  # 2 col + 2 vis each
    meta = CabinetMeta(
        base_body=base.body_id,
        base_geoms=np.array([[bg[i], bg[6 + i]] for i in range(6)], np.int32),
        slot_links=slot_links,
        slot_joints=slot_joints,
        panel_geoms=np.array([[g[0], g[2]] for g in sg], np.int32),
        handle_geoms=np.array([[g[1], g[3]] for g in sg], np.int32),
    )
    return art, meta


def sample_cabinet_variants(
    rng: np.random.RandomState, num_envs: int, variant_ids=None
) -> CabinetInstance:
    """Sample a variant + continuous size jitter per env (host numpy).

    ``variant_ids`` pins the structure choice (tasks restrict to variants
    that have the target joint kind)."""
    B = num_envs
    vids = (
        np.asarray(variant_ids, np.int64)
        if variant_ids is not None
        else rng.randint(0, len(CABINET_VARIANTS), B)
    )
    active = np.zeros((B, NUM_SLOTS), bool)
    limits = np.zeros((B, NUM_SLOTS, 2), np.float32)
    handle_local = np.zeros((B, NUM_SLOTS, 3), np.float32)
    dims = np.zeros((B, 3), np.float32)
    scale = rng.uniform(0.9, 1.1, B).astype(np.float32)
    for i in range(B):
        v = CABINET_VARIANTS[vids[i]]
        dims[i] = np.asarray(v["dims"], np.float32) * scale[i]
        nd, ndoor = v["drawers"], v["doors"]
        active[i, :nd] = True
        active[i, MAX_DRAWERS : MAX_DRAWERS + ndoor] = True
        hx = dims[i, 0]
        limits[i, :nd, 1] = 1.1 * hx  # drawer travel
        limits[i, MAX_DRAWERS : MAX_DRAWERS + ndoor, 1] = np.pi / 2
    return CabinetInstance(
        variant_ids=vids,
        active=active,
        limits=limits,
        handle_local=handle_local,  # filled by apply_cabinet_variants
        dims=dims,
    )


def apply_cabinet_variants(scene, meta: CabinetMeta, inst: CabinetInstance):
    """Bind the per-env tables into the scene's Model (host-side math only).

    Computes shell panel sizes/offsets, slot joint origins, slot geometry and
    per-env limits from each env's variant, then scatters them with the
    scene's heterogeneous-parameter APIs.
    """
    B = inst.variant_ids.shape[0]
    hx, hy, hz = inst.dims[:, 0], inst.dims[:, 1], inst.dims[:, 2]
    zeros = np.zeros(B, np.float32)

    # --- base shell: 6 panels -------------------------------------------
    shell_sizes = np.stack(
        [
            np.stack([hx, hy, np.full(B, WALL)], 1),
            np.stack([hx, hy, np.full(B, WALL)], 1),
            np.stack([hx, np.full(B, WALL), hz], 1),
            np.stack([hx, np.full(B, WALL), hz], 1),
            np.stack([np.full(B, WALL), hy, hz], 1),
            # shelf exists only for the combo variant (drawer above, door
            # below); parked to a sliver elsewhere
            np.stack(
                [
                    np.where(inst.variant_ids == 3, hx, _TINY),
                    np.where(inst.variant_ids == 3, hy, _TINY),
                    np.full(B, WALL),
                ],
                1,
            ),
        ],
        axis=1,
    )  # (B, 6, 3)
    shell_pos = np.stack(
        [
            np.stack([zeros, zeros, hz - WALL], 1),
            np.stack([zeros, zeros, -hz + WALL], 1),
            np.stack([zeros, -hy + WALL, zeros], 1),
            np.stack([zeros, hy - WALL, zeros], 1),
            np.stack([-hx + WALL, zeros, zeros], 1),
            np.stack([zeros, zeros, np.where(inst.variant_ids == 3, 0.2 * hz, -hz)], 1),
        ],
        axis=1,
    )
    pair = lambda v: np.repeat(v, 2, axis=1)  # col+vis geom per logical shape
    scene.set_per_env_geom_sizes_by_id(
        meta.base_geoms.reshape(-1), pair(shell_sizes)
    )
    scene.set_per_env_geom_pos(meta.base_geoms.reshape(-1), pair(shell_pos))
    # cabinet root: bottom on the ground at per-env height
    scene.set_per_env_body_pos(
        [meta.base_body],
        np.stack([np.full(B, 0.1, np.float32), zeros, hz], 1)[:, None, :],
    )

    # --- slots -----------------------------------------------------------
    origins = np.zeros((B, NUM_SLOTS, 3), np.float32)
    panel_sizes = np.full((B, NUM_SLOTS, 3), _TINY, np.float32)
    panel_pos = np.zeros((B, NUM_SLOTS, 3), np.float32)
    handle_sizes = np.full((B, NUM_SLOTS, 3), _TINY, np.float32)
    handle_pos = np.zeros((B, NUM_SLOTS, 3), np.float32)
    handle_local = np.zeros((B, NUM_SLOTS, 3), np.float32)

    for i in range(B):
        v = CABINET_VARIANTS[inst.variant_ids[i]]
        nd = v["drawers"]
        hxe, hye, hze = inst.dims[i]
        if nd:
            # drawers stack bottom-up over the drawer zone; combo puts its
            # single drawer in the top fifth of the cabinet
            if v["name"] == "combo":
                zs = [hze * 0.6]
                dhalf = hze * 0.35
            else:
                zone = 2 * (hze - 2 * WALL)
                dhalf = zone / (2 * nd) - 0.01
                zs = [-hze + WALL * 2 + (2 * k + 1) * zone / (2 * nd) for k in range(nd)]
            for k in range(nd):
                origins[i, k] = (0, 0, zs[k])
                panel_sizes[i, k] = (hxe - 2 * WALL, hye - 3 * WALL, dhalf)
                panel_pos[i, k] = (0, 0, 0)
                handle_sizes[i, k] = (0.025, 0.06, 0.012)
                handle_pos[i, k] = (hxe + 0.02, 0, 0)
                handle_local[i, k] = (hxe + 0.045, 0, 0)
        for k in range(v["doors"]):
            s = MAX_DRAWERS + k
            side = -1.0 if k == 0 else 1.0
            if v["name"] == "combo":
                # door covers the lower section, full width (hinge left)
                door_h = hze * 0.55
                door_w = hye - WALL
                door_z = -hze * 0.35
            else:
                door_h = hze - 2 * WALL
                door_w = hye / v["doors"]
                door_z = 0.0
            origins[i, s] = (hxe, side * hye, door_z)
            panel_sizes[i, s] = (WALL, door_w / 1.0 * 0.5, door_h * 0.5)
            panel_pos[i, s] = (0, -side * door_w * 0.5, 0)
            handle_sizes[i, s] = (0.025, 0.012, 0.06)
            handle_pos[i, s] = (0.03, -side * (door_w - 0.04), 0)
            handle_local[i, s] = (0.045, -side * (door_w - 0.04), 0)
        # parked slots: recess at the shell centre, locked shut
        for s in range(NUM_SLOTS):
            if not inst.active[i, s]:
                origins[i, s] = (-hxe * 0.5, 0, 0)

    inst.handle_local = handle_local
    scene.set_per_env_body_pos(meta.slot_bodies, origins)
    scene.set_per_env_geom_sizes_by_id(
        meta.panel_geoms.reshape(-1), pair(panel_sizes)
    )
    scene.set_per_env_geom_pos(meta.panel_geoms.reshape(-1), pair(panel_pos))
    scene.set_per_env_geom_sizes_by_id(
        meta.handle_geoms.reshape(-1), pair(handle_sizes)
    )
    scene.set_per_env_geom_pos(meta.handle_geoms.reshape(-1), pair(handle_pos))
    scene.set_per_env_dof_limits(meta.slot_dofs, inst.limits)
    return inst
