"""ModelBuilder: programmatic scene construction -> flat ``Model`` tables
(counterpart of maniskill_tpu/physics/builder.py).

Everything compiles to one kinematic forest shared by all envs. The builder
runs in numpy and hands tensors over to the device only in ``finalize``, so
scenes build without JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .collision import contacts_per_pair
from .types import (
    DYNAMIC,
    FIXED,
    FREE,
    HINGE,
    HULL,
    JOINT_NQ,
    JOINT_NV,
    PLANE,
    SLIDE,
    STATIC,
    Model,
    model_from_numpy,
)


@dataclasses.dataclass
class BodyDef:
    name: str
    parent: int
    jnt_type: int
    body_type: int
    pos: np.ndarray  # joint frame in parent coords
    quat: np.ndarray
    jnt_axis: np.ndarray
    mass: float = 0.0
    inertia: np.ndarray = None  # (3,) principal moments
    ipos: np.ndarray = None
    iquat: np.ndarray = None
    limit: Tuple[float, float] = (-np.inf, np.inf)
    damping: float = 0.0
    stiffness: float = 0.0
    springref: float = 0.0
    armature: float = 0.0
    frictionloss: float = 0.0
    # joint name (for articulation views); defaults to body name
    joint_name: Optional[str] = None


@dataclasses.dataclass
class GeomDef:
    name: str
    body: int
    type: int
    size: np.ndarray  # (3,)
    pos: np.ndarray
    quat: np.ndarray
    friction: float = 0.5
    restitution: float = 0.0
    contype: int = 1
    conaffinity: int = 1
    # render metadata
    color: Tuple[float, float, float, float] = (0.5, 0.5, 0.5, 1.0)
    visual: bool = True
    collision: bool = True
    mesh: Optional[tuple] = None  # (verts (V,3) f32, faces (F,3) i32) for MESH visuals
    # baked per-face texture colors for MESH visuals, (F, 3) f32 in [0,1]
    # (render/textures.py: textures are baked to geometry at load time)
    face_colors: Optional[object] = None
    # convex hull proxy (geom type HULL): (HULL_MAX_VERTS, 3) local verts +
    # (HULL_MAX_DIRS, 3) candidate facet normals (building/cooking.py)
    hull: Optional[object] = None
    hull_dirs: Optional[object] = None


@dataclasses.dataclass
class FrameDef:
    """A named massless frame rigidly attached to a body (e.g. TCP)."""

    name: str
    body: int
    pos: np.ndarray
    quat: np.ndarray


def _arr(x, n=3, dtype=np.float64):
    if x is None:
        a = np.zeros(n, dtype)
        if n == 4:
            a[0] = 1.0
        return a
    return np.asarray(x, dtype)


class ModelBuilder:
    def __init__(
        self,
        timestep: float = 0.01,
        gravity=(0.0, 0.0, -9.81),
        solver_iterations: int = 32,
    ):
        self.timestep = timestep
        self.gravity = np.asarray(gravity, np.float64)
        self.solver_iterations = solver_iterations
        # body 0 = world
        self.bodies: List[BodyDef] = [
            BodyDef(
                name="world",
                parent=-1,
                jnt_type=FIXED,
                body_type=STATIC,
                pos=np.zeros(3),
                quat=np.array([1.0, 0, 0, 0]),
                jnt_axis=np.array([0.0, 0, 1]),
                inertia=np.zeros(3),
                ipos=np.zeros(3),
                iquat=np.array([1.0, 0, 0, 0]),
            )
        ]
        self.geoms: List[GeomDef] = []
        self.frames: List[FrameDef] = []
        # body-body 6-dof drives: (body1, pose1(7), body2, pose2(7),
        # stiffness(2), damping(2), force_limit(2))
        self.drives: List[tuple] = []
        self.exclude_body_pairs: Set[Tuple[int, int]] = set()
        self._name_to_body: Dict[str, int] = {"world": 0}
        # dof-less marker bodies (kinematic, no collision): poses live in
        # Data.mocap_pose instead of qpos (see types.Model.mocap_bodies)
        self.mocap_bodies: List[int] = []

    def add_drive(self, body1, pose1, body2, pose2,
                  stiffness=(1e3, 1e2), damping=(1e2, 1e1),
                  force_limit=(1e3, 1e3)) -> int:
        """Register a 6-dof spring-damper drive pulling a frame on body2
        toward a frame on body1 (reference scene.create_drive analog)."""
        self.drives.append((
            int(body1), np.asarray(pose1, np.float32).reshape(7),
            int(body2), np.asarray(pose2, np.float32).reshape(7),
            np.asarray(stiffness, np.float32).reshape(2),
            np.asarray(damping, np.float32).reshape(2),
            np.asarray(force_limit, np.float32).reshape(2),
        ))
        return len(self.drives) - 1

    # ------------------------------------------------------------------
    def add_body(
        self,
        name: str,
        parent: int = 0,
        jnt_type: int = FREE,
        body_type: int = DYNAMIC,
        pos=None,
        quat=None,
        jnt_axis=(0.0, 0.0, 1.0),
        mass: float = 1.0,
        inertia=None,
        ipos=None,
        iquat=None,
        limit=(-np.inf, np.inf),
        damping: float = 0.0,
        stiffness: float = 0.0,
        springref: float = 0.0,
        armature: float = 0.0,
        frictionloss: float = 0.0,
        joint_name: Optional[str] = None,
    ) -> int:
        if inertia is None:
            # default: solid sphere of radius 5cm
            i = 0.4 * mass * 0.05**2
            inertia = np.array([i, i, i])
        bd = BodyDef(
            name=name,
            parent=parent,
            jnt_type=jnt_type,
            body_type=body_type,
            pos=_arr(pos),
            quat=_arr(quat, 4),
            jnt_axis=np.asarray(jnt_axis, np.float64),
            mass=mass,
            inertia=np.asarray(inertia, np.float64),
            ipos=_arr(ipos),
            iquat=_arr(iquat, 4),
            limit=tuple(limit),
            damping=damping,
            stiffness=stiffness,
            springref=springref,
            armature=armature,
            frictionloss=frictionloss,
            joint_name=joint_name or name,
        )
        self.bodies.append(bd)
        idx = len(self.bodies) - 1
        if name in self._name_to_body:
            raise ValueError(f"duplicate body name {name!r}")
        self._name_to_body[name] = idx
        return idx

    def add_geom(
        self,
        body: int,
        type: int,
        size,
        pos=None,
        quat=None,
        friction: float = 0.5,
        restitution: float = 0.0,
        name: Optional[str] = None,
        contype: int = 1,
        conaffinity: int = 1,
        color=(0.5, 0.5, 0.5, 1.0),
        visual: bool = True,
        collision: bool = True,
        mesh=None,
        face_colors=None,
        hull=None,
        hull_dirs=None,
    ) -> int:
        size = np.asarray(size, np.float64)
        if size.shape == ():
            size = np.array([float(size), 0.0, 0.0])
        elif size.shape[0] < 3:
            size = np.concatenate([size, np.zeros(3 - size.shape[0])])
        g = GeomDef(
            name=name or f"geom_{len(self.geoms)}",
            body=body,
            type=type,
            size=size,
            pos=_arr(pos),
            quat=_arr(quat, 4),
            friction=friction,
            restitution=restitution,
            contype=contype,
            conaffinity=conaffinity,
            color=tuple(color),
            visual=visual,
            collision=collision,
            mesh=mesh,
            face_colors=(
                None if face_colors is None else np.asarray(face_colors, np.float32)
            ),
            hull=None if hull is None else np.asarray(hull, np.float32),
            hull_dirs=None if hull_dirs is None else np.asarray(hull_dirs, np.float32),
        )
        self.geoms.append(g)
        return len(self.geoms) - 1

    def add_frame(self, name: str, body: int, pos=None, quat=None) -> int:
        self.frames.append(FrameDef(name, body, _arr(pos), _arr(quat, 4)))
        return len(self.frames) - 1

    def exclude_collision(self, body1: int, body2: int):
        self.exclude_body_pairs.add((min(body1, body2), max(body1, body2)))

    def body_id(self, name: str) -> int:
        return self._name_to_body[name]

    # ------------------------------------------------------------------
    def finalize(self, device) -> Model:
        """Compile the bodies and geoms into a ``Model`` on ``device``."""
        nbody = len(self.bodies)
        q_adr = np.zeros(nbody, np.int32)
        dof_adr = np.zeros(nbody, np.int32)
        nq = nv = 0
        for i, b in enumerate(self.bodies):
            q_adr[i] = nq
            dof_adr[i] = nv
            nq += JOINT_NQ[b.jnt_type]
            nv += JOINT_NV[b.jnt_type]

        body_parent = np.array([b.parent for b in self.bodies], np.int32)
        body_jnt_type = np.array([b.jnt_type for b in self.bodies], np.int32)
        body_type = np.array([b.body_type for b in self.bodies], np.int32)

        # per-dof tables
        dof_body = np.zeros(nv, np.int32)
        dof_is_rot = np.zeros(nv, bool)
        dof_limited = np.zeros(nv, bool)
        dof_limit = np.zeros((nv, 2), np.float32)
        dof_limit[:, 0] = -np.inf
        dof_limit[:, 1] = np.inf
        dof_damping = np.zeros(nv, np.float32)
        dof_stiffness = np.zeros(nv, np.float32)
        dof_springref = np.zeros(nv, np.float32)
        dof_armature = np.zeros(nv, np.float32)
        dof_friction = np.zeros(nv, np.float32)
        for i, b in enumerate(self.bodies):
            va = dof_adr[i]
            if b.jnt_type == FREE:
                dof_body[va : va + 6] = i
                dof_is_rot[va + 3 : va + 6] = True
            elif b.jnt_type in (HINGE, SLIDE):
                dof_body[va] = i
                dof_is_rot[va] = b.jnt_type == HINGE
                lo, hi = b.limit
                if np.isfinite(lo) or np.isfinite(hi):
                    dof_limited[va] = True
                    dof_limit[va] = (lo, hi)
                dof_damping[va] = b.damping
                dof_stiffness[va] = b.stiffness
                dof_springref[va] = b.springref
                dof_armature[va] = b.armature
                dof_friction[va] = b.frictionloss

        # ancestor mask: dof d affects body b iff dof's body is on the chain
        # from world to b
        ancestor = np.zeros((nbody, nv), np.float32)
        for i in range(1, nbody):
            b = i
            while b > 0:
                bd = self.bodies[b]
                va = dof_adr[b]
                ancestor[i, va : va + JOINT_NV[bd.jnt_type]] = 1.0
                b = body_parent[b]

        pairs = self._candidate_pairs(body_parent, body_type, ancestor)
        total_candidates = sum(
            contacts_per_pair(int(self.geoms[a].type), int(self.geoms[b].type))
            for a, b in pairs
        )
        # top-K compaction: only the deepest ~1/4 of candidates (floor 32) can
        # be simultaneously active in practice; disabled for small scenes
        if total_candidates > 64:
            k = max(32, -(-total_candidates // 4 // 8) * 8)
            max_active = min(total_candidates, k)
        else:
            max_active = 0

        geoms = self.geoms
        # convex hull proxy tables (geom type HULL): geom -> hull id
        from ..building.cooking import HULL_MAX_DIRS, HULL_MAX_VERTS

        geom_hull = np.full(len(geoms), -1, np.int32)
        hv_list, hd_list = [], []
        for gi, g in enumerate(geoms):
            if g.type != HULL:
                continue
            assert g.hull is not None, f"HULL geom {g.name} missing hull verts"
            geom_hull[gi] = len(hv_list)
            hv = np.asarray(g.hull, np.float32)
            assert hv.shape == (HULL_MAX_VERTS, 3), hv.shape
            hv_list.append(hv)
            hd_list.append(
                np.asarray(g.hull_dirs, np.float32) if g.hull_dirs is not None
                else np.tile(np.array([[0, 0, 1.0]], np.float32), (HULL_MAX_DIRS, 1))
            )

        def stack(rows, width):
            return np.stack(rows) if rows else np.zeros((0, width))

        masses = np.asarray([b.mass for b in self.bodies], np.float32)
        fields = dict(
            nq=nq,
            nv=nv,
            nbody=nbody,
            ngeom=len(geoms),
            body_parent=body_parent,
            body_jnt_type=body_jnt_type,
            body_q_adr=q_adr,
            body_dof_adr=dof_adr,
            body_type=body_type,
            geom_body=np.array([g.body for g in geoms], np.int32),
            geom_type=np.array([g.type for g in geoms], np.int32),
            pair_geom1=np.array([p[0] for p in pairs], np.int32),
            pair_geom2=np.array([p[1] for p in pairs], np.int32),
            dof_body=dof_body,
            dof_is_rot=dof_is_rot,
            dof_limited=dof_limited,
            ancestor_mask=ancestor,
            body_pos=np.stack([b.pos for b in self.bodies]),
            body_quat=np.stack([b.quat / np.linalg.norm(b.quat) for b in self.bodies]),
            jnt_axis=np.stack(
                [b.jnt_axis / max(np.linalg.norm(b.jnt_axis), 1e-9) for b in self.bodies]
            ),
            body_ipos=np.stack([b.ipos for b in self.bodies]),
            body_iquat=np.stack([b.iquat / np.linalg.norm(b.iquat) for b in self.bodies]),
            body_mass=masses,
            body_gravcomp=np.zeros(nbody, np.float32),
            body_inertia=np.stack([np.maximum(b.inertia, 1e-9) for b in self.bodies]),
            dof_damping=dof_damping,
            dof_stiffness=dof_stiffness,
            dof_springref=dof_springref,
            dof_armature=dof_armature,
            dof_friction=dof_friction,
            dof_limit=dof_limit,
            host_dof_limit=dof_limit.copy(),
            host_body_mass=masses.copy(),
            host_body_gravcomp=np.zeros(nbody, np.float32),
            drive_kp=np.zeros(nv, np.float32),
            drive_kd=np.zeros(nv, np.float32),
            drive_force_limit=np.full((nv,), np.inf, np.float32),
            geom_pos=stack([g.pos for g in geoms], 3),
            geom_quat=stack([g.quat / np.linalg.norm(g.quat) for g in geoms], 4),
            geom_size=stack([g.size for g in geoms], 3),
            geom_friction=np.asarray([g.friction for g in geoms], np.float32),
            geom_restitution=np.asarray([g.restitution for g in geoms], np.float32),
            gravity=self.gravity,
            **self._drive_tables(),
            geom_hull=geom_hull,
            hull_verts=np.stack(hv_list) if hv_list else None,
            hull_dirs=np.stack(hd_list) if hd_list else None,
            timestep=self.timestep,
            solver_iterations=self.solver_iterations,
            max_active_contacts=max_active,
            mocap_bodies=(
                np.asarray(self.mocap_bodies, np.int32) if self.mocap_bodies else None
            ),
            body_names=tuple(b.name for b in self.bodies),
            geom_names=tuple(g.name for g in geoms),
        )
        return model_from_numpy(fields, device)

    def _drive_tables(self) -> dict:
        """The Model's drive6_* fields (none without a drive)."""
        if not self.drives:
            return {}
        cols = list(zip(*self.drives))
        names = ("drive6_body1", "drive6_pose1", "drive6_body2", "drive6_pose2",
                 "drive6_stiffness", "drive6_damping", "drive6_force_limit")
        return {n: np.asarray(c, np.int32) if n.startswith("drive6_body") else np.stack(c)
                for n, c in zip(names, cols)}

    def _candidate_pairs(self, body_parent, body_type, ancestor) -> List[Tuple[int, int]]:
        """Static broadphase: all geom pairs that could ever collide."""
        pairs = []
        geoms = self.geoms
        types = [g.type for g in geoms]
        has_dofs = ancestor.sum(axis=1) > 0  # body can move at all
        for i in range(len(geoms)):
            for j in range(i + 1, len(geoms)):
                gi, gj = geoms[i], geoms[j]
                if not (gi.collision and gj.collision):
                    continue
                bi, bj = gi.body, gj.body
                if bi == bj:
                    continue
                # neither responds: skip
                if body_type[bi] != DYNAMIC and body_type[bj] != DYNAMIC:
                    continue
                # neither body's chain has any dof (e.g. fixed robot base vs
                # static table): no response possible
                dyn_i = body_type[bi] == DYNAMIC and has_dofs[bi]
                dyn_j = body_type[bj] == DYNAMIC and has_dofs[bj]
                if not (dyn_i or dyn_j):
                    continue
                # parent-child adjacency (PhysX articulation default);
                # FREE-jointed children still collide with their "parent"
                # (the world) — the filter is for articulation joints only
                jt_i = self.bodies[bi].jnt_type
                jt_j = self.bodies[bj].jnt_type
                if body_parent[bi] == bj and jt_i != FREE:
                    continue
                if body_parent[bj] == bi and jt_j != FREE:
                    continue
                if (min(bi, bj), max(bi, bj)) in self.exclude_body_pairs:
                    continue
                # collision group mask (MuJoCo contype/conaffinity scheme)
                if not (
                    (gi.contype & gj.conaffinity) or (gj.contype & gi.conaffinity)
                ):
                    continue
                a, b = (i, j) if types[i] <= types[j] else (j, i)
                # plane-plane never collides
                if types[a] == PLANE and types[b] == PLANE:
                    continue
                # unsupported narrowphase combos are dropped (cylinder vs
                # non-plane approximated as capsule by callers if needed)
                if contacts_per_pair(types[a], types[b]) == 0:
                    continue
                pairs.append((a, b))
        return pairs
