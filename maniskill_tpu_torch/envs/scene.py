"""``ManiSkillScene``: build-time scene construction + runtime state views
(counterpart of maniskill_tpu/envs/scene.py).

A scene is one physics ``Model`` (kinematic forest shared by all envs) plus
the current batched ``Data`` on the scene's ``device``. Struct setters write
``scene.data`` through ``write_cols``, masked by the partial-reset mask.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..physics import ModelBuilder
from ..physics.plan import model_plan
from ..physics.types import HULL, STATIC, Model
from ..structs.actor import Actor
from ..structs.articulation import Articulation
from ..structs.link import Link


class ManiSkillScene:
    def __init__(
        self,
        num_envs: int = 1,
        sim_timestep: float = 0.01,
        solver_iterations: int = 16,
        gravity=(0.0, 0.0, -9.81),
        device="cuda",
    ):
        self.num_envs = num_envs
        self.device = torch.device(device)
        self.mb = ModelBuilder(
            timestep=sim_timestep, gravity=gravity, solver_iterations=solver_iterations
        )
        self.actors: Dict[str, Actor] = {}
        self.articulations: Dict[str, Articulation] = {}
        self.sensors: Dict[str, object] = {}
        self.human_render_cameras: Dict[str, object] = {}
        self.lights: List[dict] = []
        self.model: Optional[Model] = None
        self.data = None
        self._reset_mask: Optional[torch.Tensor] = None
        self._next_seg_id = 1

    # -- build phase -----------------------------------------------------
    def create_actor_builder(self):
        from ..building.actor_builder import ActorBuilder

        return ActorBuilder(self)

    def create_articulation_builder(self):
        from ..building.articulation_builder import ArticulationBuilder

        return ArticulationBuilder(self)

    def create_urdf_loader(self):
        from ..building.urdf_loader import URDFLoader

        return URDFLoader(self)

    def create_mjcf_loader(self):
        from ..building.mjcf_loader import MJCFLoader

        return MJCFLoader(self)

    def create_drive(self, entity1, pose1, entity2, pose2, stiffness=(1e3, 1e2), damping=(1e2, 1e1),
                     force_limit=(1e3, 1e3)):
        """A body-body 6-dof drive between two actors or links, built before
        ``finalize``; ``entity1=None`` anchors it to the world. A pose is
        None (identity), a position (3,) or a pose (7,) in its body's frame."""
        from ..building.actor_builder import _pose7
        from ..structs.drive import Drive

        b1 = 0 if entity1 is None else entity1.body_id
        b2 = entity2.body_id
        did = self.mb.add_drive(b1, _pose7(pose1), b2, _pose7(pose2), stiffness=stiffness, damping=damping,
                                force_limit=force_limit)
        return Drive(self, did, b1, b2)

    def register_actor(self, actor: Actor):
        if actor.name in self.actors:
            raise ValueError(f"duplicate actor name {actor.name!r}")
        actor.per_scene_id = self._next_seg_id
        self._next_seg_id += 1
        self.actors[actor.name] = actor
        return actor

    def register_articulation(self, art: Articulation):
        if art.name in self.articulations:
            raise ValueError(f"duplicate articulation name {art.name!r}")
        for link in art.links:
            link.per_scene_id = self._next_seg_id
            self._next_seg_id += 1
        self.articulations[art.name] = art
        return art

    def add_light(self, kind: str, **kwargs):
        self.lights.append(dict(kind=kind, **kwargs))

    def set_ambient_light(self, color):
        self.add_light("ambient", color=np.asarray(color, np.float32))

    def add_directional_light(self, direction, color=(1, 1, 1), **kw):
        self.add_light(
            "directional",
            direction=np.asarray(direction, np.float32),
            color=np.asarray(color, np.float32),
        )

    def add_point_light(self, position, color=(1, 1, 1), **kw):
        """Recorded only: neither renderer reads point lights."""
        self.add_light(
            "point",
            position=np.asarray(position, np.float32),
            color=np.asarray(color, np.float32),
        )

    def finalize(self):
        """Compile builders to the flat Model and wire view indices."""
        self.model = self.mb.finalize(self.device)
        # host mirror of build-time geometry (render meshes never read the
        # device arrays)
        geoms = self.mb.geoms
        self.host_geom_size = (
            np.stack([np.asarray(g.size, np.float32) for g in geoms])
            if geoms else np.zeros((0, 3), np.float32)
        )
        hulls = [np.asarray(g.hull, np.float32) for g in geoms if g.type == HULL]
        # (NH, V, 3), or (B, NH, V, 3) once set per env
        self.host_hull_verts = np.stack(hulls) if hulls else None
        mocap_of = (
            {int(b): i for i, b in enumerate(self.model.mocap_bodies)}
            if self.model.mocap_bodies is not None else {}
        )
        for actor in self.actors.values():
            if actor.body_type != STATIC:
                if actor.body_id in mocap_of:
                    actor._mocap_idx = mocap_of[actor.body_id]
                else:
                    actor._q_adr = int(self.model.body_q_adr[actor.body_id])
                    actor._dof_adr = int(self.model.body_dof_adr[actor.body_id])
        for art in self.articulations.values():
            for j in art.joints:
                j.q_adr = int(self.model.body_q_adr[j.body_id])
                j.dof_adr = int(self.model.body_dof_adr[j.body_id])
            if not art.fixed_root:
                art.root_q_adr = int(self.model.body_q_adr[art.root.body_id])
                art.root_dof_adr = int(self.model.body_dof_adr[art.root.body_id])
            art._finalize_indices()
        return self.model

    # -- runtime ---------------------------------------------------------
    def bind(self, data):
        self.data = data
        return self

    def render_seed(self) -> torch.Tensor:
        """The seed of the ray-traced packs' draws, from the bits of
        ``qpos[:, 0]`` on the device, so each physics state gets fresh draws
        and a render stays a pure function of the sim state."""
        from ..render.pathtracer import render_seed

        return render_seed(self.data.qpos)

    def masked(self, new: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
        """Apply the partial-reset mask to a pending write."""
        if self._reset_mask is None:
            return new
        m = self._reset_mask.reshape(self._reset_mask.shape + (1,) * (new.ndim - 1))
        return torch.where(m, new, cur)

    def to_batch(self, value, width: int) -> torch.Tensor:
        """A per-env or shared value as a (num_envs, width) f32 tensor on the
        scene's device."""
        if not isinstance(value, torch.Tensor):
            value = np.asarray(value, np.float32)
        v = torch.as_tensor(value, dtype=torch.float32, device=self.device)
        return v.expand(self.num_envs, width)

    def write_cols(self, cur: torch.Tensor, cols, value: torch.Tensor) -> torch.Tensor:
        """``cur`` with columns ``cols`` replaced by ``value`` where the reset
        mask allows (a new tensor; ``cur`` is left as it was)."""
        out = cur.clone()
        out[:, cols] = self.masked(value, cur[:, cols])
        return out

    def set_drive_properties(self, dof_adrs, stiffness, damping, force_limit=np.inf):
        """Update PD gains in the model (controllers call this at setup)."""
        adr = torch.as_tensor(np.asarray(dof_adrs, np.int64), device=self.device)
        m = self.model

        def put(t, v):
            t = t.clone()
            t[adr] = torch.as_tensor(np.array(v, np.float32), device=self.device)
            return t

        self.model = m.replace(
            drive_kp=put(m.drive_kp, stiffness),
            drive_kd=put(m.drive_kd, damping),
            drive_force_limit=put(m.drive_force_limit, force_limit),
        )

    # -- heterogeneous per-env parameters --------------------------------
    # A parameter table gains a leading env axis (B, ...) and the actor's
    # rows are written per env; the step broadcasts either shape.
    def _per_env(self, table: torch.Tensor, shared_ndim: int) -> torch.Tensor:
        """``table`` with a leading env axis (a new tensor either way)."""
        if table.ndim == shared_ndim:
            return table.expand((self.num_envs,) + tuple(table.shape)).clone()
        return table.clone()

    def set_per_env_geom_sizes(self, actor, sizes):
        """sizes: (B, n_geoms_of_actor, 3) host array, or (B, 3) for a
        single-geom actor (one size for all of its geoms)."""
        return self.set_per_env_geom_sizes_by_id(actor.geom_ids, sizes)

    def set_per_env_geom_sizes_by_id(self, geom_ids, sizes):
        """sizes: (B, K, 3) host array (or (B, 3) for K == 1), the primitive
        sizes of geoms ``geom_ids`` (K,) in each env. The render mirror
        follows, so a visual geom written here is drawn at its per-env size;
        a collision geom changes only the physics."""
        gids = np.asarray(geom_ids, np.int64)
        sizes_np = np.asarray(sizes, np.float32)
        if sizes_np.ndim == 2:
            sizes_np = sizes_np[:, None, :]
        gs = self._per_env(self.model.geom_size, 2)
        gs[:, gids] = torch.as_tensor(sizes_np, device=self.device)
        self.model = self.model.replace(geom_size=gs)
        hs = self.host_geom_size
        if hs.ndim == 2:
            hs = np.broadcast_to(hs, (self.num_envs,) + hs.shape).copy()
        hs[:, gids] = sizes_np
        self.host_geom_size = hs

    def set_per_env_geom_pos(self, geom_ids, pos):
        """pos: (B, K, 3) host array, the offsets of geoms ``geom_ids`` (K,)
        in their body's frame in each env. ``geom_poses`` reads the table
        from the model on each call."""
        gids = np.asarray(geom_ids, np.int64)
        gp = self._per_env(self.model.geom_pos, 2)
        gp[:, gids] = torch.as_tensor(np.asarray(pos, np.float32), device=self.device)
        self.model = self.model.replace(geom_pos=gp)

    def set_per_env_body_pos(self, body_ids, pos):
        """pos: (B, K, 3) host array, the joint-frame origins of bodies
        ``body_ids`` (K,) in their parent's frame in each env (a drawer's
        height or a hinge's place differs per env)."""
        bids = np.asarray(body_ids, np.int64)
        bp = self._per_env(self.model.body_pos, 2)
        bp[:, bids] = torch.as_tensor(np.asarray(pos, np.float32), device=self.device)
        self.model = self.model.replace(body_pos=bp)

    def set_per_env_dof_limits(self, dof_adrs, limits):
        """limits: (B, K, 2) host array, the lower and upper limits of dofs
        ``dof_adrs`` (K,) in each env. A dof locked to [0, 0] is how an env
        lacks a part of a union template under one static shape. The dofs
        must have been limited at build time (the device plan holds only the
        limited dofs' indices, never their values); ``host_dof_limit`` keeps
        the build-time limits."""
        adrs = np.asarray(dof_adrs, np.int64)
        assert bool(np.asarray(self.model.dof_limited)[adrs].all()), (
            "per-env limits require dofs marked limited at build time")
        dl = self._per_env(self.model.dof_limit, 2)
        dl[:, adrs] = torch.as_tensor(np.asarray(limits, np.float32), device=self.device)
        self.model = self.model.replace(dof_limit=dl)

    def set_per_env_hulls(self, actor, hulls, dirs=None):
        """Per-env convex hull geometry of one actor (a different object in
        each env).

        hulls: (B, K, HULL_MAX_VERTS, 3) host array, the local vertex clouds
        of the actor's K HULL geoms; dirs: optional (B, K, HULL_MAX_DIRS, 3)
        facet normals. Without ``dirs`` the normals are computed once per
        distinct hull and gathered per env (``hull_face_dirs`` is
        deterministic, so this equals computing them env by env).
        """
        from ..building.cooking import hull_face_dirs

        geom_hull = np.asarray(self.model.geom_hull)
        hids = geom_hull[[g for g in actor.geom_ids if geom_hull[g] >= 0]]
        hulls_np = np.asarray(hulls, np.float32)
        if len(hids) != hulls_np.shape[1] and len(hids) % hulls_np.shape[1] == 0:
            # the actor lists its hulls twice (collision geoms and HULL visual
            # geoms from the same specs, in order): the visuals follow
            reps = len(hids) // hulls_np.shape[1]
            hulls_np = np.tile(hulls_np, (1, reps, 1, 1))
            if dirs is not None:
                dirs = np.tile(np.asarray(dirs, np.float32), (1, reps, 1, 1))
        assert hulls_np.shape[1] == len(hids), (hulls_np.shape, len(hids))
        if self.host_hull_verts is not None:
            hv = self.host_hull_verts
            if hv.ndim == 3:
                hv = np.broadcast_to(hv, (self.num_envs,) + hv.shape).copy()
            hv[:, hids] = hulls_np
            self.host_hull_verts = hv
        if dirs is None:
            # distinct hulls keyed by their bytes (bit-identical inputs only)
            first, inverse = {}, []
            for h in hulls_np.reshape((-1,) + hulls_np.shape[2:]):
                inverse.append(first.setdefault(h.tobytes(), len(first)))
            uniq = np.frombuffer(b"".join(first), np.float32).reshape((-1,) + hulls_np.shape[2:])
            uniq_dirs = np.stack([hull_face_dirs(h) for h in uniq])
            dirs = uniq_dirs[np.asarray(inverse)].reshape(hulls_np.shape[:2] + uniq_dirs.shape[1:])
        hv_t = self._per_env(self.model.hull_verts, 3)
        hd_t = self._per_env(self.model.hull_dirs, 3)
        hids_t = torch.as_tensor(hids.astype(np.int64), device=self.device)
        hv_t[:, hids_t] = torch.as_tensor(hulls_np, device=self.device)
        hd_t[:, hids_t] = torch.as_tensor(dirs, dtype=torch.float32, device=self.device)
        self.model = self.model.replace(hull_verts=hv_t, hull_dirs=hd_t)

    def set_per_env_friction(self, actor, friction):
        """friction: (B,) host array, one value for all of the actor's geoms
        in each env, or (B, K) for its K geoms."""
        gids = torch.as_tensor(np.asarray(actor.geom_ids, np.int64), device=self.device)
        f = torch.as_tensor(np.asarray(friction, np.float32), device=self.device)
        if f.ndim == 1:
            f = f[:, None].expand(self.num_envs, len(gids))
        gf = self._per_env(self.model.geom_friction, 1)
        gf[:, gids] = f
        self.model = self.model.replace(geom_friction=gf)

    def set_per_env_body_mass(self, actor, mass):
        """mass: (B,) host array, one body's mass in each env."""
        bm = self._per_env(self.model.body_mass, 1)
        bm[:, actor.body_id] = torch.as_tensor(np.asarray(mass, np.float32), device=self.device)
        self.model = self.model.replace(body_mass=bm)

    # -- task extras: persistent per-env state ---------------------------
    def register_extra(self, name: str, shape=(), dtype=torch.float32):
        """Declare a persistent per-env task variable (zero at the start,
        cleared on reset, part of the sim state)."""
        if not hasattr(self, "extra_specs"):
            self.extra_specs = {}
        self.extra_specs[name] = (tuple(shape), dtype)

    def get_extra(self, name: str) -> torch.Tensor:
        return self.data.extras[name]

    def set_extra(self, name: str, value, masked: bool = True):
        """Write an extra, where the reset mask allows unless ``masked`` is
        False."""
        cur = self.data.extras[name]
        value = torch.as_tensor(value, device=self.device).to(cur.dtype).expand(cur.shape)
        extras = dict(self.data.extras)
        extras[name] = self.masked(value, cur) if masked else value
        self.data = self.data.replace(extras=extras)

    # -- contact queries -------------------------------------------------
    def _body_ids_of(self, obj) -> List[int]:
        if isinstance(obj, (Actor, Link)):
            return [obj.body_id]
        if isinstance(obj, Articulation):
            return [link.body_id for link in obj.links]
        raise TypeError(type(obj))

    def _contact_sign(self, key, sign_fn) -> Optional[torch.Tensor]:
        """(C,) per-candidate sign of a force query, kept in the model's
        device plan; None if no candidate contributes."""
        return model_plan(self.model).force_sign(key, self.data.contact, sign_fn)

    def _signed_force(self, sign: Optional[torch.Tensor]) -> torch.Tensor:
        if sign is None:
            return torch.zeros(self.num_envs, 3, device=self.device)
        imp = self.data.contact.impulse * sign[None, :, None]
        return torch.sum(imp, 1) / self.model.timestep

    def net_contact_forces_for_bodies(self, body_ids: Sequence[int]) -> torch.Tensor:
        """(B, 3) net contact force on the given bodies."""
        c = self.data.contact
        if c is None or len(c.geom1) == 0:
            return torch.zeros(self.num_envs, 3, device=self.device)
        ids = frozenset(int(i) for i in body_ids)

        def sign_fn(b1, b2):
            return (np.isin(b2, list(ids)).astype(np.float32)
                    - np.isin(b1, list(ids)).astype(np.float32))

        return self._signed_force(self._contact_sign(("net", ids), sign_fn))

    def net_contact_forces_per_body(self, body_ids: Sequence[int]) -> torch.Tensor:
        """(B, L, 3) net contact force on each of the L bodies: one (L, C)
        sign matrix, kept in the device plan, and one product per call."""
        c = self.data.contact
        zeros = torch.zeros(self.num_envs, len(body_ids), 3, device=self.device)
        if c is None or len(c.geom1) == 0:
            return zeros
        ids = tuple(int(i) for i in body_ids)

        def sign_fn(b1, b2):
            col = np.asarray(ids)[:, None]
            return ((b2[None, :] == col).astype(np.float32) - (b1[None, :] == col).astype(np.float32))

        sign = self._contact_sign(("net_each", ids), sign_fn)
        if sign is None:
            return zeros
        imp = c.impulse[:, None] * sign[None, :, :, None]  # (B, L, C, 3)
        return torch.sum(imp, 2) / self.model.timestep

    def get_pairwise_contact_forces(self, obj1, obj2) -> torch.Tensor:
        """Force exerted by obj1 on obj2, (B, 3)."""
        c = self.data.contact
        if c is None or len(c.geom1) == 0:
            return torch.zeros(self.num_envs, 3, device=self.device)
        a = frozenset(self._body_ids_of(obj1))
        b = frozenset(self._body_ids_of(obj2))

        def sign_fn(b1, b2):
            in_a1, in_b1 = np.isin(b1, list(a)), np.isin(b1, list(b))
            in_a2, in_b2 = np.isin(b2, list(a)), np.isin(b2, list(b))
            # the impulse acts on body2 (obj2); the reverse order is the reaction
            return np.where(in_a1 & in_b2, 1.0, np.where(in_b1 & in_a2, -1.0, 0.0)).astype(np.float32)

        return self._signed_force(self._contact_sign(("pair", a, b), sign_fn))

    # -- sim state registry ----------------------------------------------
    def get_sim_state(self) -> Dict:
        state = dict(actors={}, articulations={})
        for name, actor in self.actors.items():
            if not actor.is_static:
                state["actors"][name] = actor.get_state()
        for name, art in self.articulations.items():
            state["articulations"][name] = art.get_state()
        if self.data.extras:
            state["extras"] = dict(self.data.extras)
        return state

    def set_sim_state(self, state: Dict):
        for name, s in state.get("actors", {}).items():
            self.actors[name].set_state(s)
        for name, s in state.get("articulations", {}).items():
            self.articulations[name].set_state(s)
        for name, v in state.get("extras", {}).items():
            self.set_extra(name, v)
