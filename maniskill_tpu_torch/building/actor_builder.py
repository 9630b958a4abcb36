"""ActorBuilder: fluent construction of free/kinematic/static actors
(counterpart of maniskill_tpu/building/actor_builder.py).

One call to ``build*`` creates ONE body in the shared kinematic forest; the
env axis is a batch dim, so nothing is replicated. Primitive shapes, convex
hull proxies cooked from meshes (building/cooking.py), and mesh and
textured visuals.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..physics.types import (
    BOX,
    CAPSULE,
    CYLINDER,
    DYNAMIC,
    FIXED,
    FREE,
    HULL,
    KINEMATIC,
    MESH,
    PLANE,
    SPHERE,
    STATIC,
)
from ..structs.actor import Actor
from ..structs.pose import Pose
from .inertia import combine_shapes


def _pose7(pose) -> np.ndarray:
    if pose is None:
        return np.array([0, 0, 0, 1, 0, 0, 0], np.float64)
    if isinstance(pose, Pose):
        raw = np.asarray(pose.raw_pose, np.float64)
        if raw.ndim > 1:
            raw = raw[0]
        return raw
    raw = np.asarray(pose, np.float64)
    if raw.shape == (3,):  # position-only shorthand
        return np.concatenate([raw, [1, 0, 0, 0]])
    return raw


class ActorBuilder:
    def __init__(self, scene):
        self.scene = scene
        self.collisions: List[dict] = []
        self.visuals: List[dict] = []
        self.initial_pose = np.array([0, 0, 0, 1, 0, 0, 0], np.float64)
        self._mass_override: Optional[float] = None
        self.collision_groups: Tuple[int, int] = (1, 1)  # contype, conaffinity

    # -- shape adders ---------------------------------------------------
    def _add(self, kind, gtype, size, pose, density, friction, color,
             restitution=None):
        rec = dict(
            type=gtype,
            size=np.asarray(size, np.float64),
            pose=_pose7(pose),
            density=density,
            friction=friction,
            color=color,
            restitution=restitution,  # None -> scene default material
        )
        (self.collisions if kind == "c" else self.visuals).append(rec)
        return self

    def add_box_collision(self, pose=None, half_size=(0.1, 0.1, 0.1), density=1000.0, friction=0.3, restitution=None):
        return self._add("c", BOX, half_size, pose, density, friction, None, restitution)

    def add_sphere_collision(self, pose=None, radius=0.1, density=1000.0, friction=0.3, restitution=None):
        return self._add("c", SPHERE, [radius, 0, 0], pose, density, friction, None, restitution)

    def add_capsule_collision(self, pose=None, radius=0.1, half_length=0.1, density=1000.0, friction=0.3, restitution=None):
        return self._add("c", CAPSULE, [radius, half_length, 0], pose, density, friction, None, restitution)

    def add_cylinder_collision(self, pose=None, radius=0.1, half_length=0.1, density=1000.0, friction=0.3, restitution=None):
        return self._add("c", CYLINDER, [radius, half_length, 0], pose, density, friction, None, restitution)

    def add_plane_collision(self, pose=None, friction=0.3, restitution=None):
        return self._add("c", PLANE, [0, 0, 0], pose, 0.0, friction, None, restitution)

    # -- mesh shapes: convex hull proxies ------------------------------------
    def _add_hull(self, hull, pose, density, friction, color):
        from .cooking import hull_face_dirs

        self.collisions.append(dict(
            type=HULL,
            size=np.abs(hull).max(axis=0).astype(np.float64),
            pose=_pose7(pose),
            density=density,
            friction=friction,
            color=color,
            hull=hull,
            hull_dirs=hull_face_dirs(hull),
        ))

    def add_convex_collision_from_mesh(self, verts, faces=None, pose=None, density=1000.0, friction=0.3,
                                       color=None):
        """One convex hull proxy covering the whole mesh or point cloud; with
        a ``color`` it is drawn as well."""
        from .cooking import hull_proxy

        self._add_hull(hull_proxy(np.asarray(verts, np.float32).reshape(-1, 3)), pose, density, friction, color)
        return self

    def add_multiple_convex_collisions_from_mesh(self, verts, faces, pose=None, density=1000.0, friction=0.3,
                                                 max_parts: int = 8, color=None):
        """An approximate convex decomposition: up to ``max_parts`` hull
        proxies."""
        from .cooking import decompose_mesh

        for hull in decompose_mesh(verts, faces, max_parts=max_parts):
            self._add_hull(hull, pose, density, friction, color)
        return self

    def add_box_visual(self, pose=None, half_size=(0.1, 0.1, 0.1), material=None, color=None):
        return self._add("v", BOX, half_size, pose, 0.0, 0.0, _color(material, color))

    def add_sphere_visual(self, pose=None, radius=0.1, material=None, color=None):
        return self._add("v", SPHERE, [radius, 0, 0], pose, 0.0, 0.0, _color(material, color))

    def add_capsule_visual(self, pose=None, radius=0.1, half_length=0.1, material=None, color=None):
        return self._add("v", CAPSULE, [radius, half_length, 0], pose, 0.0, 0.0, _color(material, color))

    def add_cylinder_visual(self, pose=None, radius=0.1, half_length=0.1, material=None, color=None):
        return self._add("v", CYLINDER, [radius, half_length, 0], pose, 0.0, 0.0, _color(material, color))

    def add_plane_visual(self, pose=None, scale=(1, 1, 1), material=None, color=None):
        return self._add("v", PLANE, scale, pose, 0.0, 0.0, _color(material, color))

    def add_visual_from_mesh(self, verts, faces, pose=None, color=None,
                             material=None, face_colors=None):
        """A triangle-mesh visual; ``face_colors`` (F, 3) carries baked
        texture colours (render/textures.py)."""
        self._add("v", MESH, np.ones(3), pose, 0.0, 0.0, _color(material, color))
        self.visuals[-1].update(
            mesh=(np.asarray(verts, np.float32), np.asarray(faces, np.int32)),
            face_colors=None if face_colors is None else np.asarray(face_colors, np.float32),
        )
        return self

    def add_textured_visual(self, image, half_x, half_y, pose=None, res=12,
                            uv_tiles: float = 1.0):
        """Textured z-up quad (table tops, floors): a tessellated grid with
        per-face colours baked from ``image``."""
        from ..render.textures import textured_quad_grid

        v, f, fc = textured_quad_grid(half_x, half_y, image, res=res, uv_tiles=uv_tiles)
        return self.add_visual_from_mesh(v, f, pose=pose, face_colors=fc)

    def set_initial_pose(self, pose):
        self.initial_pose = _pose7(pose)
        return self

    def set_mass(self, mass: float):
        self._mass_override = mass
        return self

    def set_collision_groups(self, contype: int, conaffinity: int):
        self.collision_groups = (contype, conaffinity)
        return self

    # -- build ----------------------------------------------------------
    def build(self, name: str) -> Actor:
        return self._build(name, DYNAMIC)

    def build_dynamic(self, name: str) -> Actor:
        return self._build(name, DYNAMIC)

    def build_kinematic(self, name: str) -> Actor:
        return self._build(name, KINEMATIC)

    def build_static(self, name: str) -> Actor:
        return self._build(name, STATIC)

    def _build(self, name: str, body_type: int) -> Actor:
        mb = self.scene.mb
        if body_type == STATIC:
            body = 0
        elif body_type == KINEMATIC and not self.collisions:
            # kinematic marker with no collision geometry (goal sites etc.):
            # build it dof-less (FIXED to world) — its per-env pose lives in
            # Data.mocap_pose, so it costs nothing in the dynamics spine
            body = mb.add_body(
                name,
                jnt_type=FIXED,
                body_type=KINEMATIC,
                pos=self.initial_pose[:3],
                quat=self.initial_pose[3:],
                mass=1e-3,
                inertia=np.full(3, 1e-7),
            )
            mb.mocap_bodies.append(body)
        else:
            shapes = [
                # a hull proxy's inertia is its AABB box's
                (BOX if c["type"] == HULL else c["type"],
                 c["size"], c["pose"][:3], c["pose"][3:], c["density"])
                for c in self.collisions
                if c["type"] != PLANE
            ]
            if self._mass_override is not None and shapes:
                mass, com, inertia, iquat = combine_shapes(shapes)
                scale = self._mass_override / max(mass, 1e-9)
                mass, inertia = self._mass_override, inertia * scale
            elif shapes:
                mass, com, inertia, iquat = combine_shapes(shapes)
            else:
                mass, com, inertia, iquat = 1e-3, np.zeros(3), np.full(3, 1e-7), np.array([1.0, 0, 0, 0])
            body = mb.add_body(
                name,
                jnt_type=FREE,
                body_type=body_type,
                mass=float(mass),
                ipos=com,
                iquat=iquat,
                inertia=inertia,
            )
        contype, conaffinity = self.collision_groups
        for c in self.collisions:
            gpose = c["pose"].copy()
            if body_type == STATIC:
                # bake the actor pose into the world-attached geom offset
                gpose = np.asarray(
                    (Pose(self.initial_pose) * Pose(gpose)).raw_pose, np.float64
                )
            mb.add_geom(
                body,
                c["type"],
                c["size"],
                pos=gpose[:3],
                quat=gpose[3:],
                friction=c["friction"],
                restitution=(
                    c.get("restitution")
                    if c.get("restitution") is not None
                    else getattr(self.scene, "default_restitution", 0.0)
                ),
                contype=contype,
                conaffinity=conaffinity,
                name=f"{name}_col_{len(mb.geoms)}",
                # hull colliders given a colour are drawn too (mesh objects
                # with no separate visual geometry, e.g. YCB)
                visual=c.get("color") is not None,
                color=c.get("color") or (0.5, 0.5, 0.5, 1.0),
                hull=c.get("hull"),
                hull_dirs=c.get("hull_dirs"),
            )
        for v in self.visuals:
            gpose = v["pose"].copy()
            if body_type == STATIC:
                gpose = np.asarray(
                    (Pose(self.initial_pose) * Pose(gpose)).raw_pose, np.float64
                )
            mb.add_geom(
                body,
                v["type"],
                v["size"],
                pos=gpose[:3],
                quat=gpose[3:],
                collision=False,
                contype=0,
                conaffinity=0,
                color=v["color"] or (0.5, 0.5, 0.5, 1.0),
                name=f"{name}_vis_{len(mb.geoms)}",
                mesh=v.get("mesh"),
                face_colors=v.get("face_colors"),
            )
        actor = Actor(
            self.scene,
            name,
            body_id=body,
            body_type=body_type,
            initial_pose=self.initial_pose.astype(np.float32),
        )
        self.scene.register_actor(actor)
        return actor


def _color(material, color):
    if color is not None:
        c = tuple(np.asarray(color, np.float64).tolist())
        return c if len(c) == 4 else c + (1.0,)
    if material is not None:
        if isinstance(material, (tuple, list, np.ndarray)):
            c = tuple(np.asarray(material, np.float64).tolist())
            return c if len(c) == 4 else c + (1.0,)
        base = getattr(material, "base_color", None)
        if base is not None:
            return tuple(base)
    return (0.5, 0.5, 0.5, 1.0)
