"""MJCF (MuJoCo XML) loader (counterpart of maniskill_tpu/building/mjcf_loader.py).

Parsed with the standard library's ``xml.etree.ElementTree`` (the JAX
package parses with lxml). It keeps the JAX loader's scope and semantics:
worldbody trees of nested bodies; box, sphere, capsule, cylinder and plane
geoms, ``fromto`` capsules and cylinders included; hinge, slide and free
joints (a body with several joints becomes a chain of massless bodies, the
last joint on the real one); default-class attribute inheritance;
inertial blocks; worldbody geoms as one static actor; contype/conaffinity
and geom-group collision/visual filtering; and ``<contact><exclude>`` body
pairs. Tendons, sensors and actuators are not read.
"""
from __future__ import annotations

import logging
import math
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from ..physics.types import BOX, CAPSULE, CYLINDER, FIXED, FREE, HINGE, PLANE, SLIDE, SPHERE
from .articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec

logger = logging.getLogger(__name__)

_GEOM_TYPES = {"box": BOX, "sphere": SPHERE, "capsule": CAPSULE, "cylinder": CYLINDER, "plane": PLANE}

# MuJoCo's convention: geom groups 0 and 2 are drawn, group 3 holds
# collision-only meshes
_VISUAL_GROUPS = (0, 2)


def _f(s, default=None):
    if s is None:
        return default
    return np.array([float(x) for x in s.split()])


def _z_to(z: np.ndarray) -> np.ndarray:
    """The quaternion turning +z onto the unit vector ``z``."""
    q = np.array([1.0 + z[2], *np.cross([0, 0, 1.0], z)])
    n = np.linalg.norm(q)
    return q / n if n > 1e-9 else np.array([0.0, 1.0, 0, 0])


def _quat_attr(attrs) -> np.ndarray:
    """An MJCF orientation (``quat`` wxyz, ``euler``, or ``zaxis``) of an
    element or an attribute dict."""
    q = _f(attrs.get("quat"))
    if q is not None:
        return q / np.linalg.norm(q)
    e = _f(attrs.get("euler"))
    if e is not None:
        # MuJoCo's default eulerseq: xyz, extrinsic
        r, p, y = e
        cr, sr = math.cos(r / 2), math.sin(r / 2)
        cp, sp = math.cos(p / 2), math.sin(p / 2)
        cy, sy = math.cos(y / 2), math.sin(y / 2)
        return np.array([
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ])
    za = _f(attrs.get("zaxis"))
    if za is not None:
        return _z_to(za / np.linalg.norm(za))
    return np.array([1.0, 0, 0, 0])


class _Defaults:
    """MJCF default-class attribute resolution."""

    def __init__(self):
        self.classes: Dict[str, Dict[str, Dict[str, str]]] = {"main": {}}
        self.parent: Dict[str, str] = {}

    def parse(self, root):
        main = root.find("default")
        if main is not None:
            self._walk(main, "main")

    def _walk(self, el, name):
        self.classes.setdefault(name, {})
        for child in el:
            if child.tag == "default":
                sub = child.get("class", f"anon{len(self.classes)}")
                self.parent[sub] = name
                self._walk(child, sub)
            else:
                self.classes[name].setdefault(child.tag, {}).update(child.attrib)

    def resolve(self, tag: str, el, cls: Optional[str]) -> Dict[str, str]:
        """``el``'s attributes over those of its class chain, ``main`` last."""
        chain = []
        c = cls or "main"
        while c is not None:
            chain.append(c)
            c = self.parent.get(c)
        if "main" not in chain:
            chain.append("main")
        attrs: Dict[str, str] = {}
        for c in reversed(chain):
            attrs.update(self.classes.get(c, {}).get(tag, {}))
        attrs.update(el.attrib)
        return attrs


def _geom_from_attrs(attrs: Dict[str, str]) -> Optional[ShapeSpec]:
    gtype = _GEOM_TYPES.get(attrs.get("type", "sphere"))
    if gtype is None:
        logger.warning("MJCF geom type %r unsupported; skipped", attrs.get("type"))
        return None
    size = _f(attrs.get("size"), np.array([0.01]))
    pos = _f(attrs.get("pos"), np.zeros(3))
    quat = np.array([1.0, 0, 0, 0])
    fromto = _f(attrs.get("fromto"))
    if fromto is not None:
        a, b = fromto[:3], fromto[3:]
        d = b - a
        length = np.linalg.norm(d)
        pos = (a + b) / 2
        if length > 1e-9:
            quat = _z_to(d / length)
        size = np.array([size[0], length / 2, 0])
    else:
        orientation = {k: attrs[k] for k in ("quat", "euler", "zaxis") if k in attrs}
        if orientation:
            quat = _quat_attr(orientation)
        if gtype in (CAPSULE, CYLINDER) and len(size) >= 2:
            size = np.array([size[0], size[1], 0])
        elif gtype == BOX:
            size = size[:3]
        elif gtype == SPHERE:
            size = np.array([size[0], 0, 0])
        elif gtype == PLANE:
            size = np.zeros(3)
    rgba = _f(attrs.get("rgba"), np.array([0.6, 0.6, 0.6, 1.0]))
    friction = _f(attrs.get("friction"), np.array([1.0]))
    shape = ShapeSpec(gtype, size, pos, quat, friction=float(friction[0]), density=float(attrs.get("density", 1000.0)),
                      color=tuple(rgba))
    if attrs.get("mass") is not None:
        shape.density = -float(attrs["mass"])  # a negative density marks an explicit mass
    return shape


def _flatten_includes(root, base: str):
    """Splice each ``<include file=...>``'s children in place of it."""
    parents = {child: parent for parent in root.iter() for child in parent}
    for inc in root.findall(".//include"):
        parent = parents[inc]
        path = os.path.join(base, inc.get("file"))
        if os.path.exists(path):
            try:
                for child in ET.parse(path).getroot():
                    parent.append(child)
            except Exception as e:
                logger.warning("MJCF include %s failed: %s", path, e)
        parent.remove(inc)


class MJCFLoader:
    def __init__(self, scene):
        self.scene = scene
        self.name: Optional[str] = None
        self.fix_root_link = True
        self.disable_self_collisions = False

    def parse(self, mjcf_path: str) -> Dict:
        """{"articulation_builders": [the bodies' builder], "actor_builders":
        [the worldbody geoms' builder]} (each list empty when there is
        nothing of the kind)."""
        root = ET.parse(mjcf_path).getroot()
        _flatten_includes(root, os.path.dirname(mjcf_path))
        defaults = _Defaults()
        defaults.parse(root)
        compiler = root.find("compiler")
        angle_deg = compiler is None or compiler.get("angle", "degree") == "degree"
        world = root.find("worldbody")
        if world is None:
            raise ValueError("MJCF missing worldbody")

        builder = ArticulationBuilder(self.scene)
        builder.fix_root_link = self.fix_root_link
        builder.disable_self_collisions = self.disable_self_collisions
        counter = [0]

        def fill_joint(spec, j, cls):
            ja = defaults.resolve("joint", j, j.get("class", cls))
            spec.joint_type = {"hinge": HINGE, "slide": SLIDE, "free": FREE}.get(ja.get("type", "hinge"), HINGE)
            spec.joint_name = j.get("name", spec.name + "_joint")
            spec.axis = _f(ja.get("axis"), np.array([0, 0, 1.0]))
            rng = _f(ja.get("range"))
            if rng is not None and ja.get("limited", "true") != "false":
                lo, hi = float(rng[0]), float(rng[1])
                if angle_deg and spec.joint_type == HINGE:
                    lo, hi = np.deg2rad(lo), np.deg2rad(hi)
                spec.limit = (lo, hi)
            spec.damping = float(ja.get("damping", 0.0))
            spec.stiffness = float(ja.get("stiffness", 0.0))
            spec.springref = float(ja.get("springref", 0.0))
            spec.armature = float(ja.get("armature", 0.0))

        def walk(body_el, parent_name: Optional[str], cls: Optional[str]):
            cls = body_el.get("childclass", cls)
            name = body_el.get("name") or f"body{counter[0]}"
            counter[0] += 1
            spec = LinkSpec(name, parent_name)
            spec.origin_pos = _f(body_el.get("pos"), np.zeros(3))
            spec.origin_quat = _quat_attr(body_el)
            joints = body_el.findall("joint")
            free = body_el.find("freejoint")
            if free is not None:
                spec.joint_type = FREE
                spec.joint_name = free.get("name", name + "_free")
            elif joints:
                # one joint per body: the first joints go on massless bodies
                # chained in front, the last on the real body, so its geoms
                # and inertia stay put
                parent_for_real = spec.parent
                origin_pos, origin_quat = spec.origin_pos, spec.origin_quat
                for k, j in enumerate(joints[:-1]):
                    dummy = LinkSpec(f"{name}_jchain{k}", parent_for_real,
                                     origin_pos=origin_pos if k == 0 else (0, 0, 0),
                                     origin_quat=origin_quat if k == 0 else (1, 0, 0, 0),
                                     mass=1e-4, inertia=np.full(3, 1e-8))
                    fill_joint(dummy, j, cls)
                    builder.add_link(dummy)
                    parent_for_real = dummy.name
                    origin_pos, origin_quat = (0, 0, 0), (1, 0, 0, 0)
                spec.parent = parent_for_real
                spec.origin_pos, spec.origin_quat = origin_pos, origin_quat
                fill_joint(spec, joints[-1], cls)
            else:
                spec.joint_type = FIXED

            inertial = body_el.find("inertial")
            if inertial is not None:
                spec.mass = float(inertial.get("mass"))
                spec.com = _f(inertial.get("pos"), np.zeros(3))
                diag = _f(inertial.get("diaginertia"))
                if diag is not None:
                    spec.inertia = diag
            for g in body_el.findall("geom"):
                ga = defaults.resolve("geom", g, g.get("class", cls))
                shape = _geom_from_attrs(ga)
                if shape is None:
                    continue
                # contype = conaffinity = 0: no collision shape; group 3: not drawn
                if int(ga.get("contype", 1)) or int(ga.get("conaffinity", 1)):
                    spec.collisions.append(shape)
                if int(ga.get("group", 0)) in _VISUAL_GROUPS:
                    spec.visuals.append(shape)
            builder.add_link(spec)
            for child in body_el.findall("body"):
                walk(child, name, cls)

        actor_shapes: List[ShapeSpec] = []
        for g in world.findall("geom"):
            shape = _geom_from_attrs(defaults.resolve("geom", g, g.get("class")))
            if shape is not None:
                actor_shapes.append(shape)
        for body in world.findall("body"):
            walk(body, None, None)

        # <contact><exclude body1 body2/>: no narrowphase between the bodies
        link_names = {link.name for link in builder.links}
        for contact in root.findall("contact"):
            for exc in contact.findall("exclude"):
                b1, b2 = exc.get("body1"), exc.get("body2")
                if b1 in link_names and b2 in link_names:
                    builder.collision_exclude_pairs.append((b1, b2))
                else:
                    logger.warning("MJCF contact/exclude references unknown body (%r, %r); skipped", b1, b2)
            for pair in contact.findall("pair"):
                logger.warning("MJCF contact/pair (%r, %r) not supported: the filtering here only removes pairs "
                               "(contype/conaffinity and excludes)", pair.get("geom1"), pair.get("geom2"))

        actor_builder = None
        if actor_shapes:
            actor_builder = self.scene.create_actor_builder()
            for s in actor_shapes:
                pose = np.concatenate([s.pos, s.quat])
                if s.type == BOX:
                    actor_builder.add_box_collision(pose=pose, half_size=s.size[:3], friction=s.friction)
                    actor_builder.add_box_visual(pose=pose, half_size=s.size[:3], color=s.color)
                elif s.type == PLANE:
                    actor_builder.add_plane_collision(pose=pose, friction=s.friction)
                elif s.type == SPHERE:
                    actor_builder.add_sphere_collision(pose=pose, radius=float(s.size[0]))
                else:
                    add = actor_builder.add_capsule_collision if s.type == CAPSULE else \
                        actor_builder.add_cylinder_collision
                    add(pose=pose, radius=float(s.size[0]), half_length=float(s.size[1]))
        return {
            "articulation_builders": [builder] if builder.links else [],
            "actor_builders": [actor_builder] if actor_builder else [],
        }

    def load(self, mjcf_path: str, initial_pose=None):
        builder = self.parse(mjcf_path)["articulation_builders"][0]
        if initial_pose is not None:
            builder.set_initial_pose(np.asarray(initial_pose))
        return builder.build(self.name or os.path.basename(mjcf_path))
