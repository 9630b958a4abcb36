"""URDF loader (counterpart of maniskill_tpu/building/urdf_loader.py).

Parses URDF XML into ``LinkSpec``s for the ArticulationBuilder, with the
standard library's ``xml.etree.ElementTree`` (the JAX package parses with
lxml). Its semantics are the JAX package's, since keyframes and controller
joint lists depend on them: links in depth-first order (a stack extended
with the sorted children, reversed), ``floating`` joints as FIXED, no limit
on ``continuous`` joints, ``scale`` applied to every length (prismatic
limits and inertias too), and mass 1e-4 with inertia 1e-8 for a link with no
``<inertial>``.

Primitive geometries map directly. Mesh collision geometries are cooked at
load time: with ``load_multiple_collisions_from_file`` they decompose into
convex HULL proxies; otherwise the native cooking library fits a primitive
(a capsule for elongated shapes, an OBB otherwise). Visual meshes stay
triangle meshes for the rasterizer.
"""
from __future__ import annotations

import logging
import math
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from ..physics.types import BOX, CAPSULE, CYLINDER, FIXED, HINGE, HULL, MESH, SLIDE, SPHERE
from .articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec

logger = logging.getLogger(__name__)


def _floats(s, default=None):
    if s is None:
        return default
    return np.array([float(x) for x in s.split()])


def _rpy_to_quat(rpy):
    if rpy is None:
        return np.array([1.0, 0, 0, 0])
    r, p, y = rpy
    cr, sr = math.cos(r / 2), math.sin(r / 2)
    cp, sp = math.cos(p / 2), math.sin(p / 2)
    cy, sy = math.cos(y / 2), math.sin(y / 2)
    return np.array(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ]
    )


def _origin(el):
    if el is None:
        return np.zeros(3), np.array([1.0, 0, 0, 0])
    o = el.find("origin")
    if o is None:
        return np.zeros(3), np.array([1.0, 0, 0, 0])
    xyz = _floats(o.get("xyz"), np.zeros(3))
    quat = _rpy_to_quat(_floats(o.get("rpy"), np.zeros(3)))
    return xyz, quat


def _parse_geometry(geom_el, mesh_fallback: bool, base_dir: str = ".", visual: bool = False,
                    convex_hulls: bool = False, scale: float = 1.0):
    """A ShapeSpec, a list of ShapeSpecs (a mesh cooked into hulls), or None."""
    g = geom_el.find("geometry")
    if g is None:
        return None
    pos, quat = _origin(geom_el)
    pos = np.asarray(pos) * scale
    box = g.find("box")
    if box is not None:
        size = _floats(box.get("size")) / 2 * scale
        return ShapeSpec(BOX, size, pos, quat)
    sph = g.find("sphere")
    if sph is not None:
        return ShapeSpec(SPHERE, [float(sph.get("radius")) * scale, 0, 0], pos, quat)
    cyl = g.find("cylinder")
    if cyl is not None:
        r = float(cyl.get("radius")) * scale
        hl = float(cyl.get("length")) / 2 * scale
        return ShapeSpec(CYLINDER, [r, hl, 0], pos, quat)
    cap = g.find("capsule")
    if cap is not None:
        r = float(cap.get("radius")) * scale
        hl = float(cap.get("length")) / 2 * scale
        return ShapeSpec(CAPSULE, [r, hl, 0], pos, quat)
    mesh = g.find("mesh")
    if mesh is not None:
        return _cook_mesh(mesh, pos, quat, base_dir, visual, mesh_fallback,
                          convex_hulls=convex_hulls, scale=scale)
    return None


def _compose(pos, quat, local_pos, local_quat) -> np.ndarray:
    """(pos, quat) * (local_pos, local_quat) as f32 poses, returned as f64."""
    from ..structs.pose import Pose

    combined = (Pose(np.concatenate([pos, quat]).astype(np.float32))
                * Pose(np.concatenate([local_pos, local_quat]).astype(np.float32))).raw_pose
    return np.asarray(combined, np.float64)


def _cook_mesh(mesh_el, pos, quat, base_dir, visual, mesh_fallback, convex_hulls: bool = False,
               scale: float = 1.0):
    """Load a mesh and cook it: a fitted primitive (or convex hull proxies)
    for a collision mesh, a decimated triangle mesh for a visual one."""
    from ..utils.geometry.mesh_io import decimate, load_mesh

    fname = mesh_el.get("filename", "")
    mesh_scale = _floats(mesh_el.get("scale"), np.ones(3))
    path = fname if os.path.isabs(fname) else os.path.join(base_dir, fname)
    try:
        verts, faces = load_mesh(path)
    except (OSError, ValueError) as e:
        if mesh_fallback:
            return ShapeSpec(SPHERE, [0.03, 0, 0], pos, quat)
        logger.warning("URDF mesh %s not loadable (%s); skipped", fname, e)
        return None
    verts = verts * (np.asarray(mesh_scale, np.float32) * scale)

    if visual:
        verts, faces = decimate(verts, faces, 600)
        return ShapeSpec(MESH, [1.0, 1.0, 1.0], pos, quat, mesh=(verts, faces))

    if convex_hulls:
        try:
            from .cooking import decompose_mesh, hull_face_dirs

            return [
                ShapeSpec(HULL, np.abs(h).max(axis=0), pos, quat, hull=h, hull_dirs=hull_face_dirs(h))
                for h in decompose_mesh(verts, faces, max_parts=8)
            ]
        except Exception as e:
            logger.warning("hull cooking failed for %s (%s); primitive fallback", fname, e)

    # collision: fit a primitive with the native cooking library
    try:
        from ..native import fit_capsule, fit_obb

        center, oq, half = fit_obb(verts.astype(np.float64))
        aspect = half.max() / max(np.median(half), 1e-6)
        combined = _compose(pos, quat, center, oq)
        if aspect > 2.5:
            c2, q2, r, hl = fit_capsule(verts.astype(np.float64))
            combined = _compose(pos, quat, c2, q2)
            return ShapeSpec(CAPSULE, [r, hl, 0], combined[:3], combined[3:])
        return ShapeSpec(BOX, half, combined[:3], combined[3:])
    except Exception as e:  # cooking failed: a conservative sphere
        logger.warning("mesh cooking failed for %s (%s); sphere fallback", fname, e)
        return ShapeSpec(SPHERE, [0.03, 0, 0], pos, quat)


class URDFLoader:
    def __init__(self, scene):
        self.scene = scene
        self.name: Optional[str] = None
        self.fix_root_link = True
        self.disable_self_collisions = False
        self.load_multiple_collisions_from_file = False
        self.scale = 1.0
        self.density = 1000.0
        self.mesh_fallback = False

    def parse(self, urdf_path: str) -> Dict:
        base_dir = os.path.dirname(os.path.abspath(urdf_path))
        robot = ET.parse(urdf_path).getroot()
        links = {link.get("name"): link for link in robot.findall("link")}
        joints = list(robot.findall("joint"))

        child_to_joint: Dict[str, ET.Element] = {}
        parents: Dict[str, Optional[str]] = {n: None for n in links}
        for j in joints:
            child = j.find("child").get("link")
            child_to_joint[child] = j
            parents[child] = j.find("parent").get("link")
        roots = [n for n, p in parents.items() if p is None]
        if len(roots) != 1:
            raise ValueError(f"URDF must have exactly one root link, got {roots}")

        # depth-first order: a stack extended with the children, sorted and
        # reversed, so the alphabetically first child's subtree comes first
        children: Dict[str, List[str]] = {n: [] for n in links}
        for c, p in parents.items():
            if p is not None:
                children[p].append(c)
        order: List[str] = []
        stack = [roots[0]]
        while stack:
            n = stack.pop()
            order.append(n)
            stack.extend(sorted(children[n], reverse=True))

        builder = ArticulationBuilder(self.scene)
        builder.fix_root_link = self.fix_root_link
        builder.disable_self_collisions = self.disable_self_collisions

        jtype_map = {"revolute": HINGE, "continuous": HINGE, "prismatic": SLIDE,
                     "fixed": FIXED, "floating": FIXED}
        scale = float(self.scale)
        for name in order:
            link_el = links[name]
            spec = LinkSpec(name, parents[name])
            j = child_to_joint.get(name)
            if j is not None:
                spec.joint_type = jtype_map.get(j.get("type"), FIXED)
                spec.joint_name = j.get("name")
                spec.origin_pos, spec.origin_quat = _origin(j)
                spec.origin_pos = np.asarray(spec.origin_pos) * scale
                ax = j.find("axis")
                spec.axis = _floats(ax.get("xyz")) if ax is not None else np.array([1.0, 0, 0])
                lim = j.find("limit")
                if lim is not None and j.get("type") != "continuous":
                    lo = float(lim.get("lower", "-inf") or -np.inf)
                    hi = float(lim.get("upper", "inf") or np.inf)
                    if j.get("type") == "prismatic":
                        # scale scales every length, prismatic travel included
                        lo, hi = lo * scale, hi * scale
                    spec.limit = (lo, hi)
                dyn = j.find("dynamics")
                if dyn is not None:
                    spec.damping = float(dyn.get("damping", 0.0))
                    spec.frictionloss = float(dyn.get("friction", 0.0))

            inertial = link_el.find("inertial")
            if inertial is not None:
                m = inertial.find("mass")
                spec.mass = float(m.get("value")) if m is not None else 1e-4
                com, iquat = _origin(inertial)
                spec.com = np.asarray(com) * scale
                ine = inertial.find("inertia")
                if ine is not None:
                    ixx = float(ine.get("ixx", 1e-7))
                    iyy = float(ine.get("iyy", 1e-7))
                    izz = float(ine.get("izz", 1e-7))
                    ixy = float(ine.get("ixy", 0))
                    ixz = float(ine.get("ixz", 0))
                    iyz = float(ine.get("iyz", 0))
                    inertia = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
                    # rotated into the inertial frame's orientation; rotational
                    # inertia scales with length squared
                    from .inertia import quat_to_mat_np

                    R = quat_to_mat_np(iquat)
                    spec.inertia = (R @ inertia @ R.T) * scale**2
            else:
                spec.mass = 1e-4
                spec.inertia = np.full(3, 1e-8)

            for col in link_el.findall("collision"):
                shape = _parse_geometry(col, self.mesh_fallback, base_dir,
                                        convex_hulls=self.load_multiple_collisions_from_file, scale=scale)
                if isinstance(shape, list):
                    spec.collisions.extend(shape)
                elif shape is not None:
                    spec.collisions.append(shape)
            for vis in link_el.findall("visual"):
                shape = _parse_geometry(vis, mesh_fallback=True, base_dir=base_dir, visual=True, scale=scale)
                if shape is not None:
                    spec.visuals.append(shape)
            builder.add_link(spec)
        return {"articulation_builders": [builder], "actor_builders": []}

    def load(self, urdf_path: str, initial_pose=None):
        builder = self.parse(urdf_path)["articulation_builders"][0]
        if initial_pose is not None:
            builder.set_initial_pose(np.asarray(initial_pose))
        return builder.build(self.name or os.path.basename(urdf_path))
