"""Host-side primitive mesh generation (counterpart of
maniskill_tpu/render/meshes.py; numpy, build time only).

Generates unit triangle meshes for each geom type; the rasterizer transforms
them with the batched body poses straight from the physics state.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..physics.types import BOX, CAPSULE, CYLINDER, PLANE, SPHERE


def box_mesh() -> Tuple[np.ndarray, np.ndarray]:
    """Unit box (half-size 1) -> (verts (8,3), faces (12,3))."""
    v = np.array(
        [
            [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
            [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
        ],
        np.float32,
    )
    f = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # bottom (-z)
            [4, 5, 6], [4, 6, 7],  # top (+z)
            [0, 1, 5], [0, 5, 4],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [1, 2, 6], [1, 6, 5],  # +x
            [3, 0, 4], [3, 4, 7],  # -x
        ],
        np.int32,
    )
    return v, f


def uv_sphere_mesh(n_lat: int = 8, n_lon: int = 12) -> Tuple[np.ndarray, np.ndarray]:
    """Unit sphere."""
    verts = [np.array([0, 0, 1.0])]
    for i in range(1, n_lat):
        theta = np.pi * i / n_lat
        for j in range(n_lon):
            phi = 2 * np.pi * j / n_lon
            verts.append(
                [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)]
            )
    verts.append(np.array([0, 0, -1.0]))
    verts = np.asarray(verts, np.float32)
    faces = []
    # top cap
    for j in range(n_lon):
        faces.append([0, 1 + j, 1 + (j + 1) % n_lon])
    # bands
    for i in range(n_lat - 2):
        r0 = 1 + i * n_lon
        r1 = 1 + (i + 1) * n_lon
        for j in range(n_lon):
            j2 = (j + 1) % n_lon
            faces.append([r0 + j, r1 + j, r1 + j2])
            faces.append([r0 + j, r1 + j2, r0 + j2])
    # bottom cap
    last = len(verts) - 1
    r0 = 1 + (n_lat - 2) * n_lon
    for j in range(n_lon):
        faces.append([last, r0 + (j + 1) % n_lon, r0 + j])
    return verts, np.asarray(faces, np.int32)


def cylinder_mesh(n: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """Unit cylinder: radius 1, half-length 1, axis z."""
    verts = []
    for z in (-1.0, 1.0):
        for j in range(n):
            phi = 2 * np.pi * j / n
            verts.append([np.cos(phi), np.sin(phi), z])
    verts.append([0, 0, -1.0])
    verts.append([0, 0, 1.0])
    verts = np.asarray(verts, np.float32)
    faces = []
    for j in range(n):
        j2 = (j + 1) % n
        # side, wound outward like the caps: the tiled path culls back faces
        faces.append([j, n + j2, n + j])
        faces.append([j, j2, n + j2])
        # caps
        faces.append([2 * n, j2, j])
        faces.append([2 * n + 1, n + j, n + j2])
    return verts, np.asarray(faces, np.int32)


def capsule_mesh(radius: float, half_length: float, n_lat=6, n_lon=12):
    """Capsule with given radius/half-length (cannot be unit-scaled)."""
    v, f = uv_sphere_mesh(n_lat * 2, n_lon)
    v = v * radius
    v[:, 2] += np.where(v[:, 2] >= 0, half_length, -half_length)
    return v.astype(np.float32), f


def plane_mesh(extent: float = 20.0) -> Tuple[np.ndarray, np.ndarray]:
    v = np.array(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32
    ) * extent
    v[:, 2] = 0
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return v, f


def geom_mesh(gtype: int, size: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Mesh for a geom in its local frame, scaled by its size params."""
    size = np.asarray(size, np.float32)
    if gtype == BOX:
        v, f = box_mesh()
        return v * size[None, :], f
    if gtype == SPHERE:
        v, f = uv_sphere_mesh()
        return v * size[0], f
    if gtype == CYLINDER:
        v, f = cylinder_mesh()
        v = v.copy()
        v[:, :2] *= size[0]
        v[:, 2] *= size[1]
        return v, f
    if gtype == CAPSULE:
        return capsule_mesh(size[0], size[1])
    if gtype == PLANE:
        return plane_mesh()
    raise ValueError(f"no mesh for geom type {gtype}")
