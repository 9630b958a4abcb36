"""Convex-hull cooking for mesh collision shapes (counterpart of
maniskill_tpu/building/cooking.py; the same arrays bit for bit).

A mesh becomes one or more fixed-size convex vertex clouds ("hull proxies")
for the batched support-function narrowphase (physics/collision.py).
Everything here is host numpy at load time; the inner support scans run in
the native cooking library (``native.support_points``).

Hull proxy = HULL_MAX_VERTS support vertices sampled over a Fibonacci
direction set; candidate SAT axes = the dominant facet normals of that proxy.
Decomposition = recursive OBB-axis splitting until each part's hull fills
its geometry well enough (concavity measured as hull-volume/part-volume
mismatch, split along the longest OBB axis).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..native import fit_obb, mesh_mass_properties, support_points

HULL_MAX_VERTS = 16
HULL_MAX_DIRS = 8


def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
        axis=-1,
    )


def hull_proxy(verts: np.ndarray, max_verts: int = HULL_MAX_VERTS) -> np.ndarray:
    """Support-sample a convex proxy: (max_verts, 3), padded by repetition."""
    verts = np.asarray(verts, np.float64).reshape(-1, 3)
    dirs = _fibonacci_sphere(64)
    idx = np.unique(support_points(verts, dirs))
    pts = verts[idx]
    if len(pts) > max_verts:
        # farthest-point subsample keeps the extremes spread out
        keep = [int(np.argmax(np.linalg.norm(pts - pts.mean(0), axis=1)))]
        d2 = np.linalg.norm(pts - pts[keep[0]], axis=1)
        for _ in range(max_verts - 1):
            nxt = int(np.argmax(d2))
            keep.append(nxt)
            d2 = np.minimum(d2, np.linalg.norm(pts - pts[nxt], axis=1))
        pts = pts[keep]
    if len(pts) < max_verts:
        pts = np.concatenate(
            [pts, np.repeat(pts[:1], max_verts - len(pts), axis=0)]
        )
    return pts.astype(np.float32)


def hull_face_dirs(pts: np.ndarray, max_dirs: int = HULL_MAX_DIRS) -> np.ndarray:
    """Dominant facet normals of a small convex vertex cloud: (max_dirs, 3).

    Brute-force over vertex triples (V <= 16 -> <= 560 planes): a plane is a
    facet when all points lie on one side; facet normals are greedily
    deduped by angle and ranked by supporting-triangle area.
    """
    pts = np.asarray(pts, np.float64).reshape(-1, 3)
    # dedupe padded/repeated verts
    uniq = np.unique(np.round(pts, 9), axis=0)
    V = len(uniq)
    if V < 4:
        out = np.zeros((max_dirs, 3), np.float32)
        out[:, 2] = 1.0
        return out
    c = uniq.mean(0)
    cands: List[Tuple[float, np.ndarray]] = []
    for i in range(V):
        for j in range(i + 1, V):
            for k in range(j + 1, V):
                n = np.cross(uniq[j] - uniq[i], uniq[k] - uniq[i])
                a = np.linalg.norm(n)
                if a < 1e-12:
                    continue
                n = n / a
                d = (uniq - uniq[i]) @ n
                if d.max() < 1e-6:
                    n = -n
                    d = -d
                if d.min() > -1e-6:
                    # orient outward (away from centroid)
                    if (c - uniq[i]) @ n > 0:
                        n = -n
                    cands.append((a, n))
    cands.sort(key=lambda t: -t[0])
    out: List[np.ndarray] = []
    for a, n in cands:
        if all(abs(n @ m) < 0.985 for m in out):
            out.append(n)
        if len(out) >= max_dirs:
            break
    if not out:
        out = [np.array([0.0, 0.0, 1.0])]
    i = 0
    while len(out) < max_dirs:  # pad by repetition
        out.append(out[i])
        i += 1
    return np.stack(out[:max_dirs]).astype(np.float32)


def support_morph_mesh(hull_pts: np.ndarray, n_lat: int = 6, n_lon: int = 10):
    """Fixed-topology triangle mesh approximating a convex vertex cloud.

    A unit-sphere triangulation is morphed onto the hull: each sphere vertex
    moves to the hull's support vertex in its direction. Topology (faces) is
    identical for every hull, so heterogeneous per-env objects can share one
    face table and differ only in vertex positions — the rasterizer's
    static-shape requirement.

    hull_pts: (..., V, 3). Returns (verts (..., NV, 3) f32, faces (NF, 3) i32).
    """
    from ..render.meshes import uv_sphere_mesh

    sv, faces = uv_sphere_mesh(n_lat, n_lon)
    dirs = sv / np.maximum(np.linalg.norm(sv, axis=-1, keepdims=True), 1e-9)
    pts = np.asarray(hull_pts, np.float32)
    dots = pts @ dirs.T.astype(np.float32)  # (..., V, NV)
    idx = np.argmax(dots, axis=-2)  # (..., NV)
    verts = np.take_along_axis(pts, idx[..., None].repeat(3, -1), axis=-2)
    return verts.astype(np.float32), faces.astype(np.int32)


def _hull_volume(pts: np.ndarray) -> float:
    """Convex-cloud volume via facet fan integration (small V only)."""
    pts = np.asarray(pts, np.float64).reshape(-1, 3)
    uniq = np.unique(np.round(pts, 9), axis=0)
    if len(uniq) < 4:
        return 0.0
    c = uniq.mean(0)
    vol = 0.0
    V = len(uniq)
    for i in range(V):
        for j in range(i + 1, V):
            for k in range(j + 1, V):
                n = np.cross(uniq[j] - uniq[i], uniq[k] - uniq[i])
                a = np.linalg.norm(n)
                if a < 1e-12:
                    continue
                nn = n / a
                d = (uniq - uniq[i]) @ nn
                if d.min() > -1e-6 or d.max() < 1e-6:
                    # facet triangle (one-sided): signed tet volume to centroid
                    vol += abs(np.dot(np.cross(uniq[i] - c, uniq[j] - c), uniq[k] - c)) / 6.0
    # each facet plane contributes its triangles once in expectation; the
    # brute-force fan double-counts co-planar splits — acceptable for the
    # concavity *ratio* heuristic this feeds.
    return float(vol)


def decompose_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    max_parts: int = 8,
    concavity_threshold: float = 1.6,
) -> List[np.ndarray]:
    """Approximate convex decomposition: list of hull-proxy vertex clouds.

    Recursive OBB-axis splitting (VHACD-style spirit): a part splits while
    its convex hull's volume exceeds ``concavity_threshold`` x the part's
    actual mesh volume (hull >> mesh = concave) and the budget allows.
    """
    verts = np.asarray(verts, np.float64).reshape(-1, 3)
    faces = np.asarray(faces, np.int32).reshape(-1, 3)

    def part_volume(fidx: np.ndarray) -> float:
        try:
            v, _, _ = mesh_mass_properties(verts, faces[fidx])
            return abs(float(v))
        except Exception:
            return 0.0

    def split(fidx: np.ndarray, budget: int) -> List[np.ndarray]:
        tri_pts = verts[faces[fidx]].reshape(-1, 3)
        proxy = hull_proxy(tri_pts)
        if budget <= 1 or len(fidx) < 8:
            return [proxy]
        mesh_vol = part_volume(fidx)
        hull_vol = _hull_volume(proxy)
        if mesh_vol <= 0 or hull_vol <= concavity_threshold * mesh_vol:
            return [proxy]
        # split triangles by centroid side of the longest OBB axis
        center, quat, half = fit_obb(tri_pts)
        axis_i = int(np.argmax(half))
        w, x, y, z = quat
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        axis = R[:, axis_i]
        cent = verts[faces[fidx]].mean(axis=1)
        side = (cent - center) @ axis > 0
        if side.all() or (~side).all():
            return [proxy]
        lo = split(fidx[~side], budget // 2)
        hi = split(fidx[side], budget - budget // 2)
        return lo + hi

    return split(np.arange(len(faces)), max_parts)
