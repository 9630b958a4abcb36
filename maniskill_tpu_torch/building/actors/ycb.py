"""YCB object library (counterpart of maniskill_tpu/building/actors/ycb.py).

Each model id maps to the real YCB meshes where the download is present in
``ASSET_DIR/assets/mani_skill2_ycb`` (``textured.obj`` with its texture baked
per face; ``collision.ply``, which the mesh reader does not take, so that
branch raises as the JAX package's does), else to a procedural stand-in
mesh with the rough scale, mass and topology class of the YCB object. The
mesh is cooked to convex hull proxies (building/cooking.py).

All generators return (verts (V,3) f32, faces (F,3) i32) triangle soups in
metres; callers place objects by the hull's z-extent.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Tuple

import numpy as np

from ...utils.assets import ASSET_DIR

Mesh = Tuple[np.ndarray, np.ndarray]


def _merge(parts: List[Mesh]) -> Mesh:
    vs, fs, off = [], [], 0
    for v, f in parts:
        vs.append(np.asarray(v, np.float32))
        fs.append(np.asarray(f, np.int32) + off)
        off += len(v)
    return np.concatenate(vs), np.concatenate(fs)


def _tbox(center, half) -> Mesh:
    c = np.asarray(center, np.float32)
    h = np.asarray(half, np.float32)
    v = np.array(list(itertools.product(*[[-1, 1]] * 3)), np.float32) * h + c
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    f = []
    for a, b, cc, d in quads:
        f += [(a, b, cc), (a, cc, d)]
    return v, np.array(f, np.int32)


def _tcyl(center, radius, half_h, n=12, axis=2) -> Mesh:
    ang = 2 * np.pi * np.arange(n) / n
    ring = np.stack([np.cos(ang) * radius, np.sin(ang) * radius], -1)
    top = np.concatenate([ring, np.full((n, 1), half_h)], -1)
    bot = np.concatenate([ring, np.full((n, 1), -half_h)], -1)
    v = np.concatenate([top, bot, [[0, 0, half_h], [0, 0, -half_h]]]).astype(np.float32)
    faces = []
    for i in range(n):
        j = (i + 1) % n
        faces += [(i, j, n + i), (j, n + j, n + i)]  # side
        faces += [(2 * n, j, i), (2 * n + 1, n + i, n + j)]  # caps
    if axis != 2:
        perm = [1, 2, 0] if axis == 0 else [2, 0, 1]
        v = v[:, perm]
    return v + np.asarray(center, np.float32), np.array(faces, np.int32)


# ---- procedural stand-ins (ids follow the YCB naming scheme) -----------

def _can() -> Mesh:  # 002_master_chef_can
    return _tcyl([0, 0, 0.0695], 0.051, 0.0695)


def _cracker_box() -> Mesh:  # 003_cracker_box
    return _tbox([0, 0, 0.105], [0.03, 0.079, 0.105])


def _sugar_box() -> Mesh:  # 004_sugar_box
    return _tbox([0, 0, 0.0875], [0.019, 0.0445, 0.0875])


def _soup_can() -> Mesh:  # 005_tomato_soup_can
    return _tcyl([0, 0, 0.0505], 0.033, 0.0505)


def _mustard() -> Mesh:  # 006_mustard_bottle
    return _merge([
        _tbox([0, 0, 0.06], [0.029, 0.04, 0.06]),
        _tbox([0, 0, 0.15], [0.02, 0.03, 0.03]),
    ])


def _banana() -> Mesh:  # 011_banana: three bent segments
    segs = []
    for i, ang in enumerate([-0.5, 0.0, 0.5]):
        c = np.array([0.06 * (i - 1), 0.018 * abs(i - 1), 0.018])
        v, f = _tcyl(np.zeros(3), 0.018, 0.036, n=8, axis=0)
        R = np.array([
            [np.cos(ang), -np.sin(ang), 0],
            [np.sin(ang), np.cos(ang), 0],
            [0, 0, 1],
        ], np.float32)
        segs.append((v @ R.T + c.astype(np.float32), f))
    return _merge(segs)


def _bowl() -> Mesh:  # 024_bowl: ring of wedges + base (concave)
    parts = [_tcyl([0, 0, 0.008], 0.07, 0.008)]
    n = 10
    for i in range(n):
        a = 2 * np.pi * i / n
        c = [0.068 * np.cos(a), 0.068 * np.sin(a), 0.03]
        v, f = _tbox([0, 0, 0], [0.0145, 0.022, 0.025])
        R = np.array([
            [np.cos(a), -np.sin(a), 0],
            [np.sin(a), np.cos(a), 0],
            [0, 0, 1],
        ], np.float32)
        parts.append((v @ R.T + np.asarray(c, np.float32), f))
    return _merge(parts)


def _mug() -> Mesh:  # 025_mug: cup + handle
    return _merge([
        _tcyl([0, 0, 0.04], 0.042, 0.04),
        _tbox([0.055, 0, 0.04], [0.012, 0.008, 0.028]),
        _tbox([0.048, 0, 0.012], [0.018, 0.008, 0.006]),
        _tbox([0.048, 0, 0.068], [0.018, 0.008, 0.006]),
    ])


def _drill() -> Mesh:  # 035_power_drill: L-shaped body + grip
    return _merge([
        _tcyl([0.02, 0, 0.13], 0.03, 0.09, axis=0),
        _tbox([0, 0, 0.05], [0.02, 0.018, 0.05]),
    ])


def _wood_block() -> Mesh:  # 036_wood_block
    return _tbox([0, 0, 0.1025], [0.0425, 0.0425, 0.1025])


def _marker() -> Mesh:  # 040_large_marker
    return _tcyl([0, 0, 0.009], 0.009, 0.06, axis=0)


def _clamp() -> Mesh:  # 051_large_clamp: two crossed slabs
    return _merge([
        _tbox([0, 0.02, 0.01], [0.06, 0.01, 0.01]),
        _tbox([0, -0.02, 0.01], [0.06, 0.01, 0.01]),
        _tbox([-0.05, 0, 0.01], [0.012, 0.03, 0.01]),
    ])


def _foam_brick() -> Mesh:  # 061_foam_brick
    return _tbox([0, 0, 0.0255], [0.0385, 0.026, 0.0255])


PROCEDURAL_MODELS: Dict[str, Callable[[], Mesh]] = {
    "002_master_chef_can": _can,
    "003_cracker_box": _cracker_box,
    "004_sugar_box": _sugar_box,
    "005_tomato_soup_can": _soup_can,
    "006_mustard_bottle": _mustard,
    "011_banana": _banana,
    "024_bowl": _bowl,
    "025_mug": _mug,
    "035_power_drill": _drill,
    "036_wood_block": _wood_block,
    "040_large_marker": _marker,
    "051_large_clamp": _clamp,
    "061_foam_brick": _foam_brick,
}

MODEL_DENSITIES: Dict[str, float] = {
    # rough YCB-like masses via density; default 1000 (water)
    "061_foam_brick": 150.0,
    "003_cracker_box": 250.0,
    "004_sugar_box": 450.0,
    "011_banana": 600.0,
}


def all_model_ids() -> List[str]:
    return sorted(PROCEDURAL_MODELS.keys())


def _model_dir(model_id: str):
    return ASSET_DIR / "assets" / "mani_skill2_ycb" / "models" / model_id


def load_model_mesh(model_id: str) -> Mesh:
    """The real YCB collision mesh if downloaded, else the procedural
    stand-in. The real one is a ``.ply``, which ``load_mesh`` does not read,
    so that branch raises ``ValueError`` as the reference's does."""
    real = _model_dir(model_id) / "collision.ply"
    if real.exists():
        from ...utils.geometry.mesh_io import load_mesh

        return load_mesh(str(real))
    gen = PROCEDURAL_MODELS.get(model_id)
    if gen is None:
        raise KeyError(f"unknown YCB model id {model_id!r}; known: {all_model_ids()}")
    return gen()


def cooked_hulls(model_id: str, max_parts: int = 8):
    """Convex hull proxies for a model: a list of (HULL_MAX_VERTS, 3) float32."""
    from ..cooking import decompose_mesh

    v, f = load_model_mesh(model_id)
    return decompose_mesh(v, f, max_parts=max_parts)


def load_model_visual(model_id: str, max_faces: int = 800):
    """Visual mesh of a model: (verts, faces, face_colors or None). With the
    real dataset, ``textured.obj`` with its texture baked per face at each
    face's centroid UV, decimated past ``max_faces`` with each kept face
    taking the colour of the original face nearest its centroid; else the
    stand-in with flat colours."""
    real = _model_dir(model_id) / "textured.obj"
    if real.exists():
        from ...render.textures import bake_obj_face_colors
        from ...utils.geometry.mesh_io import decimate

        v, f, fc = bake_obj_face_colors(str(real))
        if len(f) > max_faces:
            dv, df = decimate(v, f, max_faces)
            cen_d = dv[df].mean(axis=1)
            cen_o = v[f].mean(axis=1)
            d2 = ((cen_d[:, None, :] - cen_o[None, :, :]) ** 2).sum(-1)
            fc = fc[np.argmin(d2, axis=1)]
            v, f = dv, df
        return v, f, fc
    return (*load_model_mesh(model_id), None)
