"""Minimal mesh loaders, host side and dependency-free (counterpart of
maniskill_tpu/utils/geometry/mesh_io.py).

STL (binary and ascii) and OBJ are parsed directly. The URDF loader's mesh
branch reads collision and visual meshes through them.
"""
from __future__ import annotations

import struct as _struct
from pathlib import Path
from typing import Tuple

import numpy as np


def load_stl(path: str) -> Tuple[np.ndarray, np.ndarray]:
    data = Path(path).read_bytes()
    if data[:5].lower() == b"solid" and b"facet" in data[:500]:
        return _load_stl_ascii(data.decode("ascii", errors="ignore"))
    n_tri = _struct.unpack("<I", data[80:84])[0]
    rec = np.frombuffer(
        data[84 : 84 + n_tri * 50],
        dtype=np.dtype(
            [("n", "<3f4"), ("v", "<(3,3)f4"), ("attr", "<u2")], align=False
        ),
    )
    verts = rec["v"].reshape(-1, 3).astype(np.float32)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    return _dedupe(verts, faces)


def _load_stl_ascii(text: str):
    verts = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            verts.append([float(x) for x in line.split()[1:4]])
    verts = np.asarray(verts, np.float32)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    return _dedupe(verts, faces)


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    verts, faces = [], []
    for line in Path(path).read_text(errors="ignore").splitlines():
        if line.startswith("v "):
            verts.append([float(x) for x in line.split()[1:4]])
        elif line.startswith("f "):
            idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:]]
            for k in range(1, len(idx) - 1):  # fan triangulation
                faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    suffix = Path(path).suffix.lower()
    if suffix == ".stl":
        return load_stl(path)
    if suffix == ".obj":
        return load_obj(path)
    raise ValueError(f"unsupported mesh format {suffix} ({path})")


def _dedupe(verts: np.ndarray, faces: np.ndarray):
    uniq, inverse = np.unique(
        verts.round(decimals=7), axis=0, return_inverse=True
    )
    return uniq.astype(np.float32), inverse[faces].astype(np.int32)


def decimate(verts: np.ndarray, faces: np.ndarray, max_faces: int):
    """Crude decimation: uniformly subsample faces (visual meshes only)."""
    if len(faces) <= max_faces:
        return verts, faces
    keep = np.linspace(0, len(faces) - 1, max_faces).astype(np.int64)
    return verts, faces[keep]
