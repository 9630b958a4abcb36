"""Host-side asset cooking through ctypes over ``cooking.cpp`` (counterpart
of maniskill_tpu/native/__init__.py).

Closed-mesh mass properties, a PCA oriented bounding box and capsule (the
URDF loader's mesh colliders), and support-point scans for the convex hull
proxies of ``building/cooking.py``. The library is compiled with ``g++`` at
first use into the package's gitignored ``_build/`` (keyed by the source's
hash) and loaded from there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "cooking.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_LIB: Optional[ctypes.CDLL] = None


def _build() -> Path:
    src = _SRC.read_bytes()
    so = _BUILD_DIR / f"libcooking_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if not so.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the host cooking library needs a C++ compiler")
        _BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        res = subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builders never load a partial file
    return so


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build()))
        d = ctypes.POINTER(ctypes.c_double)
        i = ctypes.POINTER(ctypes.c_int32)
        lib.mesh_mass_properties.argtypes = [d, ctypes.c_int64, i, ctypes.c_int64, d]
        lib.mesh_mass_properties.restype = ctypes.c_int
        lib.fit_obb.argtypes = [d, ctypes.c_int64, d]
        lib.fit_obb.restype = ctypes.c_int
        lib.fit_capsule.argtypes = [d, ctypes.c_int64, d]
        lib.fit_capsule.restype = ctypes.c_int
        lib.support_points.argtypes = [d, ctypes.c_int64, d, ctypes.c_int64, i]
        lib.support_points.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def mesh_mass_properties(verts: np.ndarray, tris: np.ndarray):
    """Closed-mesh (volume, com, inertia 3x3 about COM) for unit density."""
    verts = np.ascontiguousarray(verts, np.float64)
    tris = np.ascontiguousarray(tris, np.int32)
    out = np.zeros(10, np.float64)
    rc = _lib().mesh_mass_properties(
        _dp(verts), len(verts), tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(tris), _dp(out),
    )
    if rc != 0:
        raise ValueError("degenerate mesh (zero volume)")
    vol, com = out[0], out[1:4]
    Ixx, Iyy, Izz, Ixy, Ixz, Iyz = out[4:10]
    inertia = np.array([[Ixx, -Ixy, -Ixz], [-Ixy, Iyy, -Iyz], [-Ixz, -Iyz, Izz]])
    return float(vol), com.copy(), inertia


def fit_obb(points: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PCA OBB: (center (3,), quat wxyz (4,), half_extents (3,))."""
    pts = np.ascontiguousarray(points.reshape(-1, 3), np.float64)
    out = np.zeros(10, np.float64)
    if _lib().fit_obb(_dp(pts), len(pts), _dp(out)) != 0:
        raise ValueError("need >= 3 points")
    return out[0:3].copy(), out[3:7].copy(), out[7:10].copy()


def fit_capsule(points: np.ndarray):
    """PCA capsule: (center (3,), quat wxyz (4,) whose +z is the major axis,
    radius, half_length)."""
    pts = np.ascontiguousarray(points.reshape(-1, 3), np.float64)
    out = np.zeros(10, np.float64)
    if _lib().fit_capsule(_dp(pts), len(pts), _dp(out)) != 0:
        raise ValueError("need >= 3 points")
    center, quat = out[0:3].copy(), out[3:7].copy()
    radius, half_len, major = float(out[7]), float(out[8]), int(out[9])
    # compose so that the capsule's local +z maps onto the OBB's major axis
    if major == 0:  # +z -> +x: +90 degrees about y
        extra = np.array([np.cos(np.pi / 4), 0, np.sin(np.pi / 4), 0])
    elif major == 1:  # +z -> +y: -90 degrees about x
        extra = np.array([np.cos(np.pi / 4), -np.sin(np.pi / 4), 0, 0])
    else:
        extra = np.array([1.0, 0, 0, 0])
    w1, x1, y1, z1 = quat
    w2, x2, y2, z2 = extra
    quat = np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )
    return center, quat, radius, half_len


def support_points(points: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Index of the support (max-dot) vertex for each direction: (D,) int32."""
    pts = np.ascontiguousarray(points.reshape(-1, 3), np.float64)
    dd = np.ascontiguousarray(dirs.reshape(-1, 3), np.float64)
    out = np.zeros(len(dd), np.int32)
    _lib().support_points(_dp(pts), len(pts), _dp(dd), len(dd), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
