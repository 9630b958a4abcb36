# Frozen copy of maniskill_tpu_torch/physics/types.py at the benchmark's first version:
# the benchmark's plain reference. It imports nothing of the program and is
# never edited to follow it.
"""Core physics types: static ``Model`` and dynamic ``Data`` (counterpart of
maniskill_tpu/physics/types.py).

Simulation state is a dataclass of torch tensors with a leading env axis; the
stepper is a function ``(Model, Data) -> Data`` built from batched tensor ops.

Design notes:
- Reduced coordinates everywhere: every simulated body hangs off a kinematic
  forest via exactly one joint (FREE / HINGE / SLIDE / FIXED).
- ``Model`` topology (parents, joint types, addresses) stays *numpy* (static,
  read by Python loops over tree levels). Physical parameters are tensors on
  the model's device and may carry a leading env axis for per-env
  heterogeneity.
- All dynamic state in ``Data`` is batched: leading axis = num_envs.
- The dynamics spine runs in f32: TF32 matmuls are switched off at import.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# The reference computes the dynamics spine with f32-accurate matmuls
# (``jax.default_matmul_precision("highest")``); TF32 keeps ~3 decimal digits,
# which would quantize forces and integrated velocities every substep.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Joint types
FREE = 0
HINGE = 1
SLIDE = 2
FIXED = 3

JOINT_NQ = {FREE: 7, HINGE: 1, SLIDE: 1, FIXED: 0}
JOINT_NV = {FREE: 6, HINGE: 1, SLIDE: 1, FIXED: 0}

# Geom types
PLANE = 0
SPHERE = 1
BOX = 2
CAPSULE = 3
CYLINDER = 4
MESH = 5  # visual-only
HULL = 6  # convex hull proxy

# Body dynamic types
DYNAMIC = 0
KINEMATIC = 1
STATIC = 2


class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(eq=False)
class Model(_Replace):
    """Static scene description (one kinematic forest for the whole scene)."""

    # ---- static topology (numpy) ----
    nq: int
    nv: int
    nbody: int
    ngeom: int
    body_parent: np.ndarray  # (nbody,) i32, world = 0, parent of world = -1
    body_jnt_type: np.ndarray  # (nbody,) i32
    body_q_adr: np.ndarray  # (nbody,) i32 into qpos
    body_dof_adr: np.ndarray  # (nbody,) i32 into qvel
    body_type: np.ndarray  # (nbody,) i32 DYNAMIC/KINEMATIC/STATIC
    geom_body: np.ndarray  # (ngeom,) i32
    geom_type: np.ndarray  # (ngeom,) i32
    pair_geom1: np.ndarray  # (npair,) i32 candidate collision pairs
    pair_geom2: np.ndarray  # (npair,) i32
    dof_body: np.ndarray  # (nv,) i32
    dof_is_rot: np.ndarray  # (nv,) bool
    dof_limited: np.ndarray  # (nv,) bool
    ancestor_mask: np.ndarray  # (nbody, nv) f32

    # ---- physical parameters (tensors; broadcastable to (B, ...)) ----
    body_pos: torch.Tensor  # (nbody, 3) joint frame in parent coords
    body_quat: torch.Tensor  # (nbody, 4)
    jnt_axis: torch.Tensor  # (nbody, 3) local joint axis
    body_ipos: torch.Tensor  # (nbody, 3) COM offset in body frame
    body_iquat: torch.Tensor  # (nbody, 4) principal-inertia frame
    body_mass: torch.Tensor  # (nbody,) or per env (B, nbody)
    body_gravcomp: torch.Tensor  # (nbody,) 1.0 = gravity-free
    body_inertia: torch.Tensor  # (nbody, 3) principal moments
    dof_damping: torch.Tensor  # (nv,)
    dof_stiffness: torch.Tensor  # (nv,)
    dof_springref: torch.Tensor  # (nv,)
    dof_armature: torch.Tensor  # (nv,)
    dof_friction: torch.Tensor  # (nv,) dry friction loss (not yet applied)
    dof_limit: torch.Tensor  # (nv, 2) lower/upper (±inf if unlimited)
    drive_kp: torch.Tensor  # (nv,)
    drive_kd: torch.Tensor  # (nv,)
    drive_force_limit: torch.Tensor  # (nv,)
    geom_pos: torch.Tensor  # (ngeom, 3) or per env (B, ngeom, 3), in the body frame
    geom_quat: torch.Tensor  # (ngeom, 4)
    geom_size: torch.Tensor  # (ngeom, 3) or per env (B, ngeom, 3)
    geom_friction: torch.Tensor  # (ngeom,)
    gravity: torch.Tensor  # (3,)

    # ---- solver / integration options ----
    timestep: float = 0.01
    solver_iterations: int = 32
    contact_slop: float = 0.002
    baumgarte: float = 0.2
    max_correction_vel: float = 0.5
    contact_margin: float = 0.01
    max_active_contacts: int = 0
    max_qvel: float = 100.0
    max_impulse: float = 1e4

    body_names: Tuple[str, ...] = ()
    geom_names: Tuple[str, ...] = ()
    mocap_bodies: Optional[np.ndarray] = None  # (M,) i32 dof-less marker bodies

    # body-body 6-dof drives (physics/drives.py): bodies, frames in them,
    # gains (ND, 2) [linear, angular]
    drive6_body1: Optional[np.ndarray] = None
    drive6_body2: Optional[np.ndarray] = None
    drive6_pose1: Optional[torch.Tensor] = None
    drive6_pose2: Optional[torch.Tensor] = None
    drive6_stiffness: Optional[torch.Tensor] = None
    drive6_damping: Optional[torch.Tensor] = None
    drive6_force_limit: Optional[torch.Tensor] = None

    # convex hull proxies (geom type HULL): local vertex clouds padded to
    # HULL_MAX_VERTS by repeating the first vertex, and facet normals;
    # shared (NH, ., 3) or per env (B, NH, ., 3)
    hull_verts: Optional[torch.Tensor] = None  # (NH, MAXV, 3) | (B, NH, MAXV, 3)
    hull_dirs: Optional[torch.Tensor] = None  # (NH, MAXD, 3) | (B, NH, MAXD, 3)
    geom_restitution: Optional[torch.Tensor] = None  # (ngeom,) or (B, ngeom)
    bounce_threshold: float = 2.0
    geom_hull: Optional[np.ndarray] = None  # (ngeom,) i32 hull id or -1

    # host mirrors read at scene-build time (no device->host reads then)
    host_dof_limit: Optional[np.ndarray] = None
    host_body_mass: Optional[np.ndarray] = None
    host_body_gravcomp: Optional[np.ndarray] = None

    def replace(self, **changes):
        """A copy with ``changes``; it keeps this model's device plan
        (``physics/plan.py``) unless a field the plan reads changes."""
        new = dataclasses.replace(self, **changes)
        plan = self.__dict__.get("_plan")
        if plan is not None and not changes.keys() & _PLAN_FIELDS and new.device == plan.device:
            new._plan = plan
        return new

    @property
    def npair(self) -> int:
        return len(self.pair_geom1)

    @property
    def device(self) -> torch.device:
        return self.body_pos.device


@dataclasses.dataclass(eq=False)
class Contact(_Replace):
    """Static-shape contact set; leading axis env batch, second axis contact id."""

    geom1: np.ndarray
    geom2: np.ndarray
    pos: torch.Tensor = None  # (B, C, 3) world contact point
    normal: torch.Tensor = None  # (B, C, 3) unit normal, pushes geom1 out of geom2
    depth: torch.Tensor = None  # (B, C) penetration depth (>0 touching)
    friction: torch.Tensor = None  # (B, C)
    restitution: torch.Tensor = None  # (B, C)
    impulse: torch.Tensor = None  # (B, C, 3) world impulse on body of geom2
    overflow: torch.Tensor = None  # (B,) live candidates dropped by top-K


@dataclasses.dataclass(eq=False)
class Data(_Replace):
    """Per-step simulation state (B = num_envs leading axis)."""

    qpos: torch.Tensor  # (B, nq)
    qvel: torch.Tensor  # (B, nv)
    drive_target: torch.Tensor  # (B, nv)
    drive_vel_target: torch.Tensor  # (B, nv)
    qf_applied: torch.Tensor  # (B, nv)
    xfrc_applied: torch.Tensor  # (B, nbody, 6) [force at COM, torque], world
    xpos: torch.Tensor  # (B, nbody, 3)
    xquat: torch.Tensor  # (B, nbody, 4)
    cvel: torch.Tensor  # (B, nbody, 6) [v_origin, omega], world
    qacc: torch.Tensor  # (B, nv)
    contact: Optional[Contact] = None
    drive6_target: Optional[torch.Tensor] = None  # (B, ND, 7)
    mocap_pose: Optional[torch.Tensor] = None  # (B, M, 7)
    extras: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def batch_size(self) -> int:
        return self.qpos.shape[0]


_STATIC_FIELDS = {
    "body_parent", "body_jnt_type", "body_q_adr", "body_dof_adr", "body_type",
    "geom_body", "geom_type", "pair_geom1", "pair_geom2", "dof_body",
    "dof_is_rot", "dof_limited", "ancestor_mask", "mocap_bodies",
    "drive6_body1", "drive6_body2", "geom_hull", "host_dof_limit",
    "host_body_mass", "host_body_gravcomp",
}
_INT_FIELDS = {"nq", "nv", "nbody", "ngeom", "solver_iterations", "max_active_contacts"}
# the fields ``physics/plan.py`` builds its tables from
_PLAN_FIELDS = {
    "nv", "nbody", "body_parent", "body_jnt_type", "body_q_adr", "body_dof_adr",
    "body_type", "geom_body", "geom_type", "pair_geom1", "pair_geom2", "dof_body",
    "dof_is_rot", "dof_limited", "ancestor_mask", "mocap_bodies", "geom_hull",
    "drive6_body1", "drive6_body2",
}
_FLOAT_FIELDS = {
    "timestep", "contact_slop", "baumgarte", "max_correction_vel",
    "contact_margin", "max_qvel", "max_impulse", "bounce_threshold",
}


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


def model_from_numpy(fields: Mapping[str, Any], device) -> Model:
    """Build a ``Model`` from host values keyed by field name.

    This is the bridge from the JAX package's ``Model`` (read out as numpy)
    to the port's, so tests compare like with like; the port's own builder
    goes through it too. Static topology stays numpy, parameters become
    tensors on ``device``, scalars and name tuples pass through.
    """
    kw = {}
    for f in dataclasses.fields(Model):
        if f.name not in fields:
            continue
        v = fields[f.name]
        if f.name in _INT_FIELDS:
            kw[f.name] = int(v)
        elif f.name in _FLOAT_FIELDS:
            kw[f.name] = float(v)
        elif f.name in ("body_names", "geom_names"):
            kw[f.name] = tuple(v)
        elif v is None:
            kw[f.name] = None
        elif f.name in _STATIC_FIELDS:
            kw[f.name] = np.asarray(v)
        else:
            kw[f.name] = _tensor(v, device)
    return Model(**kw)


def data_from_numpy(fields: Mapping[str, Any], device, contact: Optional[Contact] = None) -> Data:
    """Build a ``Data`` from host arrays keyed by field name (see
    ``model_from_numpy``); ``contact`` is passed through as given."""
    kw = {}
    for f in dataclasses.fields(Data):
        if f.name in ("contact", "extras") or fields.get(f.name) is None:
            continue
        kw[f.name] = _tensor(fields[f.name], device)
    kw["extras"] = {k: _tensor(v, device) for k, v in (fields.get("extras") or {}).items()}
    return Data(contact=contact, **kw)


def make_data(model: Model, batch_size: int, qpos0: Optional[np.ndarray] = None) -> Data:
    """Allocate a fresh batched Data for ``model`` on the model's device."""
    B = batch_size
    dev = model.device
    if qpos0 is None:
        qpos0 = default_qpos(model)
    qpos = torch.as_tensor(np.asarray(qpos0, np.float32), device=dev).expand(B, model.nq).clone()

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    xquat = z(B, model.nbody, 4)
    xquat[..., 0] = 1.0
    drive6 = None
    if model.drive6_body1 is not None:
        drive6 = torch.tensor([0, 0, 0, 1, 0, 0, 0], dtype=torch.float32, device=dev)
        drive6 = drive6.expand(B, len(model.drive6_body1), 7).clone()
    mocap = None
    if model.mocap_bodies is not None:
        mb = torch.as_tensor(np.asarray(model.mocap_bodies, np.int64), device=dev)
        # gathered on the body axis: the tables may carry a leading env axis
        pos = model.body_pos[..., mb, :].expand(B, len(mb), 3)
        quat = model.body_quat[..., mb, :].expand(B, len(mb), 4)
        mocap = torch.cat([pos, quat], -1).clone()
    return Data(
        qpos=qpos,
        qvel=z(B, model.nv),
        drive_target=z(B, model.nv),
        drive_vel_target=z(B, model.nv),
        qf_applied=z(B, model.nv),
        xfrc_applied=z(B, model.nbody, 6),
        xpos=z(B, model.nbody, 3),
        xquat=xquat,
        cvel=z(B, model.nbody, 6),
        qacc=z(B, model.nv),
        contact=None,
        drive6_target=drive6,
        mocap_pose=mocap,
        extras={},
    )


def default_qpos(model: Model) -> np.ndarray:
    """Neutral configuration: identity free-joint quats, zeros elsewhere."""
    qpos = np.zeros(model.nq, np.float32)
    for b in range(model.nbody):
        if model.body_jnt_type[b] == FREE:
            qpos[model.body_q_adr[b] + 3] = 1.0
    return qpos
