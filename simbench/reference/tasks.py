"""Plain reference of one control step of the benchmark's two tasks.

It works a step out again from the state the program held before it (its
``Data``) and the action the benchmark handed to both sides: the controller's
drive targets, the physics substeps, forward kinematics, the task's
evaluation, reward, termination and observation, and in the rgb cells the
camera's frame. The scene's tables (the model and the render mesh) are a
frozen snapshot in ``models/<config>.npz``, and the code is a frozen copy in
``frozen/``: nothing here imports the program or reads a table it made.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .frozen import kinematics as K
from .frozen import rasterizer as R
from .frozen import rotation_conversions as rc
from .frozen import step as S
from .frozen import types as T
from .frozen.batched_rng import BatchedRNG

MODELS = Path(__file__).resolve().parent / "models"


class Scene:
    """The frozen model, render mesh and lights of one configuration."""

    def __init__(self, config_name: str, device):
        z = np.load(MODELS / f"{config_name}.npz", allow_pickle=False)
        fields = {k[len("model."):]: z[k] for k in z.files if k.startswith("model.")}
        self.model = T.model_from_numpy(fields, device)
        self.mesh = R.SceneMesh(
            z["mesh.verts"], z["mesh.faces"], z["mesh.vert_geom"], z["mesh.face_geom"],
            z["mesh.face_color"], z["mesh.face_seg"], device,
        )
        self.lights = [
            {k: (np.asarray(v, np.float32) if k != "kind" else v) for k, v in light.items()}
            for light in json.loads(str(z["lights"]))
        ]
        self.device = torch.device(device)
        names = list(self.model.body_names)
        self.body = {n.split(":")[-1]: i for i, n in enumerate(names)}

    def q_adr(self, body: str) -> int:
        return int(self.model.body_q_adr[self.body[body]])

    def dof_adr(self, body: str) -> int:
        return int(self.model.body_dof_adr[self.body[body]])


def data_from_snapshot(snap: Dict, device) -> T.Data:
    """A frozen ``Data`` from the flat snapshot the harness took of the
    program's state (``simbench.state.snapshot``)."""
    kw = {k[len("data."):]: v.to(device) for k, v in snap.items()
          if k.startswith("data.") and isinstance(v, torch.Tensor)}
    contact = None
    if "contact.geom1" in snap:
        ckw = {k[len("contact."):]: (v.to(device) if isinstance(v, torch.Tensor) else v)
               for k, v in snap.items() if k.startswith("contact.")}
        contact = T.Contact(**ckw)
    extras = {k[len("extras."):]: v.to(device) for k, v in snap.items() if k.startswith("extras.")}
    return T.Data(contact=contact, extras=extras, **kw)


def rows_of(data: T.Data, rows: torch.Tensor) -> T.Data:
    """The envs ``rows`` of a state (every batched tensor, its contact's too)."""
    def pick(v):
        return v[rows] if isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == data.qpos.shape[0] else v

    kw = {f.name: pick(getattr(data, f.name)) for f in dataclasses.fields(data)
          if f.name not in ("contact", "extras")}
    c = data.contact
    if c is not None:
        c = c.replace(**{f.name: pick(getattr(c, f.name)) for f in dataclasses.fields(c)
                         if f.name not in ("geom1", "geom2")})
    return T.Data(contact=c, extras={k: pick(v) for k, v in data.extras.items()},
                  **{k: v for k, v in kw.items()})


def _scale(action, low, high):
    """A normalized action in [-1, 1] mapped onto [low, high]."""
    action = torch.clamp(action, -1.0, 1.0)
    return 0.5 * (high + low) + 0.5 * (high - low) * action


def _set_targets(scene: Scene, data: T.Data, dofs, targets) -> T.Data:
    lims = np.clip(np.asarray(scene.model.host_dof_limit)[dofs], -1e4, 1e4).astype(np.float32)
    lo = torch.as_tensor(lims[:, 0], device=scene.device)
    hi = torch.as_tensor(lims[:, 1], device=scene.device)
    t = data.drive_target.clone()
    t[:, dofs] = torch.minimum(torch.maximum(targets, lo), hi)
    return data.replace(drive_target=t)


def _substeps(scene: Scene, data: T.Data, n: int) -> T.Data:
    for _ in range(n):
        data = S.step(scene.model, data)
    return K.forward_kinematics(scene.model, data)


def _flat(*parts):
    cols = []
    for p in parts:
        p = p.to(torch.float32)
        cols.append(p[:, None] if p.ndim == 1 else p.reshape(p.shape[0], -1))
    return torch.cat(cols, -1)


# ---------------------------------------------------------------------------
# PickCube-v1 with the Panda, pd_joint_delta_pos
# ---------------------------------------------------------------------------
PANDA_ARM = [f"panda_link{i}" for i in range(1, 8)]
PANDA_FINGERS = ["panda_leftfinger", "panda_rightfinger"]
GOAL_THRESH = 0.025


def _pair_force(scene: Scene, data: T.Data, body_a: int, body_b: int) -> torch.Tensor:
    """(B, 3) contact force of body a on body b over the contact set."""
    c = data.contact
    gb = np.asarray(scene.model.geom_body)
    b1, b2 = gb[np.asarray(c.geom1)], gb[np.asarray(c.geom2)]
    sign = np.where((b1 == body_a) & (b2 == body_b), 1.0,
                    np.where((b1 == body_b) & (b2 == body_a), -1.0, 0.0)).astype(np.float32)
    sign_t = torch.as_tensor(sign, device=scene.device)
    return torch.sum(c.impulse * sign_t[None, :, None], 1) / scene.model.timestep


def _angle(x1, x2):
    n1 = x1 / torch.clamp(torch.linalg.vector_norm(x1, dim=-1, keepdim=True), min=1e-9)
    n2 = x2 / torch.clamp(torch.linalg.vector_norm(x2, dim=-1, keepdim=True), min=1e-9)
    return torch.arccos(torch.clamp(torch.sum(n1 * n2, -1), -1.0, 1.0))


def pickcube_step(scene: Scene, pre: T.Data, action: torch.Tensor, elapsed: torch.Tensor,
                  substeps: int, max_episode_steps: int, obs_mode: str) -> Dict:
    """One control step of PickCube-v1 (normalized dense reward); ``obs``
    holds the state obs, or with a camera the obs's agent and extra parts."""
    dev = scene.device
    arm_q = [scene.q_adr(b) for b in PANDA_ARM]
    arm_v = [scene.dof_adr(b) for b in PANDA_ARM]
    fing_v = [scene.dof_adr(b) for b in PANDA_FINGERS]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731

    # the controller: arm deltas in [-0.1, 0.1] on the current joint
    # positions; one gripper value in [-0.01, 0.04] drives both fingers
    a = action.to(torch.float32)
    arm = _scale(a[:, :7], f32([-0.1] * 7), f32([0.1] * 7))
    data = _set_targets(scene, pre, arm_v, pre.qpos[:, arm_q] + arm)
    grip = _scale(a[:, 7:8], f32([-0.01]), f32([0.04]))
    data = _set_targets(scene, data, fing_v, grip.expand(-1, 2) * 1.0 + 0.0)

    data = _substeps(scene, data, substeps)

    out = _pickcube_eval(scene, data, obs_mode)
    out.update(truncated=(elapsed + 1) >= max_episode_steps, qpos=data.qpos, qvel=data.qvel, data=data)
    return out


PANDA_REST = [0.0, math.pi / 8, 0, -math.pi * 5 / 8, 0, math.pi * 3 / 4, math.pi / 4, 0.04, 0.04]


def pickcube_reset(scene: Scene, post: T.Data, seeds: torch.Tensor, obs_mode: str) -> Dict:
    """The episode start of the rows of ``post`` (each drawn from its env's
    episode seed): the Panda at its rest pose with N(0, 0.02) noise on the
    arm, the cube in a 0.1 m square with a random yaw, the goal up to 0.3 m
    above it, velocities and drive targets cleared, then forward
    kinematics and the contact set (no impulses yet)."""
    dev = scene.device
    B = seeds.shape[0]
    rng = BatchedRNG.from_seeds(seeds)
    robot_q = [scene.q_adr(b) for b in PANDA_ARM + PANDA_FINGERS]
    robot_v = [scene.dof_adr(b) for b in PANDA_ARM + PANDA_FINGERS]
    rest = torch.tensor(PANDA_REST, dtype=torch.float32, device=dev)
    mask = torch.ones(9, device=dev)
    mask[-2:] = 0.0
    noise = rng.normal(0.0, 0.02, size=(9,))
    qpos = post.qpos.clone()
    qpos[:, robot_q] = (rest + noise * mask).expand(B, 9)
    target = torch.zeros_like(post.drive_target)
    target[:, robot_v] = qpos[:, robot_q]
    xy = rng.uniform(-0.05, 0.05, (2,)) + torch.zeros(2, device=dev)
    xyz = torch.cat([xy, torch.full_like(xy[:, :1], 0.02)], -1)
    ang = rng.uniform(0.0, 2 * math.pi)
    zeros = torch.zeros_like(ang)
    quat = rc.axis_angle_to_quaternion(torch.stack([zeros, zeros, ang], -1))
    qc = scene.q_adr("cube")
    qpos[:, qc: qc + 7] = torch.cat([xyz, quat], -1)
    gxy = rng.uniform(-0.05, 0.05, (2,)) + torch.zeros(2, device=dev)
    gz = rng.uniform(0.0, 0.3) + xyz[:, 2]
    goal = torch.cat([gxy, gz[:, None], torch.tensor([[1.0, 0, 0, 0]], device=dev).expand(B, 4)], -1)
    data = post.replace(qpos=qpos, qvel=torch.zeros_like(post.qvel), drive_target=target,
                        drive_vel_target=torch.zeros_like(post.drive_vel_target),
                        mocap_pose=goal[:, None], extras={k: torch.zeros_like(v) for k, v in post.extras.items()})
    data = S.forward(scene.model, data)
    out = _pickcube_eval(scene, data, obs_mode)
    out.update(qpos=data.qpos, qvel=data.qvel, data=data)
    return out


def _pickcube_eval(scene: Scene, data: T.Data, obs_mode: str) -> Dict:
    """Evaluation, normalized dense reward and observation of a state."""
    dev = scene.device
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    arm_v = [scene.dof_adr(b) for b in PANDA_ARM]
    fing_v = [scene.dof_adr(b) for b in PANDA_FINGERS]
    robot_q = [scene.q_adr(b) for b in PANDA_ARM + PANDA_FINGERS]
    robot_v = arm_v + fing_v
    cube = scene.body["cube"]
    cube_pose = data.qpos[:, scene.q_adr("cube"): scene.q_adr("cube") + 7]
    goal = data.mocap_pose[:, 0, :3]
    tcp = scene.body["panda_hand_tcp"]
    tcp_pose = torch.cat([data.xpos[:, tcp], data.xquat[:, tcp]], -1)

    flags = []
    for name, closing in zip(PANDA_FINGERS, ([0.0, -1.0, 0.0], [0.0, 1.0, 0.0])):
        b = scene.body[name]
        force = _pair_force(scene, data, b, cube)
        direction = rc.quaternion_apply(data.xquat[:, b], f32(closing))
        flags.append((torch.linalg.vector_norm(force, dim=-1) >= 0.5)
                     & (torch.rad2deg(_angle(direction, force)) <= 85.0))
    is_grasped = flags[0] & flags[1]
    is_placed = torch.linalg.vector_norm(goal - cube_pose[:, :3], dim=1) <= GOAL_THRESH
    qvel = data.qvel[:, robot_v]
    is_static = torch.amax(torch.abs(qvel[:, :-2]), 1) <= 0.2
    success = is_placed & is_static

    tcp_to_obj = torch.linalg.vector_norm(cube_pose[:, :3] - tcp_pose[:, :3], dim=1)
    reward = 1 - torch.tanh(5 * tcp_to_obj)
    grasped = is_grasped.to(torch.float32)
    reward = reward + grasped
    obj_to_goal = torch.linalg.vector_norm(goal - cube_pose[:, :3], dim=1)
    reward = reward + (1 - torch.tanh(5 * obj_to_goal)) * grasped
    static_reward = 1 - torch.tanh(5 * torch.linalg.vector_norm(qvel[:, :-2], dim=1))
    reward = reward + static_reward * is_placed.to(torch.float32)
    reward = torch.where(success, 5.0, reward) / 5

    parts = [data.qpos[:, robot_q], qvel, data.drive_target[:, arm_v], data.drive_target[:, fing_v],
             is_grasped, tcp_pose, goal]
    if obs_mode == "state":
        parts += [cube_pose, cube_pose[:, :3] - tcp_pose[:, :3], goal - cube_pose[:, :3]]
    return dict(obs=_flat(*parts), reward=reward, terminated=success)




# ---------------------------------------------------------------------------
# CartpoleBalanceBenchmark-v1, pd_joint_delta_pos on the slider
# ---------------------------------------------------------------------------
def cartpole_reset(scene: Scene, post: T.Data, seeds: torch.Tensor, obs_mode: str) -> Dict:
    """Not drawn: the cartpole cell runs no reset in its window."""
    raise NotImplementedError("the cartpole cell's episodes outlast the window")


def cartpole_step(scene: Scene, pre: T.Data, action: torch.Tensor, elapsed: torch.Tensor,
                  substeps: int, max_episode_steps: int, obs_mode: str) -> Dict:
    """One control step of CartpoleBalanceBenchmark-v1 (reward mode none)."""
    dev = scene.device
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    slider_q, slider_v = scene.q_adr("cart"), scene.dof_adr("cart")
    hinge_q, hinge_v = scene.q_adr("pole_1"), scene.dof_adr("pole_1")
    delta = _scale(action.to(torch.float32)[:, :1], f32([-1.0]), f32([1.0]))
    data = _set_targets(scene, pre, [slider_v], pre.qpos[:, [slider_q]] + delta)
    data = _substeps(scene, data, substeps)
    pole = scene.body["pole_1"]
    obs = _flat(
        data.qpos[:, [slider_q, hinge_q]], data.qvel[:, [slider_v, hinge_v]],
        data.drive_target[:, [slider_v]],
        data.cvel[:, pole, :3], data.cvel[:, pole, 3:],
    )
    B = pre.qpos.shape[0]
    return dict(
        obs=obs, reward=torch.zeros(B, device=dev),
        terminated=torch.zeros(B, dtype=torch.bool, device=dev),
        truncated=(elapsed + 1) >= max_episode_steps,
        qpos=data.qpos, qvel=data.qvel, data=data,
    )


TASKS = {"pickcube": pickcube_step, "cartpole": cartpole_step}
RESETS = {"pickcube": pickcube_reset, "cartpole": cartpole_reset}


# ---------------------------------------------------------------------------
# the camera
# ---------------------------------------------------------------------------
def camera_rgb(scene: Scene, data: T.Data, camera: Dict, rows: Optional[torch.Tensor] = None):
    """(n, H, W, 3) uint8 frames of the configuration's camera for the
    ``rows`` of ``data`` (every env by default), through the plain tiled
    rasterizer, from the camera's stated eye, target and field of view."""
    xpos, xquat = (data.xpos, data.xquat) if rows is None else (data.xpos[rows], data.xquat[rows])
    gpos, gquat = K.geom_poses_from(scene.model, xpos, xquat)
    wv = scene.mesh.world_vertices(gpos, gquat)
    B = wv.shape[0]
    H, W = int(camera["height"]), int(camera["width"])
    view = torch.as_tensor(R.look_at_matrix(camera["eye"], camera["target"]), dtype=torch.float32,
                           device=scene.device).expand(B, 4, 4)
    proj = torch.as_tensor(R.perspective_matrix(fov_radians(camera["fov"]), W / H, camera["near"], camera["far"]),
                           dtype=torch.float32, device=scene.device)
    buf = R.rasterize(scene.mesh, wv, view, proj, H, W, lights=scene.lights)
    return (torch.clamp(buf["color"], 0, 1) * 255).to(torch.uint8)


def fov_radians(fov) -> float:
    """A field of view given as a number of radians or as ``"pi/2"``."""
    if isinstance(fov, str):
        num, _, den = fov.partition("/")
        return (math.pi if num.strip() == "pi" else float(num)) / (float(den) if den else 1.0)
    return float(fov)
