"""Scripted motion-planning solutions (counterpart of
maniskill_tpu/examples/motionplanning/solutions.py). Batched: one scripted
pass steers every env of the batch, each toward its own goal poses.

Each solution returns the last env step's (obs, reward, terminated,
truncated, info).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...structs.pose import Pose
from ...utils.geometry import rotation_conversions as rc
from .panda_solver import PandaMotionPlanningSolver, device_vector


def _pose(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, q.expand(p.shape[:-1] + (4,))], -1)


def _add(p: torch.Tensor, cols, value) -> torch.Tensor:
    out = p.clone()
    out[:, cols] = out[:, cols] + value
    return out


def _set(p: torch.Tensor, cols, value) -> torch.Tensor:
    out = p.clone()
    out[:, cols] = value
    return out


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-8)


def _yawed_down_q(yaw: torch.Tensor, down_q: torch.Tensor) -> torch.Tensor:
    """The top-down grasp with the closing axis turned by ``yaw`` (B,) about
    world z: (B, 4)."""
    zero = torch.zeros_like(yaw)
    qz = torch.stack([torch.cos(yaw / 2), zero, zero, torch.sin(yaw / 2)], -1)
    return rc.quaternion_multiply(qz, down_q.expand(qz.shape))


def _yaw_of(q: torch.Tensor) -> torch.Tensor:
    """The yaw (B,) of wxyz quaternions (B, 4)."""
    return torch.atan2(2 * (q[:, 0] * q[:, 3] + q[:, 1] * q[:, 2]), 1 - 2 * (q[:, 2] ** 2 + q[:, 3] ** 2))


def _cube_yaw(q: torch.Tensor) -> torch.Tensor:
    """A cube's yaw folded to the nearest face-aligned grip angle in
    [-pi/4, pi/4)."""
    return (_yaw_of(q) + math.pi / 4) % (math.pi / 2) - math.pi / 4


def _x_offset(dx, like: torch.Tensor) -> Pose:
    """Poses (B,) that shift by ``dx`` (a float or (B,)) along their x axis,
    made on ``like``'s device with no host copy."""
    p = torch.zeros(like.shape[0], 3, device=like.device)
    if isinstance(dx, torch.Tensor):
        p[:, 0] = dx
    else:
        p[:, 0:1].fill_(dx)
    q = torch.zeros(like.shape[0], 4, device=like.device)
    q[:, 0:1].fill_(1.0)
    return Pose(torch.cat([p, q], -1))


def solve_push_cube(env, debug: bool = False):
    """Park behind the cube, then push it through the goal."""
    base = env.unwrapped
    mp = PandaMotionPlanningSolver(env)
    down = mp.down_q
    mp.close_gripper(steps=3)
    cube_p = base.obj.pose.p
    goal_p = base.goal_region.pose.p
    push_dir = _unit(goal_p[:, :2] - cube_p[:, :2])
    lift = 0.02
    behind = _add(_add(cube_p, slice(0, 2), -push_dir * 0.08), 2, lift)
    mp.move_to_pose(_pose(behind, down), refine_steps=4)
    reach = torch.linalg.vector_norm(goal_p[:, :2] - cube_p[:, :2], dim=-1, keepdim=True)
    through = _add(_add(cube_p, slice(0, 2), push_dir * reach), 2, lift)
    return mp.move_to_pose(_pose(through, down), refine_steps=6)


def solve_pick_cube(env, debug: bool = False):
    """Hover, descend, grasp, carry the cube to the goal."""
    base = env.unwrapped
    mp = PandaMotionPlanningSolver(env)
    down = mp.down_q
    mp.open_gripper(steps=3)
    cube_p = base.cube.pose.p
    mp.move_to_pose(_pose(_add(cube_p, 2, 0.08), down), refine_steps=3)
    mp.move_to_pose(_pose(_add(cube_p, 2, 0.015), down), refine_steps=5)
    mp.close_gripper(steps=8)
    return mp.move_to_pose(_pose(base.goal_site.pose.p, down), refine_steps=10)


def solve_pull_cube(env, debug: bool = False):
    """Hook behind the cube with a closed gripper and drag it onto the
    goal."""
    base = env.unwrapped
    mp = PandaMotionPlanningSolver(env)
    down = mp.down_q
    mp.close_gripper(steps=3)
    cube_p = base.obj.pose.p
    goal_p = base.goal_region.pose.p
    d = _unit(goal_p[:, :2] - cube_p[:, :2])
    mp.move_to_pose(_pose(_set(_add(cube_p, slice(0, 2), -d * 0.06), 2, 0.10), down), refine_steps=2)
    mp.move_to_pose(_pose(_set(_add(cube_p, slice(0, 2), -d * 0.055), 2, 0.02), down), refine_steps=3)
    target = _set(_add(goal_p, slice(0, 2), -d * 0.04), 2, 0.02)
    return mp.move_to_pose(_pose(target, down), refine_steps=6)


def solve_stack_cube(env, debug: bool = False):
    """Grasp A, lift, align above B by the grasp's measured offset, let go."""
    base = env.unwrapped
    mp = PandaMotionPlanningSolver(env)
    down = mp.down_q
    mp.open_gripper(steps=3)
    a_p = base.cubeA.pose.p
    mp.move_to_pose(_pose(_add(a_p, 2, 0.08), down), refine_steps=3)
    mp.move_to_pose(_pose(_add(a_p, 2, 0.015), down), refine_steps=5)
    mp.close_gripper(steps=8)
    mp.move_to_pose(_pose(_set(a_p, 2, 0.12), down), refine_steps=3)
    # move the TCP by (B's top - A now)
    target_a = _add(base.cubeB.pose.p, 2, 0.04 + 0.001)
    place = base.agent.tcp.pose.p + (target_a - base.cubeA.pose.p)
    mp.move_to_pose(_pose(place, down), refine_steps=6)
    return mp.open_gripper(steps=6)


def solve_place_sphere(env, debug: bool = False):
    """Pick the sphere and set it into the bin."""
    base = env.unwrapped
    mp = PandaMotionPlanningSolver(env)
    down = mp.down_q
    mp.open_gripper(steps=3)
    r = float(base.radius)
    s_p = base.obj.pose.p
    mp.move_to_pose(_pose(_add(s_p, 2, 0.08), down), refine_steps=3)
    mp.move_to_pose(_pose(_set(s_p, 2, r + 0.002), down), refine_steps=5)
    mp.close_gripper(steps=8)
    mp.move_to_pose(_pose(_set(s_p, 2, 0.12), down), refine_steps=3)
    drop = _add(base.bin.pose.p, 2, float(base.block_half_size[0]) + r + 0.02)
    mp.move_to_pose(_pose(drop, down), refine_steps=6)
    return mp.open_gripper(steps=8)


def solve_stack_pyramid(env, debug: bool = False):
    """Put A flush beside B, then C on top of both. Grasps align with each
    cube's faces; placements hover above the target before descending, so
    the neighbours are not clipped on the way."""
    base = env.unwrapped
    mp = PandaMotionPlanningSolver(env)
    half = 0.02

    # 1) grasp A face-aligned
    mp.open_gripper(steps=3)
    a_p = base.cubeA.pose.p
    qa = _yawed_down_q(_cube_yaw(base.cubeA.pose.q), mp.down_q)
    mp.move_to_pose(_pose(_add(a_p, 2, 0.08), qa), refine_steps=3)
    mp.move_to_pose(_pose(_add(a_p, 2, 0.015), qa), refine_steps=5)
    mp.close_gripper(steps=8)
    mp.move_to_pose(_pose(_set(a_p, 2, 0.12), qa), refine_steps=2)

    # 2) drop A with ~0.8 cm of clearance beside B, then push it flush (the
    # push stops against B's face, which removes the drop's spread)
    b_p = base.cubeB.pose.p
    a_now = base.cubeA.pose.p
    d = _unit(a_now[:, :2] - b_p[:, :2])
    target_a = _set(_add(b_p, slice(0, 2), d * (2 * half + 0.008)), 2, half + 0.001)
    hover = base.agent.tcp.pose.p + (target_a - a_now)
    mp.move_to_pose(_pose(_add(hover, 2, 0.05), qa), refine_steps=3)
    place = base.agent.tcp.pose.p + (target_a - base.cubeA.pose.p)
    mp.move_to_pose(_pose(place, qa), refine_steps=6)
    mp.open_gripper(steps=5)
    mp.move_to_pose(_pose(_add(base.agent.tcp.pose.p, 2, 0.10), qa), refine_steps=2)

    # the push: the closed gripper behind A (away from B), toward B until the
    # faces touch
    mp.close_gripper(steps=3)
    a_now = base.cubeA.pose.p
    d2 = a_now[:, :2] - base.cubeB.pose.p[:, :2]
    dist = torch.linalg.vector_norm(d2, dim=-1, keepdim=True)
    d2n = d2 / (dist + 1e-8)
    behind = _set(_add(a_now, slice(0, 2), d2n * 0.052), 2, half)
    mp.move_to_pose(_pose(_set(behind, 2, 0.09), qa), refine_steps=2)
    mp.move_to_pose(_pose(behind, qa), refine_steps=3)
    push_to = _add(behind, slice(0, 2), -d2n * (dist - (2 * half + 0.001)))
    mp.move_to_pose(_pose(push_to, qa), refine_steps=5)
    mp.move_to_pose(_pose(_set(push_to, 2, 0.12), qa), refine_steps=2)
    mp.open_gripper(steps=3)

    # 3) grasp C face-aligned, hover over the A-B seam, descend, let go
    c_p = base.cubeC.pose.p
    qc = _yawed_down_q(_cube_yaw(base.cubeC.pose.q), mp.down_q)
    mp.move_to_pose(_pose(_add(c_p, 2, 0.08), qc), refine_steps=3)
    mp.move_to_pose(_pose(_add(c_p, 2, 0.015), qc), refine_steps=5)
    mp.close_gripper(steps=8)
    mp.move_to_pose(_pose(_set(c_p, 2, 0.14), qc), refine_steps=2)
    mid = (base.cubeA.pose.p[:, :2] + base.cubeB.pose.p[:, :2]) / 2
    target_c = torch.cat([mid, torch.full_like(mid[:, :1], 3 * half + 0.002)], -1)
    hover_c = base.agent.tcp.pose.p + (target_c - base.cubeC.pose.p)
    mp.move_to_pose(_pose(_add(hover_c, 2, 0.05), qc), refine_steps=3)
    place_c = base.agent.tcp.pose.p + (target_c - base.cubeC.pose.p)
    mp.move_to_pose(_pose(place_c, qc), refine_steps=6)
    return mp.open_gripper(steps=8)


def solve_lift_peg_upright(env, debug: bool = False):
    """Grasp the lying peg across its axis, lift, turn the wrist 90 degrees
    so the peg points up, lower it to the table, let go."""
    base = env.unwrapped
    mp = PandaMotionPlanningSolver(env)
    down = mp.down_q
    mp.open_gripper(steps=3)
    hl = float(base.peg_half_length)
    peg_p = base.peg.pose.p
    hover = torch.cat([peg_p[:, :2], torch.full_like(peg_p[:, :1], 0.10)], -1)
    mp.move_to_pose(_pose(hover, down), refine_steps=3)
    grasp = _set(hover, 2, float(base.peg_half_width) + 0.005)
    mp.move_to_pose(_pose(grasp, down), refine_steps=5)
    mp.close_gripper(steps=8)
    # high enough for the peg to clear the table when vertical
    lifted = _set(grasp, 2, hl + 0.10)
    mp.move_to_pose(_pose(lifted, down), refine_steps=4)
    # +90 degrees about world y: the peg's +x turns to -z; this drives joint
    # 6 toward its wide upper limit (-90 would hit its lower limit at 0)
    tilt = device_vector((math.cos(math.pi / 4), 0.0, math.sin(math.pi / 4), 0.0), peg_p.device)
    q_up = rc.quaternion_multiply(tilt.expand(peg_p.shape[0], 4), down.expand(peg_p.shape[0], 4))
    # tracked as a Cartesian arc: one far IK target stalls at the limits
    mp.move_to_pose(_pose(lifted, q_up), steps=60, refine_steps=6, arc_steps=6)
    mp.move_to_pose(_pose(_set(lifted, 2, hl + 0.01), q_up), refine_steps=6)
    return mp.open_gripper(steps=8)


def solve_pull_cube_tool(env, debug: bool = False):
    """Grasp the L tool's handle, sweep its hook behind the cube beyond
    reach, and drag the cube in."""
    base = env.unwrapped
    mp = PandaMotionPlanningSolver(env)
    down = mp.down_q
    mp.open_gripper(steps=3)
    hl, h, w = float(base.handle_length), float(base.height), float(base.width)
    tool_p = base.l_shape_tool.pose.p
    # the handle near its base; the tool's centre is at z = h/2
    grip = _set(_add(tool_p, 0, 0.02), 2, h / 2 + 0.005)
    mp.move_to_pose(_pose(_set(grip, 2, 0.10), down), refine_steps=3)
    mp.move_to_pose(_pose(grip, down), refine_steps=5)
    mp.close_gripper(steps=8)
    mp.move_to_pose(_pose(_set(grip, 2, 0.10), down), refine_steps=2)

    cube_p = base.cube.pose.p
    # the hook's -x face sits at tool origin + (hl - hook length); park it
    # ~0.04 beyond the cube's centre (the TCP rides 0.02 ahead of the origin)
    hook_clear = hl - float(base.hook_length) - 0.02
    tcp_x = cube_p[:, 0] + 0.04 - hook_clear
    # the hook spans tool-local y in [0, 2w]: centre it on the cube
    tcp_y = cube_p[:, 1] - w
    hook_hi = torch.stack([tcp_x, tcp_y, torch.full_like(tcp_x, 0.12)], -1)
    mp.move_to_pose(_pose(hook_hi, down), refine_steps=3)
    hook_lo = _set(hook_hi, 2, h / 2 + 0.005)
    mp.move_to_pose(_pose(hook_lo, down), refine_steps=4)
    # drag back toward the robot's base
    return mp.move_to_pose(_pose(_add(hook_lo, 0, -0.35), down), steps=80, refine_steps=8)


def ycb_grasp_geometry(base):
    """Per-env grasp parameters of PickSingleYCB's objects from their cooked
    hulls, as host arrays: (yaw (B,), hull centre (B, 3), grasp height (B,),
    world top (B,)), each float32. The hull clouds (the model's per-env
    table) move to the world on the device; the one read of them and the
    horizontal PCA are host numpy, once per solve."""
    geom_hull = np.asarray(base.scene.model.geom_hull)
    hids = geom_hull[base.obj.geom_ids]
    hids = hids[hids >= 0]
    # the object's hull slots are consecutive: a slice, so no index copy
    assert (np.diff(hids) == 1).all(), hids
    hv = base.scene.model.hull_verts[:, int(hids[0]):int(hids[-1]) + 1]  # (B, K, V, 3)
    B = hv.shape[0]
    pts_l = hv.reshape(B, -1, 3)
    pose = base.obj.pose.raw_pose[:, None]  # (B, 1, 7)
    pts_w = (pose[..., :3] + rc.quaternion_apply(pose[..., 3:], pts_l)).cpu().numpy()
    ztop = pts_w[..., 2].max(axis=1)
    # the long horizontal axis: the hand's x goes along it, so the closing
    # axis (hand y) crosses the narrow extent
    xy = pts_w[..., :2] - pts_w[..., :2].mean(axis=1, keepdims=True)
    cov = np.einsum("bni,bnj->bij", xy, xy) / xy.shape[1]
    _, evecs = np.linalg.eigh(cov)  # ascending
    long_axis = evecs[..., -1]
    yaw = np.arctan2(long_axis[:, 1], long_axis[:, 0]).astype(np.float32)
    gz = np.clip(0.55 * ztop, 0.015, 0.055).astype(np.float32)
    return yaw, pts_w.mean(axis=1).astype(np.float32), gz, ztop.astype(np.float32)


def solve_pick_single_ycb(env, debug: bool = False):
    """A geometry-aware top-down grasp of each env's YCB object (closing
    across its narrow horizontal extent, low enough to fit the fingers'
    span), then carry it to the goal site and hold still. The reference has
    no scripted solution for this task; the flow mirrors PickCube's."""
    base = env.unwrapped
    mp = PandaMotionPlanningSolver(env)
    mp.open_gripper(steps=3)
    yaw, ctr, gz, ztop = ycb_grasp_geometry(base)
    # one host-to-device copy of every per-env number
    g = torch.as_tensor(np.concatenate([yaw[:, None], ctr, gz[:, None], ztop[:, None]], 1),
                        device=base.device)
    grasp_q = _yawed_down_q(g[:, 0], mp.down_q)
    grasp = torch.cat([g[:, 1:3], g[:, 4:5]], -1)
    mp.move_to_pose(_pose(_set(grasp, 2, g[:, 5] + 0.08), grasp_q), refine_steps=3)
    mp.move_to_pose(_pose(grasp, grasp_q), refine_steps=5)
    mp.close_gripper(steps=10)
    # lift straight up before translating (clears the table for tall goals)
    mp.move_to_pose(_pose(_add(grasp, 2, 0.10), grasp_q), refine_steps=2)
    # carry by the measured grasp offset so the object's centre lands on the
    # goal site; then measure once more (heavy objects sag in the grip)
    goal_p = base.goal_site.pose.p
    place = base.agent.tcp.pose.p + (goal_p - base.obj.pose.p)
    mp.move_to_pose(_pose(place, grasp_q), refine_steps=6)
    place = base.agent.tcp.pose.p + (goal_p - base.obj.pose.p)
    return mp.move_to_pose(_pose(place, grasp_q), steps=20, refine_steps=8)



def solve_peg_insertion_side(env, debug: bool = False):
    """Grasp the peg toward its tail, carry it in front of the hole, correct
    its residual error three times, and push it in."""
    base = env.unwrapped
    mp = PandaMotionPlanningSolver(env, joint_vel_limit=0.9)
    mp.open_gripper(steps=3)

    L = base.peg_half_sizes[:, 0]
    r = base.peg_half_sizes[:, 2]
    peg0 = base.peg.pose
    yaw = _yaw_of(peg0.q)
    grasp_q = _yawed_down_q(yaw, mp.down_q)
    # grip toward the tail so that the head stays clear for the insertion
    off = torch.clamp(L / 2 + 0.01, min=0.05)
    dirx = torch.stack([torch.cos(yaw), torch.sin(yaw)], -1)
    gxy = peg0.p[:, :2] - dirx * off[:, None]
    mp.move_to_pose(_pose(torch.cat([gxy, torch.full_like(gxy[:, :1], 0.10)], -1), grasp_q), refine_steps=3)
    mp.move_to_pose(_pose(torch.cat([gxy, r[:, None]], -1), grasp_q), refine_steps=5)
    mp.close_gripper(steps=8)

    # lift, then carry the peg in front of the hole, head toward the block:
    # desired tcp = goal * Off(-d) * peg^-1 * tcp (Off along the goal's x:
    # -x is out of the hole)
    tcp0 = base.agent.tcp.pose
    peg_now = base.peg.pose
    goal = base.goal_pose
    lift = torch.zeros_like(tcp0.raw_pose)
    lift[:, 2:3].fill_(0.06)
    lift[:, 3:4].fill_(1.0)
    mp.move_to_pose((Pose(lift) * tcp0).raw_pose, refine_steps=3)
    out = _x_offset(-0.01 - L, L[:, None])
    pre = goal * out * peg_now.inv() * base.agent.tcp.pose
    mp.move_to_pose(pre.raw_pose, steps=80, refine_steps=6, arc_steps=6)
    # re-measure the peg's residual error and correct it
    for _ in range(3):
        pre = goal * out * base.peg.pose.inv() * base.agent.tcp.pose
        mp.move_to_pose(pre.raw_pose, steps=30, refine_steps=4)
    push = goal * _x_offset(0.02, L[:, None]) * base.peg.pose.inv() * base.agent.tcp.pose
    return mp.move_to_pose(push.raw_pose, steps=40, refine_steps=8)


def solve_plug_charger(env, debug: bool = False):
    """Grasp the charger's base, align it with the receptacle's slots, and
    insert it in stages, re-measuring between them."""
    base = env.unwrapped
    mp = PandaMotionPlanningSolver(env, joint_vel_limit=0.6)
    mp.open_gripper(steps=3)

    ch0 = base.charger.pose
    grasp_q = _yawed_down_q(_yaw_of(ch0.q), mp.down_q)
    bz = base._base_size[2]
    # the base's centre, not the charger's origin (which sits on the
    # base-peg boundary): fingers closing there hold the base on full pads
    base_off = torch.zeros_like(ch0.p)
    base_off[:, 0:1].fill_(-base._base_size[0])
    grasp = _set(ch0.p + rc.quaternion_apply(ch0.q, base_off), 2, bz)
    # pass above the floating receptacle before descending
    mp.move_to_pose(_pose(_set(grasp, 2, 0.20), grasp_q), refine_steps=2)
    mp.move_to_pose(_pose(_set(grasp, 2, 0.08), grasp_q), refine_steps=3)
    mp.move_to_pose(_pose(grasp, grasp_q), refine_steps=5)
    mp.close_gripper(steps=8)

    goal = base.goal_pose
    like = ch0.p

    def align(dx, steps, refine):
        tgt = goal * _x_offset(dx, like) * base.charger.pose.inv() * base.agent.tcp.pose
        return mp.move_to_pose(tgt.raw_pose, steps=steps, refine_steps=refine)

    pre = goal * _x_offset(-0.05, like) * base.charger.pose.inv() * base.agent.tcp.pose
    mp.move_to_pose(pre.raw_pose, steps=60, refine_steps=4, arc_steps=6)
    align(-0.05, steps=20, refine=4)
    # staged insertion: each stage corrects the residual the last one left
    mp.joint_vel_limit = 0.2
    align(-0.02, steps=20, refine=4)
    align(-0.008, steps=15, refine=4)
    return align(0.003, steps=30, refine=10)


def _trace_polyline(mp, pts_xy: torch.Tensor, draw_z: float, steps_per_seg: int = 20, hover: bool = True):
    """Drive the stick tip along a 2D polyline (B, N, 2) on the canvas.
    ``hover=False`` keeps the tip down when the caller has already descended
    onto the start: the hover move would lift it over the first points."""
    down = mp.down_q
    if hover:
        mp.move_to_pose(_pose(_at_height(pts_xy[:, 0], draw_z + 0.05), down), refine_steps=3)
    result = None
    for s in range(pts_xy.shape[1]):
        result = mp.move_to_pose(_pose(_at_height(pts_xy[:, s], draw_z), down), steps=steps_per_seg)
    return result


def _at_height(xy: torch.Tensor, z: float) -> torch.Tensor:
    """(B, 2) points lifted to height ``z``: (B, 3)."""
    return torch.cat([xy, torch.full_like(xy[:, :1], z)], -1)


def _triangle_waypoints(verts: torch.Tensor, n_sub: int = 8) -> torch.Tensor:
    """v0 -> v1 -> v2 -> v0 of (B, 3, 2) vertices, each edge cut in
    ``n_sub`` so the tip passes within THRESHOLD of every reference point:
    (B, 3 * n_sub, 2)."""
    segs = []
    for e in range(3):
        a, b = verts[:, e], verts[:, (e + 1) % 3]
        for k in range(n_sub):
            segs.append(a + (b - a) * ((k + 1) / n_sub))
    return torch.stack(segs, 1)


def _descend_onto(mp, xy: torch.Tensor, draw_z: float):
    """Hover above ``xy`` (B, 2), then touch the canvas there."""
    mp.move_to_pose(_pose(_at_height(xy, draw_z + 0.05), mp.down_q), refine_steps=2)
    mp.move_to_pose(_pose(_at_height(xy, draw_z), mp.down_q), refine_steps=2)


def solve_draw_triangle(env, debug: bool = False):
    """Trace the triangle's three edges with the tip on the canvas."""
    base = env.unwrapped
    mp = PandaMotionPlanningSolver(env, joint_vel_limit=0.7)
    verts = base.scene.data.extras["tri_verts"][:, :, :2]  # (B, 3, 2)
    draw_z = base.CANVAS_THICKNESS + base.DOT_THICKNESS
    _descend_onto(mp, verts[:, 0], draw_z)
    # already touching at v0: trace without the hover, so the tip drags over
    # the first edge's early reference points
    return _trace_polyline(mp, _triangle_waypoints(verts), draw_z, steps_per_seg=6, hover=False)


def solve_draw_svg(env, debug: bool = False):
    """Trace the target polyline with the tip on the canvas."""
    base = env.unwrapped
    mp = PandaMotionPlanningSolver(env, joint_vel_limit=0.7)
    # every third reference point: consecutive waypoints stay within
    # THRESHOLD of the points between them
    pts = base.scene.data.extras["svg_points"][:, ::3]
    draw_z = base.CANVAS_THICKNESS + base.DOT_THICKNESS
    _descend_onto(mp, pts[:, 0], draw_z)
    return _trace_polyline(mp, pts, draw_z, steps_per_seg=4)


SOLUTIONS = {
    "PushCube-v1": solve_push_cube,
    "PickCube-v1": solve_pick_cube,
    "PullCube-v1": solve_pull_cube,
    "StackCube-v1": solve_stack_cube,
    "PlaceSphere-v1": solve_place_sphere,
    "StackPyramid-v1": solve_stack_pyramid,
    "LiftPegUpright-v1": solve_lift_peg_upright,
    "PullCubeTool-v1": solve_pull_cube_tool,
    "PegInsertionSide-v1": solve_peg_insertion_side,
    "PlugCharger-v1": solve_plug_charger,
    "DrawTriangle-v1": solve_draw_triangle,
    "DrawSVG-v1": solve_draw_svg,
    "PickSingleYCB-v1": solve_pick_single_ycb,
}
