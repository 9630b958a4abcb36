"""Procedural RoboCasa kitchen fixture library (counterpart of
maniskill_tpu/scene_builder/robocasa/fixtures.py).

Every fixture is authored procedurally at RoboCasa's nominal dimensions, so
the kitchen builds with no assets on disk. Appliance doors and drawers are
articulations (hinge or prismatic joints with damping and limits), so
open-door tasks act on real joints.

All builders take ``pos`` = (x, y) of the fixture's front-centre on the
floor and ``yaw`` (z-rotation), and return the created Actor or
Articulation. Counters are 0.92 m high x 0.6 m deep, uppers at 1.45 m,
appliances at US standard sizes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ...building.articulation_builder import (
    ArticulationBuilder,
    LinkSpec,
    ShapeSpec,
)
from ...physics.types import BOX, CYLINDER, HINGE, SLIDE

# palette
WOOD = (0.55, 0.42, 0.30, 1.0)
PANEL = (0.82, 0.80, 0.76, 1.0)
TOP = (0.35, 0.35, 0.38, 1.0)
STEEL = (0.68, 0.70, 0.72, 1.0)
DARK = (0.15, 0.15, 0.15, 1.0)
WHITE = (0.92, 0.92, 0.92, 1.0)

COUNTER_H = 0.92
COUNTER_D = 0.60
TOP_T = 0.03  # countertop thickness


def _quat_z(yaw):
    return np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)])


def _pose(pos, yaw, z):
    return np.concatenate([[pos[0], pos[1], z], _quat_z(yaw)])


def _box(hs, pos, color, fric=0.6):
    return ShapeSpec(BOX, hs, pos, friction=fric, color=color)


def build_counter(scene, name, pos, yaw=0.0, width=0.9, depth=COUNTER_D,
                  color=WOOD):
    """Counter base cabinet + countertop slab (fixtures/counter.py analog)."""
    b = scene.create_actor_builder()
    hw, hd = width / 2, depth / 2
    body_h = (COUNTER_H - TOP_T) / 2
    b.add_box_collision([0, 0, body_h], half_size=[hd - 0.02, hw, body_h],
                        friction=0.6)
    b.add_box_visual([0, 0, body_h], half_size=[hd - 0.02, hw, body_h],
                     color=color)
    top_z = COUNTER_H - TOP_T / 2
    b.add_box_collision([0, 0, top_z], half_size=[hd, hw, TOP_T / 2],
                        friction=0.8)
    b.add_box_visual([0, 0, top_z], half_size=[hd, hw, TOP_T / 2], color=TOP)
    b.set_initial_pose(_pose(pos, yaw, 0.0))
    return b.build_static(name)


def build_cabinet(scene, name, pos, yaw=0.0, width=0.6, height=0.7,
                  depth=COUNTER_D, z=0.0, door="left", color=PANEL):
    """Single-door hinged cabinet (fixtures/cabinet.py SingleCabinet).

    ``door``: "left" | "right" hinge side. z = bottom height (0 for base
    cabinets, ~1.4 for uppers)."""
    hw, hh, hd = width / 2, height / 2, depth / 2
    t = 0.018
    b = ArticulationBuilder(scene)
    b.disable_self_collisions = True
    shell = [
        _box((hd, hw, t), (0, 0, hh - t), color),
        _box((hd, hw, t), (0, 0, -hh + t), color),
        _box((hd, t, hh), (0, -hw + t, 0), color),
        _box((hd, t, hh), (0, hw - t, 0), color),
        _box((t, hw, hh), (-hd + t, 0, 0), color),
        _box((hd, hw, t), (0, 0, 0), color),  # mid shelf
    ]
    b.add_link(LinkSpec("body", None, collisions=shell, visuals=shell))
    side = -1.0 if door == "left" else 1.0
    panel = [
        _box((t, hw - t, hh - t), (0, -side * (hw - t), 0), color),
        _box((0.02, 0.012, 0.06), (0.035, -side * (2 * hw - 0.1), 0), DARK),
    ]
    b.add_link(
        LinkSpec("door", "body", HINGE, f"{name}_door_joint",
                 origin_pos=(hd, side * hw, 0), axis=(0, 0, side),
                 limit=(0.0, 2.3), damping=2.0, frictionloss=0.5,
                 collisions=panel, visuals=panel)
    )
    b.set_initial_pose(_pose(pos, yaw, z + hh))
    b.fix_root_link = True
    return b.build(name)


def build_drawer_stack(scene, name, pos, yaw=0.0, width=0.6, n_drawers=3,
                       color=PANEL):
    """Stack of prismatic drawers under a countertop (cabinet.py Drawer)."""
    hw, hd = width / 2, COUNTER_D / 2
    h = COUNTER_H - TOP_T
    dh = h / n_drawers / 2
    t = 0.018
    b = ArticulationBuilder(scene)
    b.disable_self_collisions = True
    shell = [
        _box((hd, t, h / 2), (0, -hw + t, 0), color),
        _box((hd, t, h / 2), (0, hw - t, 0), color),
        _box((t, hw, h / 2), (-hd + t, 0, 0), color),
        _box((hd, hw, t), (0, 0, h / 2 - t), color),
    ]
    b.add_link(LinkSpec("body", None, collisions=shell, visuals=shell))
    for k in range(n_drawers):
        zc = -h / 2 + (2 * k + 1) * dh
        bin_ = [
            _box((hd - 0.03, hw - 0.04, dh - 0.02), (0, 0, 0), color),
            _box((0.02, 0.06, 0.012), (hd + 0.01, 0, dh * 0.4), DARK),
        ]
        b.add_link(
            LinkSpec(f"drawer_{k}", "body", SLIDE, f"{name}_drawer_{k}_joint",
                     origin_pos=(0, 0, zc), axis=(1, 0, 0),
                     limit=(0.0, 0.4), damping=8.0, frictionloss=1.0,
                     collisions=bin_, visuals=bin_)
        )
    b.set_initial_pose(_pose(pos, yaw, h / 2))
    b.fix_root_link = True
    return b.build(name)


def build_sink(scene, name, pos, yaw=0.0, width=0.76):
    """Counter segment with a recessed basin + faucet (fixtures/sink.py)."""
    b = scene.create_actor_builder()
    hw, hd = width / 2, COUNTER_D / 2
    body_h = (COUNTER_H - TOP_T) / 2
    b.add_box_collision([0, 0, body_h], half_size=[hd - 0.02, hw, body_h],
                        friction=0.6)
    b.add_box_visual([0, 0, body_h], half_size=[hd - 0.02, hw, body_h],
                     color=WOOD)
    # basin: floor + 4 rim walls recessed below counter height
    bw, bd, depth = 0.28, 0.20, 0.12
    z_top = COUNTER_H
    b.add_box_collision([0, 0, z_top - depth], half_size=[bd, bw, 0.01],
                        friction=0.8)
    b.add_box_visual([0, 0, z_top - depth], half_size=[bd, bw, 0.01],
                     color=STEEL)
    for dx, dy, hx, hy in ((bd, 0, 0.02, bw + 0.04), (-bd, 0, 0.02, bw + 0.04),
                           (0, bw, bd, 0.02), (0, -bw, bd, 0.02)):
        b.add_box_collision([dx, dy, z_top - depth / 2],
                            half_size=[hx, hy, depth / 2], friction=0.8)
        b.add_box_visual([dx, dy, z_top - depth / 2],
                         half_size=[hx, hy, depth / 2], color=STEEL)
    # countertop border around the basin
    for dx, hx in ((hd - (hd - bd - 0.04) / 2, (hd - bd - 0.04) / 2),
                   (-(hd - (hd - bd - 0.04) / 2), (hd - bd - 0.04) / 2)):
        b.add_box_collision([dx, 0, z_top - TOP_T / 2],
                            half_size=[hx, hw, TOP_T / 2], friction=0.8)
        b.add_box_visual([dx, 0, z_top - TOP_T / 2],
                         half_size=[hx, hw, TOP_T / 2], color=TOP)
    for dy in (hw - (hw - bw - 0.04) / 2, -(hw - (hw - bw - 0.04) / 2)):
        b.add_box_collision([0, dy, z_top - TOP_T / 2],
                            half_size=[bd + 0.04, (hw - bw - 0.04) / 2,
                                       TOP_T / 2], friction=0.8)
        b.add_box_visual([0, dy, z_top - TOP_T / 2],
                         half_size=[bd + 0.04, (hw - bw - 0.04) / 2,
                                    TOP_T / 2], color=TOP)
    # faucet: vertical + horizontal spout cylinders at the back rim
    b.add_cylinder_collision([-bd - 0.05, 0, z_top + 0.12], radius=0.015,
                             half_length=0.12, friction=0.5)
    b.add_cylinder_visual([-bd - 0.05, 0, z_top + 0.12], radius=0.015,
                          half_length=0.12, color=STEEL)
    b.set_initial_pose(_pose(pos, yaw, 0.0))
    return b.build_static(name)


def build_stove(scene, name, pos, yaw=0.0, width=0.76):
    """Range: body + 4 burners + articulated oven door (fixtures/stove.py)."""
    hw, hd = width / 2, COUNTER_D / 2
    b = ArticulationBuilder(scene)
    b.disable_self_collisions = True
    body_h = COUNTER_H / 2
    shapes = [
        _box((hd, hw, body_h - 0.01), (0, 0, 0), STEEL),
        _box((hd, hw, 0.01), (0, 0, body_h), DARK),  # cooktop
    ]
    for bx, by in ((0.12, 0.16), (0.12, -0.16), (-0.12, 0.16), (-0.12, -0.16)):
        shapes.append(ShapeSpec(CYLINDER, [0.09, 0.008, 0],
                                (bx, by, body_h + 0.012), friction=0.9,
                                color=DARK))
    b.add_link(LinkSpec("body", None, collisions=shapes, visuals=shapes))
    # drop-down oven door hinged at the bottom front
    panel = [
        _box((0.015, hw - 0.05, 0.3), (0, 0, 0.3), STEEL),
        _box((0.015, hw - 0.12, 0.02), (0.03, 0, 0.55), DARK),
    ]
    b.add_link(
        LinkSpec("oven_door", "body", HINGE, f"{name}_door_joint",
                 origin_pos=(hd, 0, -body_h + 0.12), axis=(0, 1, 0),
                 limit=(0.0, 1.6), damping=3.0, frictionloss=1.0,
                 collisions=panel, visuals=panel)
    )
    b.set_initial_pose(_pose(pos, yaw, body_h))
    b.fix_root_link = True
    return b.build(name)


def build_microwave(scene, name, pos, yaw=0.0, z=COUNTER_H):
    """Countertop microwave with side-hinged door (fixtures/microwave.py)."""
    hw, hh, hd = 0.26, 0.15, 0.18
    b = ArticulationBuilder(scene)
    b.disable_self_collisions = True
    t = 0.015
    shell = [
        _box((hd, hw, t), (0, 0, hh - t), WHITE),
        _box((hd, hw, t), (0, 0, -hh + t), WHITE),
        _box((hd, t, hh), (0, -hw + t, 0), WHITE),
        _box((hd, t, hh), (0, hw - t, 0), WHITE),
        _box((t, hw, hh), (-hd + t, 0, 0), WHITE),
    ]
    b.add_link(LinkSpec("body", None, collisions=shell, visuals=shell))
    panel = [
        _box((t, hw - t, hh - t), (0, hw - t, 0), DARK),
        _box((0.015, 0.01, 0.06), (0.03, 2 * hw - 0.06, 0), STEEL),
    ]
    b.add_link(
        LinkSpec("door", "body", HINGE, f"{name}_door_joint",
                 origin_pos=(hd, -hw, 0), axis=(0, 0, -1),
                 limit=(0.0, 2.0), damping=1.0, frictionloss=0.3,
                 collisions=panel, visuals=panel)
    )
    b.set_initial_pose(_pose(pos, yaw, z + hh))
    b.fix_root_link = True
    return b.build(name)


def build_fridge(scene, name, pos, yaw=0.0):
    """Full-height fridge with hinged door (fixtures/fridge.py)."""
    hw, hh, hd = 0.38, 0.90, 0.35
    t = 0.02
    b = ArticulationBuilder(scene)
    b.disable_self_collisions = True
    shell = [
        _box((hd, hw, t), (0, 0, hh - t), WHITE),
        _box((hd, hw, t), (0, 0, -hh + t), WHITE),
        _box((hd, t, hh), (0, -hw + t, 0), WHITE),
        _box((hd, t, hh), (0, hw - t, 0), WHITE),
        _box((t, hw, hh), (-hd + t, 0, 0), WHITE),
        _box((hd, hw, t), (0, 0, 0), WHITE),  # mid shelf
    ]
    b.add_link(LinkSpec("body", None, collisions=shell, visuals=shell))
    panel = [
        _box((t, hw - t, hh - t), (0, -(hw - t), 0), WHITE),
        _box((0.02, 0.015, 0.25), (0.04, -(2 * hw - 0.12), 0.1), STEEL),
    ]
    b.add_link(
        LinkSpec("door", "body", HINGE, f"{name}_door_joint",
                 origin_pos=(hd, hw, 0), axis=(0, 0, 1),
                 limit=(0.0, 2.3), damping=4.0, frictionloss=1.5,
                 collisions=panel, visuals=panel)
    )
    b.set_initial_pose(_pose(pos, yaw, hh))
    b.fix_root_link = True
    return b.build(name)


def build_dishwasher(scene, name, pos, yaw=0.0, width=0.6):
    """Under-counter dishwasher with drop-down door (fixtures/dishwasher.py)."""
    hw, hd = width / 2, COUNTER_D / 2
    body_h = (COUNTER_H - TOP_T) / 2
    b = ArticulationBuilder(scene)
    b.disable_self_collisions = True
    shapes = [
        _box((hd - 0.02, hw, body_h), (0, 0, 0), STEEL),
        _box((hd, hw, TOP_T / 2), (0, 0, body_h + TOP_T / 2), TOP),
    ]
    b.add_link(LinkSpec("body", None, collisions=shapes, visuals=shapes))
    panel = [
        _box((0.015, hw - 0.03, body_h - 0.04), (0, 0, body_h - 0.04), STEEL),
        _box((0.02, hw - 0.1, 0.015), (0.03, 0, 2 * body_h - 0.12), DARK),
    ]
    b.add_link(
        LinkSpec("door", "body", HINGE, f"{name}_door_joint",
                 origin_pos=(hd, 0, -body_h + 0.05), axis=(0, 1, 0),
                 limit=(0.0, 1.5), damping=3.0, frictionloss=1.0,
                 collisions=panel, visuals=panel)
    )
    b.set_initial_pose(_pose(pos, yaw, body_h))
    b.fix_root_link = True
    return b.build(name)


def build_hood(scene, name, pos, yaw=0.0, z=1.55):
    """Vent hood above the stove (fixtures/hood.py)."""
    b = scene.create_actor_builder()
    b.add_box_collision([0, 0, 0], half_size=[0.25, 0.3, 0.04], friction=0.5)
    b.add_box_visual([0, 0, 0], half_size=[0.25, 0.3, 0.04], color=STEEL)
    b.add_box_collision([0, 0, 0.25], half_size=[0.12, 0.15, 0.22],
                        friction=0.5)
    b.add_box_visual([0, 0, 0.25], half_size=[0.12, 0.15, 0.22], color=STEEL)
    b.set_initial_pose(_pose(pos, yaw, z))
    return b.build_static(name)


def _bar_handle(hw_door, side, t=0.015):
    """Vertical bar handle on a door panel front (fixtures/handles.py
    BarHandle analog): post + bar standing off the panel."""
    x = 0.035
    return [
        _box((x / 2, 0.008, 0.008), (x / 2, -side * (hw_door - 0.05), 0.10),
             DARK),
        _box((x / 2, 0.008, 0.008), (x / 2, -side * (hw_door - 0.05), -0.10),
             DARK),
        _box((0.008, 0.008, 0.13), (x, -side * (hw_door - 0.05), 0), DARK),
    ]


def build_upper_cabinet(scene, name, pos, yaw=0.0, width=0.8, height=0.6,
                        depth=0.35, z=1.45, color=PANEL):
    """Wall-mounted double-door cabinet with bar handles
    (fixtures/cabinet.py HingeCabinet analog)."""
    hw, hh, hd = width / 2, height / 2, depth / 2
    t = 0.018
    b = ArticulationBuilder(scene)
    b.disable_self_collisions = True
    shell = [
        _box((hd, hw, t), (0, 0, hh - t), color),
        _box((hd, hw, t), (0, 0, -hh + t), color),
        _box((hd, t, hh), (0, -hw + t, 0), color),
        _box((hd, t, hh), (0, hw - t, 0), color),
        _box((t, hw, hh), (-hd + t, 0, 0), color),
        _box((hd, hw, t), (0, 0, 0), color),  # mid shelf
    ]
    b.add_link(LinkSpec("body", None, collisions=shell, visuals=shell))
    hwd = hw / 2  # each door covers half the opening
    for side, tag in ((-1.0, "left"), (1.0, "right")):
        panel = [_box((t, hwd - t, hh - t), (0, -side * hwd, 0), color)]
        panel += _bar_handle(2 * hwd, side)
        b.add_link(
            LinkSpec(f"door_{tag}", "body", HINGE,
                     f"{name}_door_{tag}_joint",
                     origin_pos=(hd, side * hw, 0), axis=(0, 0, side),
                     limit=(0.0, 2.3), damping=2.0, frictionloss=0.5,
                     collisions=panel, visuals=panel)
        )
    b.set_initial_pose(_pose(pos, yaw, z + hh))
    b.fix_root_link = True
    return b.build(name)


def build_open_shelf(scene, name, pos, yaw=0.0, width=0.8, height=0.7,
                     depth=0.3, z=1.4, n_shelves=3, color=WOOD):
    """Open wall shelves (fixtures/others.py OpenShelf analog)."""
    b = scene.create_actor_builder()
    hw, hd = width / 2, depth / 2
    t = 0.02
    for k in range(n_shelves):
        zc = k * (height / max(1, n_shelves - 1)) if n_shelves > 1 else 0.0
        b.add_box_collision([0, 0, zc], half_size=[hd, hw, t], friction=0.7)
        b.add_box_visual([0, 0, zc], half_size=[hd, hw, t], color=color)
    # side supports
    for sy in (-hw + t, hw - t):
        b.add_box_collision([0, sy, height / 2],
                            half_size=[hd, t, height / 2 + t], friction=0.7)
        b.add_box_visual([0, sy, height / 2],
                         half_size=[hd, t, height / 2 + t], color=color)
    b.set_initial_pose(_pose(pos, yaw, z))
    return b.build_static(name)


def build_island(scene, name, pos, yaw=0.0, width=1.2, depth=0.8,
                 color=WOOD):
    """Freestanding kitchen island: oversized counter with overhang
    (fixtures/counter.py island config)."""
    b = scene.create_actor_builder()
    hw, hd = width / 2, depth / 2
    body_h = (COUNTER_H - TOP_T) / 2
    b.add_box_collision([0, 0, body_h], half_size=[hd - 0.08, hw - 0.08,
                                                   body_h], friction=0.6)
    b.add_box_visual([0, 0, body_h], half_size=[hd - 0.08, hw - 0.08, body_h],
                     color=color)
    top_z = COUNTER_H - TOP_T / 2
    b.add_box_collision([0, 0, top_z], half_size=[hd, hw, TOP_T / 2],
                        friction=0.8)
    b.add_box_visual([0, 0, top_z], half_size=[hd, hw, TOP_T / 2], color=TOP)
    b.set_initial_pose(_pose(pos, yaw, 0.0))
    return b.build_static(name)


def build_toaster(scene, name, pos, yaw=0.0, z=COUNTER_H):
    """Countertop toaster (fixtures/accessories.py Toaster analog)."""
    b = scene.create_actor_builder()
    b.add_box_collision([0, 0, 0.09], half_size=[0.09, 0.14, 0.09],
                        friction=0.6, density=300)
    b.add_box_visual([0, 0, 0.09], half_size=[0.09, 0.14, 0.09], color=STEEL)
    for sy in (-0.05, 0.05):
        b.add_box_visual([0, sy, 0.18], half_size=[0.06, 0.012, 0.004],
                         color=DARK)
    b.set_initial_pose(_pose(pos, yaw, z))
    return b.build_static(name)


def build_coffee_machine(scene, name, pos, yaw=0.0, z=COUNTER_H):
    """Countertop coffee machine (fixtures/accessories.py CoffeeMachine)."""
    b = scene.create_actor_builder()
    b.add_box_collision([-0.05, 0, 0.17], half_size=[0.05, 0.10, 0.17],
                        friction=0.6)
    b.add_box_visual([-0.05, 0, 0.17], half_size=[0.05, 0.10, 0.17],
                     color=DARK)
    b.add_box_collision([0.04, 0, 0.30], half_size=[0.06, 0.08, 0.04],
                        friction=0.6)
    b.add_box_visual([0.04, 0, 0.30], half_size=[0.06, 0.08, 0.04],
                     color=DARK)
    b.add_box_collision([0.04, 0, 0.015], half_size=[0.06, 0.08, 0.015],
                        friction=0.6)
    b.add_box_visual([0.04, 0, 0.015], half_size=[0.06, 0.08, 0.015],
                     color=STEEL)
    b.set_initial_pose(_pose(pos, yaw, z))
    return b.build_static(name)


def build_window(scene, name, pos, yaw=0.0, width=0.9, height=0.9, z=1.3,
                 frame_color=WHITE):
    """Window: frame + translucent pane set into a wall
    (fixtures/windows.py analog; the pane renders glass-blue)."""
    b = scene.create_actor_builder()
    hw, hh = width / 2, height / 2
    t = 0.03
    for sy in (-hw, hw):
        b.add_box_visual([0, sy, 0], half_size=[0.05, t, hh + t],
                         color=frame_color)
    for sz in (-hh, hh):
        b.add_box_visual([0, 0, sz], half_size=[0.05, hw + t, t],
                         color=frame_color)
    b.add_box_visual([0, 0, 0], half_size=[0.01, hw, hh],
                     color=(0.65, 0.78, 0.88, 1.0))
    # mullions
    b.add_box_visual([0.01, 0, 0], half_size=[0.012, 0.015, hh],
                     color=frame_color)
    b.add_box_visual([0.01, 0, 0], half_size=[0.012, hw, 0.015],
                     color=frame_color)
    b.set_initial_pose(_pose(pos, yaw, z))
    return b.build_static(name)


def build_wall(scene, name, pos, yaw=0.0, width=4.0, height=2.6,
               color=(0.85, 0.83, 0.78, 1.0)):
    b = scene.create_actor_builder()
    b.add_box_collision([0, 0, 0], half_size=[0.04, width / 2, height / 2],
                        friction=0.5)
    b.add_box_visual([0, 0, 0], half_size=[0.04, width / 2, height / 2],
                     color=color)
    b.set_initial_pose(_pose(pos, yaw, height / 2))
    return b.build_static(name)
