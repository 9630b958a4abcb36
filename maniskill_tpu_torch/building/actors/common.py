"""Prebuilt primitive actors (counterpart of
maniskill_tpu/building/actors/common.py)."""
from __future__ import annotations

import numpy as np


def build_cube(
    scene,
    half_size: float,
    color,
    name: str,
    body_type: str = "dynamic",
    add_collision: bool = True,
    initial_pose=None,
):
    return build_box(scene, [half_size] * 3, color, name, body_type, add_collision, initial_pose)


def build_box(
    scene, half_sizes, color, name: str, body_type: str = "dynamic",
    add_collision: bool = True, initial_pose=None,
):
    builder = scene.create_actor_builder()
    if add_collision:
        builder.add_box_collision(half_size=half_sizes)
    builder.add_box_visual(half_size=half_sizes, color=color)
    if initial_pose is not None:
        builder.set_initial_pose(initial_pose)
    return _build(builder, name, body_type)


def build_sphere(
    scene, radius: float, color, name: str, body_type: str = "dynamic",
    add_collision: bool = True, initial_pose=None,
):
    builder = scene.create_actor_builder()
    if add_collision:
        builder.add_sphere_collision(radius=radius)
    builder.add_sphere_visual(radius=radius, color=color)
    if initial_pose is not None:
        builder.set_initial_pose(initial_pose)
    return _build(builder, name, body_type)


def build_cylinder(
    scene, radius: float, half_length: float, color, name: str,
    body_type: str = "dynamic", add_collision: bool = True, initial_pose=None,
):
    builder = scene.create_actor_builder()
    if add_collision:
        builder.add_cylinder_collision(radius=radius, half_length=half_length)
    builder.add_cylinder_visual(radius=radius, half_length=half_length, color=color)
    if initial_pose is not None:
        builder.set_initial_pose(initial_pose)
    return _build(builder, name, body_type)


def build_red_white_target(
    scene, radius: float, thickness: float, name: str,
    body_type: str = "kinematic", add_collision: bool = False, initial_pose=None,
):
    """Red/white concentric circular target: five flat cylinders along the
    local x axis, 1e-5 apart (the task rotates it to face up)."""
    target_red = np.array([194, 19, 22, 255]) / 255
    builder = scene.create_actor_builder()
    radii = [radius, radius * 4 / 5, radius * 3 / 5, radius * 2 / 5, radius * 1 / 5]
    colors = [target_red, [1, 1, 1, 1], target_red, [1, 1, 1, 1], target_red]
    for i, (r, c) in enumerate(zip(radii, colors)):
        pose = np.array([np.float64(i) * 1e-5, 0, 0, 0.7071068, 0, 0.7071068, 0])
        builder.add_cylinder_visual(pose=pose, radius=r, half_length=thickness / 2, color=c)
        if add_collision:
            builder.add_cylinder_collision(pose=pose, radius=r, half_length=thickness / 2)
    if initial_pose is not None:
        builder.set_initial_pose(initial_pose)
    return _build(builder, name, body_type)


def build_twocolor_peg(
    scene, length, width, color_1, color_2, name: str,
    body_type: str = "dynamic", add_collision: bool = True, initial_pose=None,
):
    """A box peg of half-sizes (length, width, width), its two halves along
    local x drawn in two colours."""
    builder = scene.create_actor_builder()
    if add_collision:
        builder.add_box_collision(half_size=[length, width, width])
    builder.add_box_visual(
        pose=np.array([-length / 2, 0, 0, 1, 0, 0, 0]),
        half_size=[length / 2, width, width], color=color_1,
    )
    builder.add_box_visual(
        pose=np.array([length / 2, 0, 0, 1, 0, 0, 0]),
        half_size=[length / 2, width, width], color=color_2,
    )
    if initial_pose is not None:
        builder.set_initial_pose(initial_pose)
    return _build(builder, name, body_type)


def build_colorful_cube(
    scene, half_size, color, name: str, body_type: str = "dynamic",
    add_collision: bool = True, initial_pose=None,
):
    return build_cube(scene, half_size, color, name, body_type, add_collision, initial_pose)


def _build(builder, name, body_type):
    if body_type == "dynamic":
        return builder.build(name)
    if body_type == "kinematic":
        return builder.build_kinematic(name)
    if body_type == "static":
        return builder.build_static(name)
    raise ValueError(body_type)
