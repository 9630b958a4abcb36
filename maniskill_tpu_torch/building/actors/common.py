"""Prebuilt primitive actors (counterpart of
maniskill_tpu/building/actors/common.py)."""
from __future__ import annotations


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


def _build(builder, name, body_type):
    if body_type == "dynamic":
        return builder.build(name)
    if body_type == "kinematic":
        return builder.build_kinematic(name)
    if body_type == "static":
        return builder.build_static(name)
    raise ValueError(body_type)
