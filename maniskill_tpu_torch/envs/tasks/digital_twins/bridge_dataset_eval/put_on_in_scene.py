"""BridgeData v2 evaluation tasks (counterpart of
maniskill_tpu/envs/tasks/digital_twins/bridge_dataset_eval/put_on_in_scene.py).

Spawn-configuration grids and success criteria preserved exactly; objects
and stages are the procedural stand-ins from base_env.build_bridge_object.
"""
from __future__ import annotations

import numpy as np

from .....utils.registration import register_env
from .base_env import SINK_TOP_Z, TABLE_TOP_Z, BaseBridgeEnv


def _euler_z(yaw):
    return np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])


def _pair_grid(xy_center, half_x, half_y, z_src, z_tgt):
    """All ordered (src, tgt) placements over the 2x2 corner grid."""
    grid = (np.array([[0, 0], [0, 1], [1, 0], [1, 1]]) * 2 - 1) * np.array(
        [half_x, half_y]
    ) + np.asarray(xy_center)
    configs = []
    for i, g1 in enumerate(grid):
        for j, g2 in enumerate(grid):
            if i != j:
                configs.append(
                    np.array([np.append(g1, z_src), np.append(g2, z_tgt)])
                )
    return np.stack(configs)


@register_env("PutCarrotOnPlateInScene-v1", max_episode_steps=60)
class PutCarrotOnPlateInScene(BaseBridgeEnv):
    """Put the carrot on the plate."""

    scene_setting = "flat_table"
    objects_excluded_from_greenscreening = [
        "bridge_carrot_generated_modified",
        "bridge_plate_objaverse_larger",
    ]

    def __init__(self, **kwargs):
        xyz = _pair_grid([-0.16, 0.0], 0.075, 0.075,
                         TABLE_TOP_Z + 0.025, TABLE_TOP_Z + 0.01)
        quat = np.stack(
            [
                np.array([_euler_z(np.pi), [1, 0, 0, 0]]),
                np.array([_euler_z(-np.pi / 2), [1, 0, 0, 0]]),
            ]
        )
        super().__init__(
            obj_names=["bridge_carrot_generated_modified",
                       "bridge_plate_objaverse_larger"],
            xyz_configs=xyz, quat_configs=quat, **kwargs,
        )

    def evaluate(self):
        return self._evaluate(success_require_src_completely_on_target=True)

    def get_language_instruction(self, **kwargs):
        return ["put carrot on plate"] * self.num_envs


@register_env("PutEggplantInBasketScene-v1", max_episode_steps=120)
class PutEggplantInBasketScene(BaseBridgeEnv):
    """Put the eggplant into the yellow basket."""

    scene_setting = "sink"
    objects_excluded_from_greenscreening = ["eggplant"]

    def __init__(self, **kwargs):
        xy_center = [-0.105, 0.206]
        grid = []
        for x in np.linspace(-0.01, 0.01, 2):
            for y in np.linspace(-0.015, 0.015, 4):
                grid.append([x + xy_center[0], y + xy_center[1],
                             SINK_TOP_Z + 0.05])
        target = [-0.125, 0.025, SINK_TOP_Z + 0.002]
        xyz = np.stack([np.stack([p, target]) for p in grid])
        # measured eggplant spawn orientations
        yaws = np.linspace(-np.pi / 4, np.pi / 4, 3)
        quat = np.stack(
            [np.array([_euler_z(y), [1, 0, 0, 0]]) for y in yaws]
        )
        super().__init__(
            obj_names=["eggplant", "dummy_sink_target_plane"],
            xyz_configs=xyz, quat_configs=quat, **kwargs,
        )

    def evaluate(self):
        return self._evaluate(
            success_require_src_completely_on_target=False,
            z_flag_required_offset=0.06,
        )

    def get_language_instruction(self, **kwargs):
        return ["put eggplant into yellow basket"] * self.num_envs


@register_env("StackGreenCubeOnYellowCubeBakedTexInScene-v1",
              max_episode_steps=60)
class StackGreenCubeOnYellowCubeBakedTexInScene(BaseBridgeEnv):
    """Stack the green block on the yellow block."""

    scene_setting = "flat_table"
    objects_excluded_from_greenscreening = [
        "baked_green_cube_3cm", "baked_yellow_cube_3cm",
    ]

    def __init__(self, **kwargs):
        xyz = np.concatenate(
            [
                _pair_grid([-0.16, 0.0], h, h,
                           TABLE_TOP_Z + 0.025, TABLE_TOP_Z + 0.025)
                for h in (0.05, 0.1)
            ]
        )
        quat = np.array([[[1, 0, 0, 0], [1, 0, 0, 0]]], np.float32)
        super().__init__(
            obj_names=["baked_green_cube_3cm", "baked_yellow_cube_3cm"],
            xyz_configs=xyz, quat_configs=quat, **kwargs,
        )

    def evaluate(self):
        return self._evaluate(success_require_src_completely_on_target=True)

    def get_language_instruction(self, **kwargs):
        return ["stack the green block on the yellow block"] * self.num_envs


@register_env("PutSpoonOnTableClothInScene-v1", max_episode_steps=60)
class PutSpoonOnTableClothInScene(BaseBridgeEnv):
    """Put the spoon on the towel."""

    scene_setting = "flat_table"
    objects_excluded_from_greenscreening = [
        "table_cloth_generated_shorter", "bridge_spoon_generated_modified",
    ]

    def __init__(self, **kwargs):
        xyz = _pair_grid([-0.16, 0.0], 0.075, 0.075,
                         TABLE_TOP_Z + 0.015, TABLE_TOP_Z + 0.008)
        # source is the spoon: swap column order (reference spawns spoon at
        # grid_pos_1 with z=0.88, cloth at grid_pos_2 with z=0.875)
        quat = np.stack(
            [
                np.array([[1, 0, 0, 0], [1, 0, 0, 0]]),
                np.array([_euler_z(np.pi / 2), [1, 0, 0, 0]]),
            ]
        )
        super().__init__(
            obj_names=["bridge_spoon_generated_modified",
                       "table_cloth_generated_shorter"],
            xyz_configs=xyz, quat_configs=quat, **kwargs,
        )

    def evaluate(self):
        # spoons may rest partially on the cloth
        return self._evaluate(success_require_src_completely_on_target=False)

    def get_language_instruction(self, **kwargs):
        return ["put the spoon on the towel"] * self.num_envs
