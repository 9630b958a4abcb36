"""BridgeData v2 digital-twin base environment (counterpart of
maniskill_tpu/envs/tasks/digital_twins/bridge_dataset_eval/base_env.py, the
SIMPLER evaluation suite).

Kept from the reference: the real2sim-tuned WidowX-250S bridge agents, the
calibrated evaluation cameras, the discrete xyz/quat spawn-configuration
grids, the settle-then-record episode protocol, and the bbox-overlap, grasp
and contact success logic. The dataset's stages and scanned objects are
procedural stand-ins with the reference's bounding boxes (in both packages;
each is described beside its builder below), and the greenscreen
composites the procedural overlay unless an inpainting photograph exists.

Physics runs at 500 Hz under 5 Hz control: 100 substeps per control step.
Every reset lets the objects settle for 50 substeps: a loop of
``physics.step`` calls on the device over every env, whose result is merged
into the envs being reset only (no host loop over envs, no sync, no
host-to-device copy); the other envs' ``Data`` comes out bit-equal. Episode
statistics (consecutive grasps and the like) are task extras, so they reset
with the env mask and travel with the state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ..... import physics as phys
from .....building.ground import build_ground
from .....sensors.camera import CameraConfig
from .....structs.pose import Pose
from .....structs.types import SimConfig
from .....utils.geometry.rotation_conversions import quaternion_to_matrix
from .....utils.scene_utils import look_at
from ....utils.observations import parse_obs_mode_to_struct
from ..base_env import BaseDigitalTwinEnv

TABLE_TOP_Z = 0.865  # the flat table's work surface height
SINK_TOP_Z = 0.88
SETTLE_SUBSTEPS = 50
# the measured bridge-dataset rest qpos of each setting
REST_QPOS = {
    "flat_table": [-0.01840777, 0.0398835, 0.22242722, -0.00460194, 1.36524296, 0.00153398, 0.037, 0.037],
    "sink": [-0.2600599, -0.12875618, 0.04461369, -0.00652761, 1.7033415, -0.26983038, 0.037, 0.037],
}


def build_bridge_object(scene, name: str):
    """Procedural stand-ins for the bridge_v2_real2sim scanned objects, with
    the bounding boxes of the dataset's custom/info_bridge_custom_v0.json
    scale. Returns (actor, bbox size)."""
    b = scene.create_actor_builder()
    if name == "bridge_carrot_generated_modified":
        # the carrot: an orange capsule lying along +x
        b.add_capsule_collision(radius=0.013, half_length=0.04, friction=0.5, density=300)
        b.add_capsule_visual(radius=0.013, half_length=0.04, color=[0.93, 0.45, 0.12, 1])
        bbox = np.array([0.106, 0.026, 0.026])
    elif name == "bridge_plate_objaverse_larger":
        b.add_cylinder_collision(radius=0.062, half_length=0.008, friction=0.6, density=400)
        b.add_cylinder_visual(radius=0.062, half_length=0.008, color=[0.92, 0.92, 0.95, 1])
        bbox = np.array([0.124, 0.124, 0.016])
    elif name == "eggplant":
        b.add_capsule_collision(radius=0.028, half_length=0.038, friction=0.5, density=350)
        b.add_capsule_visual(radius=0.028, half_length=0.038, color=[0.35, 0.12, 0.45, 1])
        bbox = np.array([0.132, 0.056, 0.056])
    elif name == "dummy_sink_target_plane":
        # the invisible, kinematic landing plane inside the sink basket
        b.add_box_collision(half_size=[0.06, 0.085, 0.002], friction=1.0)
        bbox = np.array([0.12, 0.17, 0.004])
        b.set_initial_pose(np.array([-0.125, 0.025, SINK_TOP_Z, 1, 0, 0, 0]))
        return b.build_kinematic(name), bbox
    elif name == "baked_green_cube_3cm":
        b.add_box_collision(half_size=[0.015] * 3, friction=0.7, density=300)
        b.add_box_visual(half_size=[0.015] * 3, color=[0.12, 0.65, 0.2, 1])
        bbox = np.array([0.03, 0.03, 0.03])
    elif name == "baked_yellow_cube_3cm":
        b.add_box_collision(half_size=[0.015] * 3, friction=0.7, density=300)
        b.add_box_visual(half_size=[0.015] * 3, color=[0.85, 0.75, 0.1, 1])
        bbox = np.array([0.03, 0.03, 0.03])
    elif name == "bridge_spoon_generated_modified":
        b.add_box_collision(half_size=[0.055, 0.016, 0.006], friction=0.5, density=300)
        b.add_box_visual(half_size=[0.055, 0.016, 0.006], color=[0.75, 0.75, 0.78, 1])
        bbox = np.array([0.11, 0.032, 0.012])
    elif name == "table_cloth_generated_shorter":
        b.add_box_collision(half_size=[0.06, 0.06, 0.004], friction=1.2, density=200)
        b.add_box_visual(half_size=[0.06, 0.06, 0.004], color=[0.25, 0.35, 0.7, 1])
        bbox = np.array([0.12, 0.12, 0.008])
    else:
        raise KeyError(f"unknown bridge object {name}")
    b.set_initial_pose(np.array([0.0, 0.3, TABLE_TOP_Z + 0.1, 1, 0, 0, 0]))
    return b.build(name), bbox


def merge_masked(scene, old, new):
    """``new`` where the scene's reset mask is set, ``old`` elsewhere, field
    by field (a field ``old`` lacks is taken from ``new`` whole)."""
    if old is None:
        return new
    if isinstance(new, dict):
        return {k: merge_masked(scene, old.get(k), v) for k, v in new.items()}
    if dataclasses.is_dataclass(new):  # Data, Contact
        return new.replace(**{f.name: merge_masked(scene, getattr(old, f.name), getattr(new, f.name))
                              for f in dataclasses.fields(new)})
    if isinstance(new, torch.Tensor):
        return scene.masked(new, old)
    return new


class BaseBridgeEnv(BaseDigitalTwinEnv):
    """Base digital-twin env of the BridgeData v2 evaluation."""

    SUPPORTED_OBS_MODES = ("rgb+segmentation", "state", "state_dict", "none")
    SUPPORTED_REWARD_MODES = ("none", "sparse")
    scene_setting: str = "flat_table"  # or "sink"
    objects_excluded_from_greenscreening: List[str] = []

    def __init__(self, obj_names: List[str], xyz_configs: np.ndarray, quat_configs: np.ndarray, **kwargs):
        self.obj_names = obj_names
        self.source_obj_name = obj_names[0]
        self.target_obj_name = obj_names[1]
        self.xyz_configs = np.asarray(xyz_configs, np.float32)
        self.quat_configs = np.asarray(quat_configs, np.float32)
        self.objs: Dict = {}
        self.obj_bboxes: Dict[str, np.ndarray] = {}
        robot_uid = ("widowx250s_bridgedataset_flat_table" if self.scene_setting == "flat_table"
                     else "widowx250s_bridgedataset_sink")
        # the real inpainting photographs are not in the repository: the
        # greenscreen composites the procedural overlay
        self.rgb_overlay_paths = {"3rd_view_camera": None}
        kwargs.setdefault("reward_mode", "none")
        kwargs.setdefault("control_mode", "arm_pd_ee_target_delta_pose_align2_gripper_pd_joint_pos")
        super().__init__(robot_uids=robot_uid, **kwargs)

    @property
    def _default_sim_config(self):
        return SimConfig(sim_freq=500, control_freq=5)

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.6, 0.7, 1.4], [0.0, 0.0, TABLE_TOP_Z])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        # wxyz [0, 0, 0, 1]: turned 180 degrees about z
        if self.scene_setting == "flat_table":
            pose = np.array([0.147, 0.028, 0.870, 0, 0, 0, 1])
        else:
            pose = np.array([0.127, 0.060, 0.85, 0, 0, 0, 1])
        super()._load_agent(options, pose)

    def _load_scene(self, options: dict):
        self.ground = build_ground(self.scene)
        # the arena, a stand-in for stages/bridge_table_1_v{1,2}.glb: a work
        # table (and a sink basket in the sink setting)
        b = self.scene.create_actor_builder()
        b.add_box_collision(half_size=[0.5, 0.35, TABLE_TOP_Z / 2], friction=1.0)
        b.add_box_visual(half_size=[0.5, 0.35, TABLE_TOP_Z / 2], color=[0.57, 0.45, 0.33, 1])
        b.set_initial_pose(np.array([-0.1, 0.0, TABLE_TOP_Z / 2, 1, 0, 0, 0]))
        self.arena = b.build_static("arena")
        if self.scene_setting == "sink":
            # the yellow basket: a floor and 4 walls around the sink target
            bb = self.scene.create_actor_builder()
            cx, cy = -0.125, 0.025
            hw, hl, wall, hh = 0.075, 0.10, 0.008, 0.04
            yellow = [0.85, 0.72, 0.1, 1]
            bb.add_box_collision([cx, cy, SINK_TOP_Z - 0.006], half_size=[hw, hl, 0.006], friction=1.0)
            bb.add_box_visual([cx, cy, SINK_TOP_Z - 0.006], half_size=[hw, hl, 0.006], color=yellow)
            for dx, dy, hsx, hsy in ((hw, 0, wall, hl), (-hw, 0, wall, hl), (0, hl, hw, wall), (0, -hl, hw, wall)):
                bb.add_box_collision([cx + dx, cy + dy, SINK_TOP_Z + hh - 0.006], half_size=[hsx, hsy, hh],
                                     friction=1.0)
                bb.add_box_visual([cx + dx, cy + dy, SINK_TOP_Z + hh - 0.006], half_size=[hsx, hsy, hh],
                                  color=yellow)
            self.sink = bb.build_static("sink")

        for name in self.obj_names:
            actor, bbox = build_bridge_object(self.scene, name)
            self.objs[name] = actor
            self.obj_bboxes[name] = bbox
        for name in self.objects_excluded_from_greenscreening:
            self.remove_object_from_greenscreen(self.objs[name])

        # per-env episode statistics, carried in the state
        for name, shape in (("consecutive_grasp", ()), ("stat_is_src_obj_grasped", ()),
                            ("stat_consecutive_grasp", ()), ("src_xyz_settle", (3,)), ("tgt_xyz_settle", (3,)),
                            ("src_bbox_world", (3,)), ("tgt_bbox_world", (3,))):
            self.scene.register_extra(name, shape)

        # the grids, the rest qpos and the boxes on the device once: a
        # host-to-device copy in every reset would stall masked resets
        dev = self.device
        self._xyz_grid = torch.as_tensor(self.xyz_configs, device=dev)
        self._quat_grid = torch.as_tensor(self.quat_configs, device=dev)
        self._rest_qpos = torch.as_tensor(np.asarray(REST_QPOS[self.scene_setting], np.float32), device=dev)
        self._src_bbox = torch.as_tensor(self.obj_bboxes[self.source_obj_name], dtype=torch.float32, device=dev)
        self._tgt_bbox = torch.as_tensor(self.obj_bboxes[self.target_obj_name], dtype=torch.float32, device=dev)

    def _settle(self, sim_steps: int):
        """``sim_steps`` physics substeps over every env after one forward
        pass, merged into the envs being reset only."""
        scene = self.scene
        d0 = scene.data
        d = phys.forward(scene.model, d0)
        for _ in range(sim_steps):
            d = phys.step(scene.model, d)
        scene.bind(merge_masked(scene, d0, d))

    def draw_spawn_config_ids(self, rng):
        """(B,) indices into the xyz and quat spawn grids, drawn from the
        episode generator in this order."""
        return rng.randint(0, len(self.xyz_configs)), rng.randint(0, len(self.quat_configs))

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        pos_ids, quat_ids = self.draw_spawn_config_ids(self._batched_episode_rng)
        xyz = self._xyz_grid[pos_ids.long()]  # (B, n_obj, 3)
        quat = self._quat_grid[quat_ids.long()]
        for i, name in enumerate(self.obj_names):
            if name == "dummy_sink_target_plane":
                continue  # the kinematic landing plane stays at its build pose
            self.objs[name].set_pose(Pose(torch.cat([xyz[:, i], quat[:, i]], -1)))
        self.agent.reset(self._rest_qpos.expand(self.num_envs, -1))

        self._settle(SETTLE_SUBSTEPS)

        # the settled positions and world-frame boxes, for the evaluation
        scene = self.scene
        src = self.objs[self.source_obj_name]
        tgt = self.objs[self.target_obj_name]
        scene.set_extra("src_xyz_settle", src.pose.p)
        scene.set_extra("tgt_xyz_settle", tgt.pose.p)
        scene.set_extra("src_bbox_world", torch.abs(quaternion_to_matrix(src.pose.q) @ self._src_bbox))
        scene.set_extra("tgt_bbox_world", torch.abs(quaternion_to_matrix(tgt.pose.q) @ self._tgt_bbox))

    def _evaluate(self, success_require_src_completely_on_target: bool = True, z_flag_required_offset: float = 0.02):
        scene = self.scene
        src = self.objs[self.source_obj_name]
        tgt = self.objs[self.target_obj_name]

        is_src_obj_grasped = self.agent.is_grasping(src)
        consecutive = torch.where(is_src_obj_grasped, scene.get_extra("consecutive_grasp") + 1, 0.0)
        scene.set_extra("consecutive_grasp", consecutive, masked=False)
        consecutive_grasp = consecutive >= 5

        tgt_half = scene.get_extra("tgt_bbox_world") / 2
        src_half = scene.get_extra("src_bbox_world") / 2
        offset = src.pose.p - tgt.pose.p
        xy_flag = (torch.linalg.vector_norm(offset[:, :2], dim=1)
                   <= torch.linalg.vector_norm(tgt_half[:, :2], dim=1) + 0.003)
        z_flag = (offset[:, 2] > 0) & (offset[:, 2] - tgt_half[:, 2] - src_half[:, 2] <= z_flag_required_offset)
        src_on_target = xy_flag & z_flag
        if success_require_src_completely_on_target:
            forces = scene.get_pairwise_contact_forces(src, tgt)
            src_on_target = src_on_target & (torch.linalg.vector_norm(forces, dim=1) > 0.05)

        grasped_once = torch.maximum(scene.get_extra("stat_is_src_obj_grasped"), is_src_obj_grasped.float())
        scene.set_extra("stat_is_src_obj_grasped", grasped_once, masked=False)
        cg_once = torch.maximum(scene.get_extra("stat_consecutive_grasp"), consecutive_grasp.float())
        scene.set_extra("stat_consecutive_grasp", cg_once, masked=False)

        return dict(success=src_on_target, src_on_target=src_on_target, is_src_obj_grasped=grasped_once > 0,
                    consecutive_grasp=cg_once > 0)

    def evaluate(self):
        return self._evaluate()

    def _get_obs_extra(self, info: dict):
        obs = dict(tcp_pose=self.agent.tcp.pose.raw_pose)
        if parse_obs_mode_to_struct(self.obs_mode)["use_state"]:
            obs.update(src_pose=self.objs[self.source_obj_name].pose.raw_pose,
                       tgt_pose=self.objs[self.target_obj_name].pose.raw_pose)
        return obs

    def get_language_instruction(self, **kwargs):
        return ["pick and place"] * self.num_envs

    def is_final_subtask(self):
        return True
