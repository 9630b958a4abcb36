"""OpenCabinetDrawer-v1 / OpenCabinetDoor-v1 (counterpart of
maniskill_tpu/envs/tasks/mobile_manipulation/open_cabinet_drawer.py).

Heterogeneous articulated objects: every env holds a cabinet of its own,
with its own number of drawers and doors. One union-template articulation
carries them all through per-env parameter tables: the procedural cabinets
of building/articulations/cabinet.py, or, when ``$MS_ASSET_DIR`` holds a
PartNet-Mobility dataset (and ``MS_PARTNET_CABINETS`` is not "0"), real
models cooked by building/articulations/partnet_union.py. A locked slot has
zero joint range, so each env's dofs differ under one static shape. The
default robot is the Fetch mobile manipulator.

The per-env tables are drawn on the host with a numpy ``RandomState`` seeded
from the first episode seed, with the JAX package's calls in its order, so
both packages hold the same tables.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ....building.articulations.cabinet import (
    CABINET_VARIANTS,
    MAX_DRAWERS,
    NUM_SLOTS,
    apply_cabinet_variants,
    build_cabinet_template,
    sample_cabinet_variants,
)
from ....building.ground import build_ground
from ....sensors.camera import CameraConfig
from ....utils.geometry.rotation_conversions import quaternion_apply
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv
from ...utils.observations import parse_obs_mode_to_struct


class OpenCabinetBase(BaseEnv):
    SUPPORTED_ROBOTS = ["fetch", "panda"]
    min_open_frac = 0.75
    target_kind = "drawer"  # or "door"

    def __init__(self, *args, robot_uids="fetch", robot_init_qpos_noise=0.02, **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[-0.6, 0.9, 1.1], target=[0.2, 0, 0.4])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([1.6, 1.4, 1.2], [0.1, 0.0, 0.4])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([1.5, 0, 0, 0, 0, 0, 1]))

    def _variant_ok(self, v):
        return (v["drawers"] if self.target_kind == "drawer" else v["doors"]) > 0

    def _load_scene(self, options: dict):
        from ....building.articulations.partnet_mobility import partnet_mobility_available

        self.ground = build_ground(self.scene)
        self._use_partnet = (os.environ.get("MS_PARTNET_CABINETS", "auto") != "0"
                             and partnet_mobility_available())
        if self._use_partnet:
            self._load_partnet_cabinet(options)
        else:
            self.cabinet, self.cab_meta = build_cabinet_template(self.scene)

    def _load_partnet_cabinet(self, options: dict):
        """Cook every available PartNet-Mobility model and build the union
        sized for the models usable by this task (at least one slot of the
        target kind)."""
        from ....building.articulations.partnet_mobility import available_model_ids
        from ....building.articulations.partnet_union import build_partnet_union, load_partnet_model_spec

        ids = available_model_ids()
        specs = {m: load_partnet_model_spec(self.scene, m) for m in ids}
        ok = [m for m in ids if any(sl.kind == self.target_kind for sl in specs[m].slots)]
        self._pn_ids = ok or ids
        self._pn_specs = specs
        self.cabinet, self.cab_meta, (kb, ks) = build_partnet_union(
            self.scene, [specs[m] for m in self._pn_ids], "cabinet")
        self._pn_kb_ks = (kb, ks)
        self._pn_kinds = list(self.cab_meta.kinds)

    def _episode_rng(self) -> np.random.RandomState:
        return np.random.RandomState(int(self._episode_seeds[0]) & 0x7FFFFFFF)

    def _after_reconfigure_partnet(self, options: dict):
        from ....building.articulations.partnet_union import UNION_SLOTS, apply_partnet_models

        B = self.num_envs
        rng = self._episode_rng()
        assign = [self._pn_ids[i] for i in rng.randint(0, len(self._pn_ids), B)]
        kb, ks = self._pn_kb_ks
        inst = apply_partnet_models(self.scene, self.cab_meta, self._pn_specs, assign, kb, ks)
        self._pn_assign = inst
        self._pn_model_ids = assign

        # each env's target: an active slot of the right kind
        S = UNION_SLOTS
        targets = np.zeros(B, np.int64)
        for i in range(B):
            cands = [s for s in range(S) if inst.active[i, s] and self._pn_kinds[s] == self.target_kind] or [
                s for s in range(S) if inst.active[i, s]]
            targets[i] = cands[rng.randint(len(cands))]
        # ranges for the open fraction; the signed dof limits are in the model
        slot_limits = np.stack([np.zeros_like(inst.ranges), inst.ranges], axis=-1)
        self._bind_tables(S, targets, inst.handle_local, slot_limits, inst.active)

    def _after_reconfigure(self, options: dict):
        if self._use_partnet:
            self._after_reconfigure_partnet(options)
        else:
            B = self.num_envs
            rng = self._episode_rng()
            valid_ids = np.array([i for i, v in enumerate(CABINET_VARIANTS) if self._variant_ok(v)])
            variant_ids = valid_ids[rng.randint(0, len(valid_ids), B)]
            inst = sample_cabinet_variants(rng, B, variant_ids=variant_ids)
            apply_cabinet_variants(self.scene, self.cab_meta, inst)
            self.cab_inst = inst

            slot_range = range(MAX_DRAWERS) if self.target_kind == "drawer" else range(MAX_DRAWERS, NUM_SLOTS)
            targets = np.zeros(B, np.int64)
            for i in range(B):
                cands = [s for s in slot_range if inst.active[i, s]]
                targets[i] = cands[rng.randint(len(cands))]
            self._bind_tables(NUM_SLOTS, targets, inst.handle_local, inst.limits, inst.active)
        # device copies of what the step and the reset read
        dev = self.device
        meta = self.cab_meta
        self._slot_bodies_t = torch.as_tensor(meta.slot_bodies.astype(np.int64), device=dev)
        self._slot_q_t = torch.as_tensor(meta.slot_qadrs.astype(np.int64), device=dev)
        self._slot_v_t = torch.as_tensor(meta.slot_dofs.astype(np.int64), device=dev)
        kf = self.agent.keyframes["rest"]
        self._rest_qpos = torch.as_tensor(np.asarray(kf.qpos, np.float32), device=dev)

    def _bind_tables(self, num_slots, targets, handle_local, slot_limits, active):
        dev = self.device
        self._num_slots = num_slots
        self.target_slot = torch.as_tensor(targets, device=dev)
        self.target_onehot = torch.as_tensor(np.eye(num_slots, dtype=np.float32)[targets], device=dev)
        self.handle_local = torch.as_tensor(np.asarray(handle_local, np.float32), device=dev)  # (B, S, 3)
        self.slot_limits = torch.as_tensor(np.asarray(slot_limits, np.float32), device=dev)  # (B, S, 2)
        self.active_mask = torch.as_tensor(np.asarray(active, np.float32), device=dev)

    # -- each env's target handle in the world ----------------------------
    @property
    def handle_pos(self) -> torch.Tensor:
        d = self.scene.data
        p = d.xpos[:, self._slot_bodies_t]  # (B, S, 3)
        q = d.xquat[:, self._slot_bodies_t]
        world = p + quaternion_apply(q, self.handle_local)
        return torch.sum(self.target_onehot[..., None] * world, 1)

    def _slot_fracs(self) -> torch.Tensor:
        q = self.scene.data.qpos[:, self._slot_q_t]  # (B, S)
        lo, hi = self.slot_limits[..., 0], self.slot_limits[..., 1]
        return torch.where(hi - lo > 1e-6, (q - lo) / (hi - lo + 1e-9), 0.0)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        B = self.num_envs
        rng = self._batched_episode_rng
        n = self._rest_qpos.shape[0]
        qpos = self._rest_qpos + rng.normal(0.0, self.robot_init_qpos_noise, (n,))
        if self.robot_uids == "fetch":
            # the base 1.6-1.8 m from the cabinet, yaw within +-pi/32
            dist = rng.uniform(1.6, 1.8)
            yaw = rng.uniform(-np.pi / 32, np.pi / 32)
            qpos[:, 0] = 0.1 + dist
            qpos[:, 1] = rng.uniform(-0.2, 0.2)
            qpos[:, 2] = np.pi + yaw
        self.agent.reset(qpos)
        zeros = torch.zeros(B, self.cabinet.dof, device=self.device)
        self.cabinet.set_qpos(zeros)
        self.cabinet.set_qvel(zeros)

    def evaluate(self):
        fracs = self._slot_fracs()
        frac = torch.sum(self.target_onehot * fracs, 1)
        qv = self.scene.data.qvel[:, self._slot_v_t]
        target_qvel = torch.sum(self.target_onehot * qv, 1)
        return {
            "success": (frac >= self.min_open_frac) & (torch.abs(target_qvel) <= 0.05),
            "open_frac": frac,
        }

    def _get_obs_extra(self, info: dict):
        obs = dict(
            tcp_pose=self.agent.tcp.pose.raw_pose,
            handle_pos=self.handle_pos,
            open_frac=info["open_frac"],
        )
        if parse_obs_mode_to_struct(self.obs_mode)["use_state"]:
            obs.update(
                slot_qpos=self.scene.data.qpos[:, self._slot_q_t],
                slot_active=self.active_mask,
                target_onehot=self.target_onehot,
            )
        return obs

    def compute_dense_reward(self, obs, action, info):
        tcp_to_handle = torch.linalg.vector_norm(self.handle_pos - self.agent.tcp.pose.p, dim=1)
        reaching = 1 - torch.tanh(5.0 * tcp_to_handle)
        open_reward = 2 * torch.clamp(info["open_frac"] / self.min_open_frac, 0.0, 1.0)
        return torch.where(info["success"], 5.0, reaching + open_reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 5.0


@register_env("OpenCabinetDrawer-v1", max_episode_steps=100)
class OpenCabinetDrawerEnv(OpenCabinetBase):
    """Open each env's target drawer past min_open_frac of its range."""

    target_kind = "drawer"


@register_env("OpenCabinetDoor-v1", max_episode_steps=100)
class OpenCabinetDoorEnv(OpenCabinetBase):
    """Open each env's target door (revolute) past min_open_frac."""

    target_kind = "door"
