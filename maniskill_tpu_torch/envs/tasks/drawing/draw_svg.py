"""DrawSVG-v1 (counterpart of maniskill_tpu/envs/tasks/drawing/draw_svg.py).

An SVG path outline lies on the canvas at a random position and z-rotation;
the stick robot must trace it. Success: every one of the 150 points resampled
along the path has had the tip touch the canvas within ``THRESHOLD`` of it.
The path parser takes absolute M/L commands and Z; the default path is a
five-point star.
"""
from __future__ import annotations

import numpy as np
import torch

from ....structs.pose import Pose
from ....utils.geometry import rotation_conversions as rc
from ....utils.registration import register_env
from .draw import TableTopFreeDrawEnv

N_REF = 150


def _default_star(scale=0.12):
    pts = []
    for i in range(11):
        ang = np.pi / 2 + i * np.pi * 2 / 10
        r = scale if i % 2 == 0 else scale * 0.45
        pts.append([r * np.cos(ang), r * np.sin(ang)])
    return np.asarray(pts, np.float32)


def _parse_svg_path(d: str) -> np.ndarray:
    """Minimal SVG path parser: absolute M/L (+ Z closes)."""
    toks = d.replace(",", " ").split()
    pts, i, start = [], 0, None
    while i < len(toks):
        t = toks[i]
        if t in ("M", "L"):
            x, y = float(toks[i + 1]), float(toks[i + 2])
            pts.append([x, y])
            if t == "M":
                start = [x, y]
            i += 3
        elif t in ("Z", "z"):
            if start is not None:
                pts.append(start)
            i += 1
        else:
            i += 1
    return np.asarray(pts, np.float32)


@register_env("DrawSVG-v1", max_episode_steps=500)
class DrawSVGEnv(TableTopFreeDrawEnv):
    MAX_DOTS = 500
    THRESHOLD = 0.025
    SUPPORTED_REWARD_MODES = ("sparse", "none")

    def __init__(self, *args, svg: str = None, **kwargs):
        if svg is not None:
            poly = _parse_svg_path(svg)
            # normalize into a ~0.25 m box centred at the origin
            lo, hi = poly.min(0), poly.max(0)
            poly = (poly - (lo + hi) / 2) / max((hi - lo).max(), 1e-6) * 0.25
            poly[:, 1] = -poly[:, 1]  # svg y-down -> world y-up
        else:
            poly = _default_star()
        self._poly = poly
        super().__init__(*args, **kwargs)

    def _ref_points(self) -> np.ndarray:
        """Resample the polyline to N_REF evenly spaced points."""
        poly = self._poly
        seg = np.linalg.norm(np.diff(poly, axis=0), axis=1)
        cum = np.concatenate([[0], np.cumsum(seg)])
        s = np.linspace(0, cum[-1], N_REF)
        out = np.empty((N_REF, 2), np.float32)
        for k, sv in enumerate(s):
            i = min(np.searchsorted(cum, sv) - 1, len(seg) - 1)
            i = max(i, 0)
            t = (sv - cum[i]) / max(seg[i], 1e-9)
            out[k] = poly[i] * (1 - t) + poly[i + 1] * t
        return out

    def _load_scene(self, options: dict):
        super()._load_scene(options)
        self.original_points = self._ref_points()
        # outline visual: thin boxes along each polyline segment
        b = self.scene.create_actor_builder()
        poly = self._poly
        for i in range(len(poly) - 1):
            a, c = poly[i], poly[i + 1]
            mid = (a + c) / 2
            length = np.linalg.norm(c - a)
            if length < 1e-6:
                continue
            ang = np.arctan2(c[1] - a[1], c[0] - a[0])
            quat = np.array([np.cos(ang / 2), 0, 0, np.sin(ang / 2)])
            b.add_box_visual(
                pose=np.concatenate([[mid[0], mid[1], 0.0], quat]),
                half_size=[length / 2, 0.004, 0.0005], color=[0.1, 0.1, 0.6, 1.0],
            )
        b.set_initial_pose([0, 0, 0.011, 1, 0, 0, 0])
        self.goal_outline = b.build_kinematic(name="goal_outline")

        self.scene.register_extra("svg_points", (N_REF, 2))
        self.scene.register_extra("ref_hit", (N_REF,), torch.bool)

    def _after_reconfigure(self, options: dict):
        super()._after_reconfigure(options)
        self._original_points = torch.as_tensor(self.original_points, device=self.device)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        super()._initialize_episode(env_idx, options)
        rng = self._batched_episode_rng
        target_xy = rng.uniform(0.0, 0.04, (2,)) - 0.1
        target = torch.cat([target_xy, torch.full_like(target_xy[:, :1], 0.011)], -1)
        qs = rng.quaternions(lock_x=True, lock_y=True)
        self.goal_outline.set_pose(Pose.create_from_pq(target, qs))

        mats = rc.quaternion_to_matrix(qs)[:, :2, :2]  # (B, 2, 2)
        pts = torch.einsum("bij,vj->bvi", mats, self._original_points) + target[:, None, :2]
        self.scene.set_extra("svg_points", pts)
        self.scene.set_extra("ref_hit", torch.zeros((), dtype=torch.bool, device=self.device))

    def _after_control_step(self):
        super()._after_control_step()
        self._mark_hits("svg_points")

    def evaluate(self):
        return {"success": self.scene.data.extras["ref_hit"].all(-1)}

    def compute_sparse_reward(self, obs, action, info):
        return info["success"].to(torch.float32)

    def _get_obs_extra(self, info: dict):
        obs = dict(tcp_pose=self.agent.tcp_pose.raw_pose)
        if "state" in self.obs_mode:
            obs.update(
                goal_pose=self.goal_outline.pose.raw_pose,
                points=self.scene.data.extras["svg_points"].reshape(self.num_envs, -1),
            )
        return obs
