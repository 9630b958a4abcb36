"""Camera sensor (counterpart of maniskill_tpu/sensors/camera.py).

``Camera.get_obs`` renders the requested modalities with the batched
rasterizer and applies the "minimal" shader texture contract: rgb uint8,
depth int16 millimetres, segmentation int16, position int16 millimetres in
the OpenGL camera frame. A shader pack named ``rt*`` renders through the path
tracer (``render/pathtracer.py``) instead, with the same output keys.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..physics.kinematics import geom_poses
from ..render.rasterizer import SceneMesh, perspective_matrix, rasterize
from ..structs.actor import Actor
from ..structs.link import Link
from ..structs.pose import Pose
from ..utils.geometry import rotation_conversions as rc
from ..utils.scene_utils import ROS_TO_CV, ROS_TO_GL
from .base_sensor import BaseSensor


@dataclasses.dataclass
class CameraConfig:
    uid: str
    pose: Union[Pose, np.ndarray]
    width: int = 128
    height: int = 128
    fov: Optional[float] = None  # vertical fov (rad)
    near: float = 0.01
    far: float = 100.0
    intrinsic: Optional[np.ndarray] = None
    mount: Optional[Union[Actor, Link]] = None
    shader_pack: str = "minimal"

    def __post_init__(self):
        raw = self.pose.raw_pose if isinstance(self.pose, Pose) else self.pose
        raw = np.asarray(raw, np.float64)
        self.pose = raw[0] if raw.ndim > 1 else raw


def parse_camera_configs(configs) -> Dict[str, CameraConfig]:
    if configs is None:
        return {}
    if isinstance(configs, CameraConfig):
        return {configs.uid: configs}
    if isinstance(configs, dict):
        return dict(configs)
    return {c.uid: c for c in configs}


def update_camera_configs_from_dict(configs: Dict[str, CameraConfig], overrides: dict):
    """Per-camera or global config overrides."""
    if not overrides:
        return
    global_keys = {k: v for k, v in overrides.items() if not isinstance(v, dict)}
    for cfg in configs.values():
        for k, v in global_keys.items():
            setattr(cfg, k, v)
    for name, sub in overrides.items():
        if isinstance(sub, dict) and name in configs:
            for k, v in sub.items():
                setattr(configs[name], k, v)


class Camera(BaseSensor):
    def __init__(self, config: CameraConfig, scene):
        super().__init__(config)
        self.scene = scene
        H, W = config.height, config.width
        if config.intrinsic is not None:
            K = np.asarray(config.intrinsic, np.float64)
            self.fx, self.fy = K[0, 0], K[1, 1]
            self.cx, self.cy = K[0, 2], K[1, 2]
            fov = 2 * np.arctan(H / (2 * self.fy))
        else:
            fov = config.fov if config.fov is not None else np.pi / 2
            self.fy = self.fx = H / (2 * np.tan(fov / 2))
            self.cx, self.cy = W / 2, H / 2
        self.fov = fov
        dev = scene.device
        self.proj = torch.as_tensor(
            perspective_matrix(fov, W / H, config.near, config.far),
            dtype=torch.float32, device=dev,
        )
        # per-step constants, copied to the device once
        self._local_pose = torch.as_tensor(config.pose, dtype=torch.float32, device=dev)
        self._ros_to_gl = torch.as_tensor(ROS_TO_GL, dtype=torch.float32, device=dev)
        self._ros_to_cv = torch.as_tensor(ROS_TO_CV, dtype=torch.float32, device=dev)
        self._K = torch.tensor(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], dtype=torch.float32, device=dev,
        )
        self._mesh_cache: Dict[tuple, SceneMesh] = {}

    # -- pose ------------------------------------------------------------
    def world_pose(self) -> Pose:
        """Camera pose in world (ROS convention: +x forward), per env."""
        local = Pose(self._local_pose)
        if self.config.mount is not None:
            return self.config.mount.pose * local
        return Pose(local.raw_pose.expand(self.scene.num_envs, 7))

    def _view_matrix(self) -> torch.Tensor:
        """(B, 4, 4) world -> OpenGL camera."""
        inv = self.world_pose().inv()
        R = rc.quaternion_to_matrix(inv.q)  # (B, 3, 3) world -> ros cam
        gl = self._ros_to_gl
        B = R.shape[0]
        m = torch.zeros(B, 4, 4, device=R.device)
        m[:, :3, :3] = torch.einsum("ij,bjk->bik", gl, R)
        m[:, :3, 3] = torch.einsum("ij,bj->bi", gl, inv.p)
        m[:, 3, 3] = 1.0
        return m

    # -- rendering -------------------------------------------------------
    def _get_mesh(self, hidden_actors: Sequence = ()) -> SceneMesh:
        exclude = tuple(sorted(a.body_id for a in hidden_actors))
        if exclude not in self._mesh_cache:
            self._mesh_cache[exclude] = SceneMesh.build(
                self.scene.model, self.scene, exclude_body_ids=set(exclude)
            )
        return self._mesh_cache[exclude]

    def capture(self, hidden_actors: Sequence = (), want_normal=False, want_albedo=False,
                draws: Optional[dict] = None):
        """Render the buffers. An ``rt*`` pack path-traces; ``draws`` may hand
        it its ``jitter`` and ``bounce_draws`` (else they come from the scene's
        render seed)."""
        mesh = self._get_mesh(hidden_actors)
        gpos, gquat = geom_poses(self.scene.model, self.scene.data)
        wv = mesh.world_vertices(gpos, gquat)
        pack = self.config.shader_pack
        if pack.startswith("rt"):
            from ..render.pathtracer import RT_PACKS, pathtrace

            cfg = RT_PACKS.get(pack, RT_PACKS["rt-fast"])
            pose = self.world_pose()
            rot = torch.einsum("bij,jk->bik", rc.quaternion_to_matrix(pose.q), self._ros_to_gl.T)  # gl cam -> world
            return mesh, pathtrace(
                mesh, wv, pose.p, rot, self.fx, self.fy, self.cx, self.cy,
                self.config.height, self.config.width,
                spp=cfg["spp"], bounces=cfg["bounces"], denoise=cfg["denoise"],
                lights=self.scene.lights, seed=self.scene.render_seed(), **(draws or {}),
            )
        return mesh, rasterize(
            mesh,
            wv,
            self._view_matrix(),
            self.proj,
            self.config.height,
            self.config.width,
            lights=self.scene.lights,
            want_normal=want_normal,
            want_albedo=want_albedo,
        )

    def get_obs(
        self,
        rgb: bool = True,
        depth: bool = False,
        segmentation: bool = False,
        position: bool = False,
        normal: bool = False,
        albedo: bool = False,
        apply_texture_transforms: bool = True,
        hidden_actors: Sequence = (),
        draws: Optional[dict] = None,
    ) -> Dict[str, torch.Tensor]:
        _, buf = self.capture(hidden_actors, want_normal=normal, want_albedo=albedo, draws=draws)
        return self.obs_from_buffer(buf, rgb, depth, segmentation, position, normal, albedo)

    def obs_from_buffer(self, buf, rgb=True, depth=False, segmentation=False, position=False, normal=False,
                        albedo=False) -> Dict[str, torch.Tensor]:
        """The texture contract applied to a rendered buffer (``capture``'s)."""
        out = {}
        if rgb:
            out["rgb"] = (torch.clamp(buf["color"], 0, 1) * 255).to(torch.uint8)
        if depth:
            out["depth"] = torch.clamp(buf["depth"] * 1000.0, 0, 32767).to(torch.int16)[..., None]
        if segmentation:
            out["segmentation"] = buf["seg"].to(torch.int16)[..., None]
        if position:
            H, W = self.config.height, self.config.width
            dev = buf["depth"].device
            z = buf["depth"]
            xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5 - self.cx) / self.fx
            ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5 - self.cy) / self.fy
            pos = torch.stack([xs[None, None, :] * z, -ys[None, :, None] * z, -z], -1)
            out["position"] = torch.clamp(pos * 1000.0, -32767, 32767).to(torch.int16)
            out["position_valid"] = buf["valid"]
        if normal:
            out["normal"] = buf["normal"]
        if albedo:
            out["albedo"] = (torch.clamp(buf["albedo"], 0, 1) * 255).to(torch.uint8)
        return out

    def get_params(self) -> Dict[str, torch.Tensor]:
        """extrinsic_cv / cam2world_gl / intrinsic_cv."""
        pose = self.world_pose()
        dev = pose.raw_pose.device
        B = pose.raw_pose.shape[0]
        gl = self._ros_to_gl.T  # gl cam -> ros cam
        c2w = torch.zeros(B, 4, 4, device=dev)
        c2w[:, :3, :3] = torch.einsum("bij,jk->bik", rc.quaternion_to_matrix(pose.q), gl)
        c2w[:, :3, 3] = pose.p
        c2w[:, 3, 3] = 1.0
        cv = self._ros_to_cv
        inv = pose.inv()
        Rw = torch.einsum("ij,bjk->bik", cv, rc.quaternion_to_matrix(inv.q))
        tw = torch.einsum("ij,bj->bi", cv, inv.p)
        K = self._K
        return dict(
            extrinsic_cv=torch.cat([Rw, tw[..., None]], -1),
            cam2world_gl=c2w,
            intrinsic_cv=K.expand(B, 3, 3),
        )
