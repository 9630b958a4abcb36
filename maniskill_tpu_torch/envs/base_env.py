"""BaseEnv: the batched environment core (counterpart of
maniskill_tpu/envs/base_env.py).

The reconfigure lifecycle builds a static ``Model`` once on the env's
``device``; ``step`` then runs the controller, ``sim_steps_per_control``
physics substeps (a Python loop), forward kinematics, evaluation,
observation and reward as eager torch ops on that device. Everything is
batched over num_envs; obs/reward/terminated come back as tensors on the
device.

``device`` defaults to "cuda" and is never chosen quietly: without CUDA the
env runs on the CPU only when it is passed ``device="cpu"``.
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from .. import physics as phys
from ..agents.base_agent import BaseAgent, MultiAgent
from ..agents.registration import get_agent_class
from ..structs.types import SimConfig, merge_sim_config
from ..utils import common, gym_utils
from .scene import ManiSkillScene
from .utils.observations import parse_obs_mode_to_struct, sensor_data_to_pointcloud
from .utils.randomization.batched_rng import BatchedRNG


class BaseEnv:
    """Batched robot-manipulation environment base class."""

    SUPPORTED_OBS_MODES = ("state", "state_dict", "none", "rgb", "depth",
                           "segmentation", "rgbd", "rgb+depth",
                           "rgb+depth+segmentation", "rgb+segmentation",
                           "depth+segmentation", "pointcloud")
    SUPPORTED_REWARD_MODES = ("normalized_dense", "dense", "sparse", "none")

    agent: BaseAgent

    def __init__(
        self,
        num_envs: int = 1,
        obs_mode: Optional[str] = None,
        reward_mode: Optional[str] = None,
        control_mode: Optional[str] = None,
        render_mode: Optional[str] = None,
        robot_uids: Union[str, type, None] = None,
        sim_config: Union[SimConfig, dict, None] = None,
        sensor_configs: Optional[dict] = None,
        human_render_camera_configs: Optional[dict] = None,
        enable_shadow: bool = False,
        sim_backend: str = "auto",
        render_backend: str = "auto",
        parallel_in_single_scene: bool = False,
        reconfiguration_freq: Optional[int] = None,
        enhanced_determinism: bool = False,
        device: Union[str, torch.device, None] = None,
        **kwargs,
    ):
        # enable_shadow .. enhanced_determinism and any other keyword are
        # taken as the JAX package's BaseEnv takes them (it stores
        # enable_shadow and reads none of them); the port has one backend
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the env on the CPU"
            )
        self.num_envs = num_envs
        self.obs_mode = obs_mode or "state"
        self.reward_mode = reward_mode or self.SUPPORTED_REWARD_MODES[0]
        self.render_mode = render_mode
        self._control_mode = control_mode
        self.robot_uids = robot_uids
        self._enable_shadow = enable_shadow
        self._sensor_config_overrides = sensor_configs or {}
        self._human_render_camera_config_overrides = human_render_camera_configs or {}
        # rebuild the scene every this many full resets (0: never)
        self.reconfiguration_freq = reconfiguration_freq or 0
        self._reconfig_counter = 0

        # arbitrary "+"-combos of visual modalities are valid obs modes
        known = {"rgb", "depth", "segmentation", "position", "normal", "albedo", "state"}
        parts = set(self.obs_mode.split("+"))
        if self.obs_mode not in self.SUPPORTED_OBS_MODES and not (parts and parts <= known):
            raise ValueError(f"unsupported obs mode {self.obs_mode}")
        if self.reward_mode not in self.SUPPORTED_REWARD_MODES:
            raise ValueError(f"unsupported reward mode {self.reward_mode}")

        self.sim_config = merge_sim_config(self._default_sim_config, sim_config)
        self.sim_freq = self.sim_config.sim_freq
        self.control_freq = self.sim_config.control_freq
        if self.sim_freq % self.control_freq != 0:
            raise ValueError("sim_freq must be a multiple of control_freq")

        self._hidden_objects: List = []
        self._elapsed_steps = torch.zeros(num_envs, dtype=torch.int32, device=self.device)
        self._episode_seeds = torch.zeros(num_envs, dtype=torch.int64, device=self.device)
        self._main_rng: Optional[np.random.RandomState] = None

        self._reconfigure({})
        # a robot-free env has an empty action space
        self.single_action_space = (self.agent.single_action_space if self.agent is not None
                                    else gym_utils.Box(-1.0, 1.0, (0,)))
        self.action_space = gym_utils.batch_space(self.single_action_space, num_envs)

        # first reset to derive the observation space
        obs, _ = self.reset(seed=2022, options=dict(reconfigure=False))
        self._init_raw_obs = obs  # a sample the wrappers derive their spaces from
        self.single_observation_space = gym_utils.convert_observation_to_space(obs)
        self.observation_space = gym_utils.batch_space(self.single_observation_space, num_envs)

    # ==================================================================
    # configuration properties (overridden by tasks)
    # ==================================================================
    @property
    def _default_sim_config(self) -> SimConfig:
        return SimConfig()

    @property
    def _default_sensor_configs(self):
        return []

    @property
    def _default_human_render_camera_configs(self):
        return []

    @property
    def control_mode(self):
        return self.agent.control_mode if self.agent is not None else None

    @property
    def obs_mode_struct(self):
        """Which modalities the obs mode asks for (``parse_obs_mode_to_struct``)."""
        return parse_obs_mode_to_struct(self.obs_mode)

    @property
    def elapsed_steps(self):
        return self._elapsed_steps

    @property
    def unwrapped(self):
        return self

    # ==================================================================
    # reconfigure lifecycle
    # ==================================================================
    def _reconfigure(self, options: dict):
        """Build the scene: agent, task objects, lighting, the model,
        controllers, sensors, then the task's ``_after_reconfigure`` (per-env
        tables written into the finished model) and the render meshes."""
        sc = self.sim_config.scene_config
        self.scene = ManiSkillScene(
            num_envs=self.num_envs,
            sim_timestep=1.0 / self.sim_freq,
            solver_iterations=sc.solver_position_iterations,
            gravity=sc.gravity,
            device=self.device,
        )
        self.scene.sim_steps_per_control = self.sim_config.sim_steps_per_control
        self.scene.default_restitution = self.sim_config.default_materials_config.restitution
        self.agent = None
        self._load_agent(options)
        self._load_scene(options)
        self._load_lighting(options)
        model = self.scene.finalize()
        self.scene.model = model.replace(
            contact_slop=sc.contact_slop,
            baumgarte=sc.baumgarte,
            contact_margin=sc.contact_offset,
            bounce_threshold=sc.bounce_threshold,
        )
        if self.agent is not None:
            self.agent._setup_controllers()
        self._setup_sensors()
        self._after_reconfigure(options)
        # build the render meshes now, at construction time
        for cam in self._sensors.values():
            cam._get_mesh(tuple(self._hidden_objects))
        self._data0 = self._make_initial_data()
        self.scene.bind(self._data0)

    def _make_initial_data(self) -> phys.Data:
        model = self.scene.model
        qpos0 = phys.default_qpos(model)
        data = phys.make_data(model, self.num_envs, qpos0)
        for actor in self.scene.actors.values():
            if actor.is_static or actor.initial_pose is None:
                continue
            if actor._mocap_idx is not None:
                # dof-less marker: its pose lives in Data.mocap_pose
                data.mocap_pose[:, actor._mocap_idx] = torch.as_tensor(
                    actor.initial_pose, device=self.device
                )
                continue
            qa = int(model.body_q_adr[actor.body_id])
            data.qpos[:, qa : qa + 7] = torch.as_tensor(actor.initial_pose, device=self.device)
        for name, (shape, dtype) in getattr(self.scene, "extra_specs", {}).items():
            data.extras[name] = torch.zeros((self.num_envs,) + shape, dtype=dtype, device=self.device)
        return data

    def _load_agent(self, options: dict, initial_agent_poses=None):
        """One agent, or with a list of robot uids a ``MultiAgent`` whose
        agent i is named ``uid-i`` and stands at ``initial_agent_poses[i]``;
        none where ``robot_uids`` is None (a robot-free env)."""
        uids = self.robot_uids
        if uids is None:
            return
        if not isinstance(uids, (list, tuple)):
            uids, initial_agent_poses = [uids], [initial_agent_poses]
        agents = []
        for i, uid in enumerate(uids):
            cls = uid if isinstance(uid, type) else get_agent_class(uid)
            pose = None
            if initial_agent_poses is not None and i < len(initial_agent_poses):
                pose = initial_agent_poses[i]
            agents.append(cls(self.scene, control_mode=self._control_mode,
                              agent_idx=i if len(uids) > 1 else None, initial_pose=pose))
        self.agent = agents[0] if len(agents) == 1 else MultiAgent(agents)

    def _load_scene(self, options: dict):
        pass

    def _before_control_step(self):
        """Task hook run at the top of each control step, before the action
        is applied (a digital twin re-poses its camera mount here)."""

    def _after_control_step(self):
        """Task hook run after the physics substeps and their forward
        kinematics, before ``get_info`` (a drawing task lays its ink here)."""

    def _after_reconfigure(self, options: dict):
        """Task hook run after the model is built, before the render meshes:
        per-env tables (hulls, masses) are written here."""

    def _load_lighting(self, options: dict):
        self.scene.set_ambient_light([0.3, 0.3, 0.3])
        self.scene.add_directional_light([1, 1, -1], [1, 1, 1])
        self.scene.add_directional_light([0, 0, -1], [1, 1, 1])

    def _setup_sensors(self):
        from ..sensors.camera import Camera, parse_camera_configs, update_camera_configs_from_dict

        configs = parse_camera_configs(self._default_sensor_configs)
        # cameras the robots carry (a wrist camera)
        for agent in getattr(self.agent, "agents", [self.agent] if self.agent is not None else []):
            configs.update(parse_camera_configs(getattr(agent, "_sensor_configs", [])))
        update_camera_configs_from_dict(configs, self._sensor_config_overrides)
        self._sensor_configs = configs
        self._sensors = {name: Camera(cfg, self.scene) for name, cfg in configs.items()}
        self.scene.sensors = self._sensors
        hr_configs = parse_camera_configs(self._default_human_render_camera_configs)
        update_camera_configs_from_dict(hr_configs, self._human_render_camera_config_overrides)
        self._human_render_cameras = {
            name: Camera(cfg, self.scene) for name, cfg in hr_configs.items()
        }
        self.scene.human_render_cameras = self._human_render_cameras

    # ==================================================================
    # reset
    # ==================================================================
    def reset(self, seed=None, options=None):
        """Reset the envs that ``options["env_idx"]`` selects (indices, or a
        (num_envs,) bool tensor that stays on the device), all by default."""
        options = options or {}
        self._set_main_rng(seed)
        mask = self.env_idx_mask(options.get("env_idx", None))

        # per-env episode seeds: an explicit list/array sets them directly so
        # replay reproduces episodes; an int seeds env i with seed + i
        if isinstance(seed, (list, tuple, np.ndarray)):
            explicit = np.asarray(seed, np.int64).reshape(-1)
            host_mask = mask.cpu().numpy()
            seeds = self._episode_seeds.cpu().numpy()
            if len(explicit) == int(host_mask.sum()):
                seeds[host_mask] = explicit
            elif len(explicit) == self.num_envs:
                seeds[host_mask] = explicit[host_mask]
            else:
                seeds[host_mask] = np.resize(explicit, int(host_mask.sum()))
            new_seeds = torch.as_tensor(seeds, device=self.device)
        elif seed is not None:
            new_seeds = seed + torch.arange(self.num_envs, dtype=torch.int64, device=self.device)
        else:
            new_seeds = torch.as_tensor(
                self._main_rng.randint(0, 2**31, size=self.num_envs).astype(np.int64), device=self.device
            )
        self._episode_seeds = torch.where(mask, new_seeds, self._episode_seeds)

        # a rebuild of the scene: asked for, or every reconfiguration_freq-th
        # full reset; it draws the task's objects from the main RNG just seeded
        reconfigure = options.get("reconfigure", False)
        if self.reconfiguration_freq > 0 and options.get("env_idx", None) is None:
            self._reconfig_counter += 1
            if self._reconfig_counter >= self.reconfiguration_freq:
                reconfigure = True
                self._reconfig_counter = 0
        if reconfigure:
            self._reconfigure(options)

        obs, info = self._reset_impl(mask, self._episode_seeds,
                                     options.get("reset_to_env_states", None))
        self._elapsed_steps = torch.where(mask, 0, self._elapsed_steps)
        return obs, info

    def env_idx_mask(self, env_idx) -> torch.Tensor:
        """``env_idx`` (None for every env, indices, or a (num_envs,) bool
        tensor) as a (num_envs,) bool mask on the device."""
        if isinstance(env_idx, torch.Tensor) and env_idx.dtype == torch.bool:
            return env_idx.to(self.device)
        host = np.ones(self.num_envs, bool)
        if env_idx is not None:
            host[:] = False
            host[np.asarray(env_idx)] = True
        return torch.as_tensor(host, device=self.device)

    def _reset_impl(self, mask: torch.Tensor, seeds: torch.Tensor, reset_state=None):
        """Reset the envs where the (num_envs,) bool ``mask`` is set, drawing
        their episode from the (num_envs,) int64 ``seeds``; both stay on the
        device, so a masked reset inside a rollout makes no host sync.
        Returns (obs, info) of every env; elapsed steps are the caller's."""
        scene = self.scene
        scene._reset_mask = mask
        self._batched_episode_rng = BatchedRNG.from_seeds(seeds)
        data = scene.data

        # clear velocities, drive targets and extras of the resetting envs
        scene.data = data.replace(
            qvel=scene.masked(torch.zeros_like(data.qvel), data.qvel),
            drive_target=scene.masked(torch.zeros_like(data.drive_target), data.drive_target),
            drive_vel_target=scene.masked(
                torch.zeros_like(data.drive_vel_target), data.drive_vel_target
            ),
            extras={k: scene.masked(torch.zeros_like(v), v) for k, v in data.extras.items()},
        )
        if reset_state is not None:
            self.set_state_dict(reset_state)
        else:
            self._initialize_episode(torch.arange(self.num_envs, device=self.device), {})
        scene.data = phys.forward(scene.model, scene.data)
        if self.agent is not None:
            self.agent.controller.reset()
        scene._reset_mask = None

        info = self.get_info()
        return self.get_obs(info), info

    def _set_main_rng(self, seed):
        if seed is None:
            if self._main_rng is not None:
                return
            seed = np.random.RandomState().randint(2**31)
        if isinstance(seed, (list, tuple, np.ndarray)):
            seed = int(np.asarray(seed).reshape(-1)[0])
        self._main_rng = np.random.RandomState(seed)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        pass

    # ==================================================================
    # step
    # ==================================================================
    def step(self, action):
        """One control step. A multi-agent env takes a dict of actions keyed
        by agent name; an unbatched action is broadcast to every env."""
        space = self.single_action_space
        if isinstance(action, dict):
            action = {k: self._batched_action(v, space[k].shape) for k, v in action.items()}
        else:
            action = self._batched_action(action, space.shape)
        obs, reward, terminated, info = self._step_impl(action)
        self._elapsed_steps = self._elapsed_steps + 1
        truncated = torch.zeros(self.num_envs, dtype=torch.bool, device=self.device)
        info = dict(info)
        info["elapsed_steps"] = self._elapsed_steps
        return obs, reward, terminated, truncated, info

    def _batched_action(self, action, shape) -> torch.Tensor:
        action = common.to_tensor(action, device=self.device, dtype=torch.float32)
        if action.ndim == len(shape):
            action = action.expand((self.num_envs,) + tuple(shape))
        return action

    def _step_impl(self, action):
        """One control step of a (num_envs, A) action (a dict of them for a
        multi-agent env) on the scene's state:
        (obs, reward, terminated, info). Elapsed steps are the caller's."""
        scene = self.scene
        scene._reset_mask = None
        self._before_control_step()
        if self.agent is not None:
            self.agent.set_action(action)
        model = scene.model
        d = scene.data
        for i in range(self.sim_config.sim_steps_per_control):
            if self.agent is not None:
                d = self.agent.before_simulation_step(d, i)
            d = phys.step(model, d)
        scene.bind(phys.forward_kinematics(model, d))
        self._after_control_step()

        info = self.get_info()
        obs = self.get_obs(info)
        reward = self.get_reward(obs=obs, action=action, info=info)
        return obs, reward, self._get_terminated(info), info

    def _get_terminated(self, info: dict) -> torch.Tensor:
        success = info.get("success", None)
        fail = info.get("fail", None)
        if success is not None and fail is not None:
            return success | fail
        if success is not None:
            return success
        if fail is not None:
            return fail
        return torch.zeros(self.num_envs, dtype=torch.bool, device=self.device)

    # ==================================================================
    # observations
    # ==================================================================
    def get_obs(self, info: Optional[dict] = None):
        if info is None:
            info = self.get_info()
        if self.obs_mode == "none":
            return {}
        if self.obs_mode == "state":
            return common.flatten_state_dict(self._get_obs_state_dict(info))
        if self.obs_mode == "state_dict":
            return self._get_obs_state_dict(info)
        return self._get_obs_with_sensor_data(info)

    def _get_obs_state_dict(self, info: dict):
        return dict(agent=self._get_obs_agent(), extra=self._get_obs_extra(info))

    def _get_obs_agent(self):
        return self.agent.get_proprioception() if self.agent is not None else {}

    def _get_obs_extra(self, info: dict):
        return {}

    def _get_obs_with_sensor_data(self, info: dict):
        struct = parse_obs_mode_to_struct(self.obs_mode)
        sensor_data, params = {}, {}
        for name, sensor in self._sensors.items():
            sensor_data[name] = sensor.get_obs(
                rgb=struct["rgb"], depth=struct["depth"],
                segmentation=struct["segmentation"], position=struct["position"],
                normal=struct["normal"], albedo=struct["albedo"],
                hidden_actors=self._hidden_objects,
            )
            params[name] = sensor.get_params()
        obs = dict(
            agent=self._get_obs_agent(),
            extra=self._get_obs_extra(info),
            sensor_param=params,
            sensor_data=sensor_data,
        )
        if self.obs_mode == "pointcloud":
            obs = sensor_data_to_pointcloud(obs)
        return obs

    # ==================================================================
    # rewards
    # ==================================================================
    def get_reward(self, obs, action, info):
        mode = self.reward_mode
        if mode == "none":
            return torch.zeros(self.num_envs, device=self.device)
        if mode == "sparse":
            return self.compute_sparse_reward(obs=obs, action=action, info=info)
        if mode == "dense":
            return self.compute_dense_reward(obs=obs, action=action, info=info)
        return self.compute_normalized_dense_reward(obs=obs, action=action, info=info)

    def compute_sparse_reward(self, obs, action, info):
        reward = torch.zeros(self.num_envs, device=self.device)
        if "success" in info:
            reward = reward + info["success"].to(torch.float32)
        if "fail" in info:
            reward = reward - info["fail"].to(torch.float32)
        return reward

    def compute_dense_reward(self, obs, action, info):
        raise NotImplementedError(f"{type(self).__name__} does not implement dense rewards")

    def compute_normalized_dense_reward(self, obs, action, info):
        raise NotImplementedError(
            f"{type(self).__name__} does not implement normalized dense rewards"
        )

    # ==================================================================
    # info / evaluation
    # ==================================================================
    def get_info(self):
        return dict(self.evaluate())

    def evaluate(self) -> dict:
        return {}

    # ==================================================================
    # sim state checkpointing
    # ==================================================================
    def get_state_dict(self) -> dict:
        state = self.scene.get_sim_state()
        ctrl = self.agent.controller.get_state() if self.agent is not None else None
        if ctrl:
            state["controller"] = ctrl
        return state

    def set_state_dict(self, state: dict):
        self.scene.set_sim_state(state)
        if "controller" in state:
            self.agent.controller.set_state(state["controller"])
        self.scene.data = phys.forward(self.scene.model, self.scene.data)

    def get_state(self) -> torch.Tensor:
        """Flat (B, D) state vector with fixed ordering (the controller's
        state left out)."""
        return common.flatten_state_dict({k: v for k, v in self.get_state_dict().items() if k != "controller"})

    # ==================================================================
    # render
    # ==================================================================
    def render(self):
        """The frame of ``render_mode``: "rgb_array" the human-render cameras,
        "sensors" the sensors, "all" both concatenated along the width,
        "human" the human-render frame, also shown in a matplotlib window
        where matplotlib is installed and its backend is not Agg."""
        if self.render_mode is None:
            raise RuntimeError("render_mode was not set")
        if self.render_mode == "rgb_array":
            return self.render_rgb_array()
        if self.render_mode == "sensors":
            return self.render_sensors()
        if self.render_mode == "all":
            return torch.cat([self.render_rgb_array(), self.render_sensors()], 2)
        if self.render_mode == "human":
            frame = self.render_rgb_array()
            if frame is not None:
                self._show(frame)
            return frame
        raise NotImplementedError(self.render_mode)

    def _show(self, frame: torch.Tensor):
        """Env 0's frame in a matplotlib window (the reference opens its
        viewer here); nothing where matplotlib is missing or draws to Agg."""
        try:
            import matplotlib
        except ImportError:
            return
        if matplotlib.get_backend().lower() == "agg":
            return
        import matplotlib.pyplot as plt

        img = frame[0].cpu().numpy()
        if not hasattr(self, "_viewer_fig"):
            plt.ion()
            self._viewer_fig, self._viewer_ax = plt.subplots()
            self._viewer_im = self._viewer_ax.imshow(img)
            self._viewer_ax.axis("off")
        else:
            self._viewer_im.set_data(img)
        self._viewer_fig.canvas.draw_idle()
        plt.pause(0.001)

    def render_rgb_array(self):
        """The human-render cameras' rgb, concatenated along the width (marker
        objects shown: only sensor captures hide them)."""
        return self._render_cameras(self._human_render_cameras.values(), ())

    def render_sensors(self):
        """The sensors' rgb, concatenated along the width."""
        return self._render_cameras(self._sensors.values(), self._hidden_objects)

    @staticmethod
    def _render_cameras(cams, hidden):
        imgs = [cam.get_obs(rgb=True, hidden_actors=hidden)["rgb"] for cam in cams]
        if not imgs:
            return None
        return torch.cat(imgs, 2)

    def close(self):
        pass

    def print_sim_details(self):
        model = self.scene.model
        print(
            f"num_envs={self.num_envs} nbody={model.nbody} nq={model.nq} "
            f"nv={model.nv} ngeom={model.ngeom} npair={model.npair} "
            f"sim_freq={self.sim_freq} control_freq={self.control_freq}"
        )
