"""BaseAgent: robot wrapper (counterpart of maniskill_tpu/agents/base_agent.py).

An agent owns one Articulation plus a registry of controller configs keyed by
control mode. A robot is defined by a ``urdf_path`` (loaded by
``building/urdf_loader.py`` from the port's own ``assets/robots/``) or by a
procedural ``build_description()`` (a LinkSpec list), as in the JAX
package, whose ``mjcf_path`` no robot sets (``scene.create_mjcf_loader()``
loads MJCF files). ``MultiAgent`` drives several robots of one scene with
dict actions keyed by agent name.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Optional

import numpy as np
import torch

from ..structs.articulation import Articulation
from ..structs.pose import Pose
from ..utils import gym_utils
from .controllers import BaseController, CombinedController

if TYPE_CHECKING:
    from ..envs.scene import ManiSkillScene


@dataclasses.dataclass
class Keyframe:
    """Named rest configuration."""

    pose: np.ndarray  # (7,) root pose
    qpos: Optional[np.ndarray] = None
    qvel: Optional[np.ndarray] = None


class BaseAgent:
    uid: str = "base_agent"
    urdf_path: Optional[str] = None
    urdf_config: dict = {}
    fix_root_link: bool = True
    disable_self_collisions: bool = False
    keyframes: Dict[str, Keyframe] = {}

    def __init__(
        self,
        scene: "ManiSkillScene",
        control_mode: Optional[str] = None,
        agent_idx: Optional[int] = None,
        initial_pose=None,
    ):
        self.scene = scene
        self._agent_idx = agent_idx
        self.robot: Optional[Articulation] = None
        self._requested_control_mode = control_mode
        self.controller: Optional[BaseController] = None
        self.controllers: Dict[str, BaseController] = {}
        self._load_articulation(initial_pose)
        self._after_loading_articulation()

    @property
    def name(self) -> str:
        if self._agent_idx is not None:
            return f"{self.uid}-{self._agent_idx}"
        return self.uid

    def _load_articulation(self, initial_pose=None):
        """Build the robot: from ``urdf_path`` when it is set, else from
        ``build_description()``."""
        pose = None
        if initial_pose is not None:
            raw = np.asarray(Pose.create(initial_pose).raw_pose, np.float64)
            pose = raw[0] if raw.ndim > 1 else raw
        if self.urdf_path is not None:
            loader = self.scene.create_urdf_loader()
            loader.name = self.name
            loader.fix_root_link = self.fix_root_link
            loader.disable_self_collisions = self.disable_self_collisions
            self.robot = loader.load(self.urdf_path, initial_pose=pose)
            return
        builder = self.build_description()
        builder.fix_root_link = self.fix_root_link
        builder.disable_self_collisions = self.disable_self_collisions
        if pose is not None:
            builder.set_initial_pose(pose)
        self.robot = builder.build(self.name)

    def build_description(self):
        raise NotImplementedError(f"{type(self).__name__} must define urdf_path or build_description()")

    def _after_loading_articulation(self):
        """Robot hook run once the articulation is built."""

    # -- controllers -----------------------------------------------------
    @property
    def _controller_configs(self) -> Dict[str, object]:
        raise NotImplementedError

    @property
    def supported_control_modes(self):
        return list(self._controller_configs.keys())

    def _after_init(self):
        pass

    def _setup_controllers(self):
        """Instantiate the active controller (called after scene.finalize)."""
        self.set_control_mode(self._requested_control_mode or self.supported_control_modes[0])
        self._after_init()

    def set_control_mode(self, control_mode: str):
        if control_mode not in self._controller_configs:
            # never fall back to another mode
            raise NotImplementedError(
                f"{self.uid} has no control mode {control_mode!r}; "
                f"its modes: {self.supported_control_modes}"
            )
        configs = self._controller_configs[control_mode]
        balance_passive_force = True
        if isinstance(configs, dict):
            configs = dict(configs)
            balance_passive_force = configs.pop("balance_passive_force", True)
            controller = CombinedController(configs, self.robot, self.scene)
        else:
            controller = configs.controller_cls(configs, self.robot, self.scene)
        controller.set_drive_property()
        if balance_passive_force:
            # gravity-free robot links: a per-body mask in the dynamics,
            # updated through the host mirror
            m = self.scene.model
            gc = np.asarray(m.host_body_gravcomp, np.float32).copy()
            gc[[link.body_id for link in self.robot.links]] = 1.0
            self.scene.model = m.replace(
                body_gravcomp=torch.as_tensor(gc, device=self.scene.device),
                host_body_gravcomp=gc,
            )
        self.controllers[control_mode] = controller
        self.controller = controller
        self.control_mode = control_mode

    @property
    def action_space(self):
        return self.controller.action_space

    @property
    def single_action_space(self):
        return self.controller.action_space

    def set_action(self, action):
        self.controller.set_action(action)

    def before_simulation_step(self, data, substep):
        return self.controller.before_simulation_step(data, substep)

    # -- state -----------------------------------------------------------
    def get_proprioception(self) -> Dict:
        """qpos + qvel (+ controller state)."""
        obs = dict(qpos=self.robot.qpos, qvel=self.robot.qvel)
        ctrl_state = self.controller.get_state()
        if ctrl_state:
            obs["controller"] = ctrl_state
        return obs

    def reset(self, init_qpos=None):
        """Set joint positions (masked by the reset mask), zero velocities and
        reset the controller targets."""
        if init_qpos is not None:
            self.robot.set_qpos(init_qpos)
        self.robot.set_qvel(torch.zeros(self.scene.num_envs, self.robot.dof, device=self.scene.device))
        self.controller.reset()

    def get_state(self) -> Dict:
        return dict(robot=self.robot.get_state(), controller=self.controller.get_state())

    def set_state(self, state: Dict):
        self.robot.set_state(state["robot"])
        self.controller.set_state(state.get("controller", {}))

    # -- task helpers (overridden by robots) -----------------------------
    def is_grasping(self, object=None):
        raise NotImplementedError

    def is_static(self, threshold: float = 0.2):
        return torch.amax(torch.abs(self.robot.qvel), 1) <= threshold


class MultiAgent:
    """Several agents of one scene, keyed by their names (``uid-i``): dict
    action spaces, dict actions and per-agent proprioception."""

    def __init__(self, agents):
        self.agents = agents

    @property
    def action_space(self):
        return gym_utils.Dict({a.name: a.action_space for a in self.agents})

    @property
    def single_action_space(self):
        return self.action_space

    def set_action(self, action):
        for a in self.agents:
            a.set_action(action[a.name])

    def before_simulation_step(self, data, substep):
        for a in self.agents:
            data = a.before_simulation_step(data, substep)
        return data

    def get_proprioception(self):
        return {a.name: a.get_proprioception() for a in self.agents}

    def reset(self, init_qpos=None):
        for a in self.agents:
            a.reset()

    def get_state(self):
        return {a.name: a.get_state() for a in self.agents}

    def set_state(self, state):
        for a in self.agents:
            a.set_state(state[a.name])

    def _setup_controllers(self):
        for a in self.agents:
            a._setup_controllers()

    @property
    def robot(self):
        """The first agent's articulation."""
        return self.agents[0].robot

    @property
    def controller(self):
        """A view that resets, reads and writes every agent's controller, so
        env code treats a MultiAgent as one agent."""
        return _ControllersView(self.agents)

    @property
    def control_mode(self):
        return {a.name: a.control_mode for a in self.agents}


class _ControllersView:
    def __init__(self, agents):
        self._agents = agents

    def reset(self):
        for a in self._agents:
            a.controller.reset()

    def get_state(self):
        return {a.name: a.controller.get_state() for a in self._agents}

    def set_state(self, state):
        for a in self._agents:
            a.controller.set_state(state.get(a.name, {}))
