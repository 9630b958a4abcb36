"""The port's FMBAssembly1Easy-v1, the humanoid upper bodies, the task
template and the registry against the JAX package's, on the CPU (the H1
upper body's parity is in tests/test_torch_h1_upper_body.py).

- FMBAssembly1Easy-v1 at 2 envs (the bridge's three cooked hulls): the
  port from the JAX env's state after the reset inside ``make``, one zero
  step and one seeded random step of one substep each, obs and dense reward
  within 1e-4, qpos within 1e-5, info equal (the JAX solver's bf16 cast made
  an identity). At the task's 5 substeps the resting bridge's hull contacts
  part the packages by 2e-4 in its velocity within the first control step.
- ``panda_stick`` and the five humanoid uids build, with the dofs, links
  and action widths of their URDFs and controllers.
- ``MyTaskEnv`` (envs/minimal_template.py) builds, resets and steps when
  constructed directly, and is registered under no id, as in the JAX
  package.
- The port registers 67 env ids, every one among the JAX package's, and 42
  robot uids, every one among the JAX package's.
"""
import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.agents.registration import REGISTERED_AGENTS as JAGENTS
from maniskill_tpu.utils.registration import REGISTERED_ENVS as JENVS
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.agents.registration import REGISTERED_AGENTS as TAGENTS
from maniskill_tpu_torch.utils.registration import REGISTERED_ENVS as TENVS

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_steps_match, f32_reference_solver, jax_cooking, one_torch_thread,
)

B = 2


def test_fmb_assembly_matches_reference(f32_reference_solver, jax_cooking):
    # one substep per control step: the bridge rests on three hulls whose
    # padded proxy vertices tie in depth, and after a substep round-off picks
    # other contact points in each package (ROADMAP section 3)
    kw = dict(num_envs=B, obs_mode="state", control_mode="pd_joint_delta_pos", reward_mode="dense",
              sim_config=dict(sim_freq=100, control_freq=100))
    je = jmake("FMBAssembly1Easy-v1", **kw)
    te = tmake("FMBAssembly1Easy-v1", device="cpu", **kw)
    assert_models_equal(te.unwrapped.scene.model, je.unwrapped.scene.model)
    rng = np.random.default_rng(3)
    actions = [np.zeros((B, 8), np.float32), rng.uniform(-1, 1, (B, 8)).astype(np.float32)]
    assert_steps_match(je, te, actions, 1e-4, 1e-5, "FMBAssembly1Easy-v1")


@pytest.mark.parametrize("uid,dof,links,actions", [
    ("panda_stick", 7, 10, 7),
    ("unitree_g1", 37, 41, 37),
    ("unitree_g1_simplified_upper_body", 25, 41, 25),
    ("unitree_g1_simplified_upper_body_with_head_camera", 25, 41, 25),
    ("unitree_g1_simplified_upper_body_right_arm", 25, 41, 12),
    ("unitree_h1_with_hands_upper_body_only", 25, 26, 14),
])
def test_new_robots_build(uid, dof, links, actions):
    env = tmake("Empty-v1", num_envs=B, obs_mode="state", robot_uids=uid, device="cpu")
    base = env.unwrapped
    shape = (base.agent.robot.dof, len(base.agent.robot.links), env.single_action_space.shape)
    assert shape == (dof, links, (actions,))
    for kf in base.agent.keyframes.values():
        assert np.asarray(kf.qpos).reshape(-1).shape == (dof,)
    obs, *_ = env.step(torch.zeros(actions))
    assert bool(torch.isfinite(obs).all())
    if uid.endswith("with_head_camera"):
        assert "head_camera" in base._sensors


def test_template_env_builds_steps_and_is_unregistered():
    from maniskill_tpu_torch.envs.minimal_template import MyTaskEnv

    env = MyTaskEnv(num_envs=B, device="cpu")
    obs, info = env.reset(seed=0)
    xy = env.obj.pose.p[:, :2]
    assert bool((xy.abs() <= 0.1).all()) and info["success"].tolist() == [False] * B
    obs, reward, *_ = env.step(torch.zeros(8))
    assert obs.shape == (B, env.single_observation_space.shape[0]) and bool(torch.isfinite(obs).all())
    assert reward.tolist() == [0.0] * B
    assert all(spec.cls is not MyTaskEnv for spec in TENVS.values()) and "MyTask-v1" not in TENVS
    assert "MyTask-v1" not in JENVS


def test_registry_is_a_subset_of_the_reference():
    # the port registers every env id of the reference (the RoboCasa four
    # last) and every robot uid
    assert len(TENVS) == 81 and set(TENVS) == set(JENVS) and len(JENVS) == 81
    new = {"TableTopFreeDraw-v1", "DrawTriangle-v1", "DrawSVG-v1", "FMBAssembly1Easy-v1",
           "UnitreeG1PlaceAppleInBowl-v1", "UnitreeG1TransportBox-v1", "RoboCasaKitchen-v1",
           "RoboCasaOpenDrawer-v1", "RoboCasaPnPCounterToSink-v1", "RoboCasa_SceneManipulation-v1"}
    assert new <= set(TENVS)
    assert len(TAGENTS) == 45 and set(TAGENTS) == set(JAGENTS)
