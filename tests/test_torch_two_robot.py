"""The port's MultiAgent and its two two-robot tasks (TwoRobotPickCube-v1,
TwoRobotStackCube-v1) against the JAX package's, at 4 envs on the CPU.

- Layout: the action space is a dict of the two agents' spaces keyed
  ``panda-0`` and ``panda-1`` (the same names, shapes and bounds as the JAX
  package's), the proprioception a dict of the same keys, the state-dict
  obs the same tree of the same shapes, and the flat state obs of the same
  width; each robot stands at its own base pose.
- Steps: both packages start from the JAX env's state after the reset
  inside ``make`` (through ``reset_to_env_states``, both robots) and take 4
  steps of the same seeded random dict ``pd_joint_delta_pos`` actions: obs
  and the normalized dense reward within 1e-4, ``success`` equal,
  ``contact.overflow == 0``. One agent's action reaches only its own robot.
Each JAX env is made once, its solver's bf16 cast made an identity.
"""
import numpy as np
import pytest
import torch

import jax
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.agents.base_agent import MultiAgent

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_obs_close, f32_reference_solver, one_torch_thread, tree,
)

B = 4
STEPS = 4
TASKS = ["TwoRobotPickCube-v1", "TwoRobotStackCube-v1"]
KW = dict(num_envs=B, obs_mode="state_dict", control_mode="pd_joint_delta_pos")


@pytest.fixture(scope="module")
def jax_env(f32_reference_solver):
    envs = {}

    def get(env_id):
        if env_id not in envs:
            envs[env_id] = jmake(env_id, **KW)
        return envs[env_id]

    return get


def _actions(rng):
    return {f"panda-{i}": rng.uniform(-1, 1, (B, 8)).astype(np.float32) for i in range(2)}


def test_multi_agent_layout(jax_env):
    je = jax_env("TwoRobotPickCube-v1")
    te = tmake("TwoRobotPickCube-v1", device="cpu", **KW)
    jb, tb = je.unwrapped, te.unwrapped
    assert isinstance(tb.agent, MultiAgent)
    tspace, jspace = tb.single_action_space, jb.single_action_space
    assert sorted(tspace.spaces) == sorted(jspace.spaces) == ["panda-0", "panda-1"]
    for k in jspace.spaces:
        np.testing.assert_array_equal(tspace[k].low, jspace[k].low)
        np.testing.assert_array_equal(tspace[k].high, jspace[k].high)
    assert tb.action_space["panda-1"].shape == (B, 8)
    assert sorted(tb.agent.get_proprioception()) == ["panda-0", "panda-1"]
    assert tb.control_mode == {"panda-0": "pd_joint_delta_pos", "panda-1": "pd_joint_delta_pos"}
    tobs = tb.get_obs()
    jleaves = jax.tree_util.tree_leaves_with_path(jb._init_raw_obs)
    assert len(jleaves) == len(jax.tree_util.tree_leaves(tobs))
    for path, jv in jleaves:
        tv = tobs
        for p in path:
            tv = tv[p.key]
        assert tuple(tv.shape) == np.shape(jv), path
    flat = tmake("TwoRobotPickCube-v1", device="cpu", **dict(KW, obs_mode="state")).unwrapped
    assert flat.single_observation_space.shape == jmake_state_width(jb)
    # each robot at its own base: left at y = -0.75, right at y = +0.75
    left, right = (a.robot.links[0].pose.p for a in tb.agent.agents)
    assert torch.allclose(left[:, 1], torch.tensor(-0.75)) and torch.allclose(right[:, 1], torch.tensor(0.75))
    # one agent's action reaches only its own robot: its first joint turns
    q0 = [a.robot.qpos[:, 0].clone() for a in tb.agent.agents]
    act = {"panda-0": torch.zeros(B, 8), "panda-1": torch.zeros(B, 8)}
    act["panda-1"][:, 0] = 1.0
    te.step(act)
    moved = [float((a.robot.qpos[:, 0] - q).abs().max()) for a, q in zip(tb.agent.agents, q0)]
    assert moved[1] > 10 * moved[0], moved


def jmake_state_width(jb):
    """The width of the JAX env's flat state obs (its state-dict obs
    flattened)."""
    return (sum(int(np.prod(np.shape(v)[1:])) for v in jax.tree_util.tree_leaves(jb._init_raw_obs)),)


@pytest.mark.parametrize("env_id", TASKS)
def test_two_robot_task_matches_reference(env_id, jax_env):
    je = jax_env(env_id)
    te = tmake(env_id, device="cpu", **KW)
    jb, tb = je.unwrapped, te.unwrapped
    assert_models_equal(tb.scene.model, jb.scene.model)
    tobs, _ = te.reset(seed=3, options=dict(reset_to_env_states=tree(
        jb.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))))
    np.testing.assert_array_equal(tb.scene.data.qpos.numpy(), np.asarray(jb.scene.data.qpos))
    assert_obs_close(tobs, jb._init_raw_obs, 1e-6, f"{env_id} reset")
    rng = np.random.default_rng(5)
    for _ in range(STEPS):
        action = _actions(rng)
        jobs, jrew, _, _, jinfo = je.step(action)
        tobs, trew, _, _, tinfo = te.step({k: torch.as_tensor(v) for k, v in action.items()})
    assert_obs_close(tobs, jobs, 1e-4, env_id)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tinfo["success"].numpy(), np.asarray(jinfo["success"]))
    assert tb.scene.data.contact.overflow.tolist() == [0] * B
    assert np.abs(np.asarray(jb.scene.data.qvel)).max() > 0.1, "nothing moved"
