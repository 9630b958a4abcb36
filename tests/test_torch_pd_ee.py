"""The port's end-effector and joint-velocity control modes of the Panda
against the JAX package's, on PickCube-v1 at 4 envs on the CPU.

For each of ``pd_ee_delta_pos``, ``pd_ee_delta_pose``,
``pd_ee_target_delta_pos``, ``pd_ee_target_delta_pose`` and
``pd_joint_vel``, both packages start from the same state (the JAX
package's, after two random joint-delta steps, through
``set_state_dict``) and take the same seeded random actions:

- the drive targets after ``set_action`` agree within 1e-4 rad (IK modes)
  and the velocity targets within 1e-6 (``pd_joint_vel``);
- after 5 control steps, qpos agrees within 1e-4.

The JAX side switches its agent's control mode in place and runs the
controller and the physics substeps as its env's step does, each jitted
once, so one JAX env serves every mode. Its solver runs with the bf16
matvec cast made an identity (``f32_solver``, tests/test_torch_common.py).
"""
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu import physics as jphys
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake

from test_torch_common import f32_reference_solver, one_torch_thread, tree  # noqa: F401

B = 4
ENV = dict(obs_mode="state_dict", reward_mode="dense")
MODES = ["pd_ee_delta_pos", "pd_ee_delta_pose", "pd_ee_target_delta_pos", "pd_ee_target_delta_pose", "pd_joint_vel"]


@pytest.fixture(scope="module")
def jenv(f32_reference_solver):
    """The JAX env after two random joint-delta steps, its state, and the
    jitted physics of one control step (substeps, then FK)."""
    je = jmake("PickCube-v1", num_envs=B, control_mode="pd_joint_delta_pos", **ENV)
    je.reset(seed=11)
    rng = np.random.default_rng(11)
    for _ in range(2):
        je.step(rng.uniform(-1, 1, (B, 8)).astype(np.float32))
    base = je.unwrapped
    n_sub = base.sim_config.sim_steps_per_control

    def physics(model, d):
        for i in range(n_sub):
            d = jphys.step(model, d)
        return jphys.forward_kinematics(model, d)

    return base, base.scene.data, jax.jit(physics)


@pytest.mark.parametrize("mode", MODES)
def test_control_mode_matches_reference(jenv, mode):
    base, data0, physics = jenv
    scene, agent = base.scene, base.agent
    scene.bind(data0)
    agent.set_control_mode(mode)
    agent.controller.reset()
    state = tree(base.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))

    te = tmake("PickCube-v1", num_envs=B, device="cpu", control_mode=mode, **ENV)
    tb = te.unwrapped
    te.reset(seed=0, options=dict(reset_to_env_states=state))
    np.testing.assert_array_equal(tb.scene.data.qpos.numpy(), np.asarray(scene.data.qpos))
    if mode != "pd_joint_vel":  # its arm drives have no stiffness and no position target
        np.testing.assert_array_equal(tb.scene.data.drive_target.numpy(), np.asarray(scene.data.drive_target))
    assert te.single_action_space.shape == agent.controller.action_space.shape

    def act(d, a):
        scene.bind(d)
        agent.set_action(a)
        return scene.data

    act = jax.jit(act)
    rng = np.random.default_rng(zlib.crc32(mode.encode()))
    d = scene.data
    field = "drive_vel_target" if mode == "pd_joint_vel" else "drive_target"
    tol = 1e-6 if mode == "pd_joint_vel" else 1e-4
    moved = 0.0
    for k in range(5):
        a = rng.uniform(-1, 1, (B,) + te.single_action_space.shape).astype(np.float32)
        d = act(d, jnp.asarray(a))
        if k == 0:
            before = tb.scene.data
            tb.agent.set_action(torch.as_tensor(a))
            np.testing.assert_allclose(getattr(tb.scene.data, field).numpy(), np.asarray(getattr(d, field)),
                                       rtol=0, atol=tol, err_msg=field)
            moved = np.abs(np.asarray(getattr(d, field)) - np.asarray(getattr(data0, field))).max()
            tb.scene.bind(before)
        d = physics(scene.model, d)
        te.step(torch.as_tensor(a))
    assert moved > 1e-3, f"{mode}: the action changed no target"
    np.testing.assert_allclose(tb.scene.data.qpos.numpy(), np.asarray(d.qpos), rtol=0, atol=1e-4)
    assert np.abs(np.asarray(d.qpos) - np.asarray(data0.qpos)).max() > 1e-2, "the arm did not move"
