"""Contact forces of the port's PickCube-v1 against the JAX package's, on the
CPU: a cube resting on the table carries its weight, and the Panda's two
fingers grasp a cube placed between them.

Both envs start from the same ``reset_to_env_states``. Forces agree at 1e-3
relative to the largest force (the port keeps the solver's matvecs in f32;
the reference runs with its bf16 cast made an identity, see
tests/test_torch_common.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.utils.geometry import rotation_conversions as rc

from test_torch_common import f32_reference_solver, one_torch_thread, tree  # noqa: F401

B = 4
ENV = dict(obs_mode="state_dict", reward_mode="dense", control_mode="pd_joint_delta_pos")
CUBE_WEIGHT = 0.064 * 9.81  # 4 cm cube of density 1000, in N


@pytest.fixture(scope="module")
def envs(f32_reference_solver):
    je = jmake("PickCube-v1", num_envs=B, **ENV)
    te = tmake("PickCube-v1", num_envs=B, device="cpu", **ENV)
    return je, te


def _start(je, te, seed, edit=None):
    je.reset(seed=seed)
    state = tree(je.unwrapped.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))
    if edit is not None:
        state = edit(state)
    je.reset(options=dict(reset_to_env_states=tree(state, lambda v: jnp.asarray(v.numpy()))))
    te.reset(options=dict(reset_to_env_states=state))


def _forces(env, a, b):
    base = env.unwrapped
    return np.asarray(base.scene.get_pairwise_contact_forces(a(base), b(base)))


def test_cube_rests_on_table(envs):
    """Five zero-action steps: the table holds the cube up with its weight,
    (0, 0, 0.628) N, on both sides."""
    je, te = envs
    _start(je, te, seed=2)
    zero = np.zeros((B, 8), np.float32)
    for _ in range(5):
        je.step(zero)
        te.step(torch.as_tensor(zero))
    table, cube = (lambda b: b.table_scene.table), (lambda b: b.cube)
    jf, tf = _forces(je, table, cube), _forces(te, table, cube)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-3 * CUBE_WEIGHT)
    for f in (jf, tf):
        np.testing.assert_allclose(f[:, 2], CUBE_WEIGHT, rtol=2e-3)
        assert np.abs(f[:, :2]).max() < 1e-3
    np.testing.assert_allclose(te.unwrapped.cube.pose.p[:, 2].numpy(), 0.02, atol=1e-3)


def test_grasp(envs):
    """The cube starts between the open fingers, yawed 0.15 rad from the
    hand; the gripper closes until the reference grasps in every env (at
    most 5 steps). The port then grasps too, with the same finger forces.

    The yaw keeps the box-box SAT away from exact ties: with the cube's faces
    parallel to the pads, the finger's and the cube's face axes overlap
    equally up to rounding, the two packages' last-ulp differences pick
    different reference faces, and the cube's spin diverges at the impact
    (0.11 rad/s, finger forces 2 N apart out of 17 N)."""
    je, te = envs

    def between_fingers(state):
        # the TCP of the rest pose, read from the JAX env after its reset
        tcp = torch.as_tensor(np.array(je.unwrapped.agent.tcp_pose.raw_pose))
        hand_z = rc.quaternion_apply(tcp[:, 3:], torch.tensor([0.0, 0.0, 1.0]))
        yaw = torch.tensor([np.cos(0.075), 0.0, 0.0, np.sin(0.075)], dtype=torch.float32)
        quat = rc.quaternion_multiply(tcp[:, 3:], yaw.expand(B, 4))
        # 1.5 cm toward the hand: the cube clears the palm and sits on the pads
        state["actors"]["cube"] = torch.cat([tcp[:, :3] - 0.015 * hand_z, quat, torch.zeros(B, 6)], -1)
        return state

    _start(je, te, seed=1, edit=between_fingers)
    close = np.zeros((B, 8), np.float32)
    close[:, 7] = -1.0
    for n in range(1, 6):
        _, _, _, _, jinfo = je.step(close)
        _, _, _, _, tinfo = te.step(torch.as_tensor(close))
        if np.asarray(jinfo["is_grasped"]).all():
            break
    assert np.asarray(jinfo["is_grasped"]).all(), f"the reference did not grasp in {n} steps"
    assert tinfo["is_grasped"].all()
    for finger in ("finger1_link", "finger2_link"):
        jf = _forces(je, lambda b: getattr(b.agent, finger), lambda b: b.cube)
        tf = _forces(te, lambda b: getattr(b.agent, finger), lambda b: b.cube)
        assert np.linalg.norm(jf, axis=-1).min() > 0.5
        np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-3 * np.abs(jf).max(), err_msg=finger)
