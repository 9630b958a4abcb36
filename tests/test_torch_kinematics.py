"""The port's rotation helpers, pose algebra, rest check and ``Kinematics``
(batched FK, point Jacobian, damped-least-squares IK) against the JAX
package's, on the CPU.

- ``quaternion_to_axis_angle``, ``standardize_quaternion`` and
  ``matrix_to_euler_angles`` on random quaternions, the identity and angles
  near pi: 1e-6.
- ``Pose`` composition, inverse and ``create_from_pq``, and
  ``Actor.is_static_check``: 1e-6 (the flags exactly).
- On the Panda of PickCube-v1 at 8 envs, from the same joints: the
  end-effector Jacobian against the JAX one at 1e-5 and against central
  differences of FK at 2e-4 (float32 FK, step 2e-3); IK toward reachable
  poses (FK of perturbed joints, a turn of up to ~0.3 rad) from the same q0,
  after 8 and after 40 iterations, at 1e-4 rad.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.agents.controllers.utils.kinematics import Kinematics as JKinematics
from maniskill_tpu.structs.pose import Pose as JPose
from maniskill_tpu.utils.geometry import rotation_conversions as jrc
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.agents.controllers.utils.kinematics import Kinematics as TKinematics
from maniskill_tpu_torch.structs.pose import Pose as TPose
from maniskill_tpu_torch.utils.geometry import rotation_conversions as trc

from test_torch_common import one_torch_thread, tree  # noqa: F401

B = 8
ARM = [f"panda_joint{i}" for i in range(1, 8)]


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    special = [[1, 0, 0, 0], [-1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, -1],
               [1e-4, 1, 0, 0], [-1e-4, 0, 0.6, 0.8], [np.cos(1e-7), np.sin(1e-7), 0, 0]]
    return np.concatenate([q, np.asarray(special, np.float32)])


def test_rotation_conversions_match_reference():
    q = _quats(np.random.default_rng(0), 64)
    np.testing.assert_allclose(trc.standardize_quaternion(torch.as_tensor(q)).numpy(),
                               np.asarray(jrc.standardize_quaternion(jnp.asarray(q))), rtol=0, atol=1e-6)
    aa_t = trc.quaternion_to_axis_angle(torch.as_tensor(q)).numpy()
    aa_j = np.asarray(jax.jit(jrc.quaternion_to_axis_angle)(jnp.asarray(q)))
    assert np.isfinite(aa_t).all()
    np.testing.assert_allclose(aa_t, aa_j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(aa_t[64], 0.0)  # the identity: no NaN from norm == 0
    m = jrc.quaternion_to_matrix(jnp.asarray(q))
    np.testing.assert_allclose(trc.matrix_to_euler_angles(torch.as_tensor(np.array(m))).numpy(),
                               np.asarray(jrc.matrix_to_euler_angles(m)), rtol=0, atol=1e-6)


def test_pose_algebra_and_rest_check_match_reference():
    rng = np.random.default_rng(1)
    qa, qb = _quats(rng, 16), _quats(rng, 16)
    pa, pb = rng.normal(size=qa.shape[:1] + (3,)).astype(np.float32), rng.normal(size=qb.shape[:1] + (3,)).astype(np.float32)
    ja, jb = JPose.create_from_pq(jnp.asarray(pa), jnp.asarray(qa)), JPose.create_from_pq(jnp.asarray(pb), jnp.asarray(qb))
    ta = TPose.create_from_pq(torch.as_tensor(pa), torch.as_tensor(qa))
    tb = TPose.create_from_pq(torch.as_tensor(pb), torch.as_tensor(qb))
    for jv, tv in ((ja, ta), (ja * jb, ta * tb), (ja.inv(), ta.inv()), (ja.inv() * jb, ta.inv() * tb)):
        np.testing.assert_allclose(tv.raw_pose.numpy(), np.asarray(jv.raw_pose), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def envs():
    env_kw = dict(obs_mode="state", control_mode="pd_joint_pos")
    je = jmake("PickCube-v1", num_envs=B, **env_kw)
    te = tmake("PickCube-v1", num_envs=B, device="cpu", **env_kw)
    je.reset(seed=5)
    te.reset(seed=5, options=dict(reset_to_env_states=tree(
        je.unwrapped.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))))
    return je, te


def test_is_static_check_matches_reference(envs):
    je, te = envs
    rng = np.random.default_rng(2)
    vel = rng.normal(0, 0.3, (B, 6)).astype(np.float32) * rng.uniform(0, 1, (B, 1)).astype(np.float32)
    vel[0] = 0.0
    jcube, tcube = je.unwrapped.cube, te.unwrapped.cube
    for v_scale in (1.0, 0.02):
        v = vel * v_scale
        jcube.set_linear_velocity(jnp.asarray(v[:, :3]))
        jcube.set_angular_velocity(jnp.asarray(v[:, 3:]))
        tcube.set_linear_velocity(torch.as_tensor(v[:, :3]))
        tcube.set_angular_velocity(torch.as_tensor(v[:, 3:]))
        want = np.asarray(jcube.is_static_check(lin_thresh=1e-2, ang_thresh=0.5))
        np.testing.assert_array_equal(tcube.is_static_check(lin_thresh=1e-2, ang_thresh=0.5).numpy(), want)
    assert want.any() and not want.all()


def _kinematics(je, te):
    jk = JKinematics(je.unwrapped.scene, je.unwrapped.agent.robot, "panda_hand_tcp", ARM)
    tk = TKinematics(te.unwrapped.scene, te.unwrapped.agent.robot, "panda_hand_tcp", ARM)
    np.testing.assert_array_equal(tk.q_adrs, jk.q_adrs)
    np.testing.assert_array_equal(tk.dof_adrs, jk.dof_adrs)
    return jk, tk


def _arm_q(je, rng, jk):
    q0 = np.asarray(je.unwrapped.scene.data.qpos)[:, jk.q_adrs]
    return (q0 + rng.uniform(-0.3, 0.3, q0.shape)).astype(np.float32)


def test_jacobian_matches_reference_and_finite_differences(envs):
    je, te = envs
    jk, tk = _kinematics(je, te)
    q = _arm_q(je, np.random.default_rng(3), jk)
    J_j = np.asarray(jax.jit(lambda q: jk._jacobian(jk._fk(q)))(jnp.asarray(q)))
    J_t = tk._jacobian(*tk._fk(torch.as_tensor(q))).numpy()
    assert J_t.shape == (B, 6, 7)
    np.testing.assert_allclose(J_t, J_j, rtol=0, atol=1e-5)

    eps, eb = 2e-3, tk.end_body
    fd = np.zeros_like(J_t)
    for k in range(7):
        dq = np.zeros_like(q)
        dq[:, k] = eps
        xp, xq = tk._fk(torch.as_tensor(q + dq))
        xm, xqm = tk._fk(torch.as_tensor(q - dq))
        fd[:, :3, k] = ((xp[:, eb] - xm[:, eb]) / (2 * eps)).numpy()
        dr = trc.quaternion_to_axis_angle(trc.quaternion_multiply(xq[:, eb], trc.quaternion_conjugate(xqm[:, eb])))
        fd[:, 3:, k] = (dr / (2 * eps)).numpy()
    np.testing.assert_allclose(J_t, fd, rtol=0, atol=2e-4)


@pytest.mark.parametrize("iterations", [8, 40])
def test_ik_matches_reference(envs, iterations):
    je, te = envs
    jk, tk = _kinematics(je, te)
    rng = np.random.default_rng(4)
    q0 = _arm_q(je, rng, jk)
    q_goal = (q0 + rng.uniform(-0.15, 0.15, q0.shape)).astype(np.float32)
    target = np.asarray(jk.ee_pose(jk._fk(jnp.asarray(q_goal))))
    for pos_only in (False, True):
        ik = jax.jit(lambda t, q: jk.compute_ik(t, q, pos_only=pos_only, iterations=iterations))
        q_j = np.asarray(ik(jnp.asarray(target), jnp.asarray(q0)))
        q_t = tk.compute_ik(torch.as_tensor(target), torch.as_tensor(q0), pos_only=pos_only,
                            iterations=iterations).numpy()
        np.testing.assert_allclose(q_t, q_j, rtol=0, atol=1e-4)
        # the solve moved toward the target
        xp, _ = tk._fk(torch.as_tensor(q_t))
        err0 = np.linalg.norm(np.asarray(jk.ee_pose(jk._fk(jnp.asarray(q0))))[:, :3] - target[:, :3], axis=-1)
        err = np.linalg.norm(xp[:, tk.end_body].numpy() - target[:, :3], axis=-1)
        assert (err < 0.5 * err0).all(), (err, err0)
