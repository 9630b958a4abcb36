"""PickClutterYCB-v1 with ``robot_uids="fetch"`` in the port against the JAX
package, at 2 envs on the CPU.

The JAX package runs the Fetch here in obs mode "none" only: its Fetch has
no ``tcp_pose``, which the task's state obs reads (its state mode raises).
From the JAX env's state after the reset inside ``make`` (its solver's bf16
cast made an identity), one zero-action step: the Fetch's 15 coordinates
within 1e-5. The clutter's hulls tumble from their resting heights, and
their deepest-4 contact manifolds pick among vertices whose depths differ by
round-off (ROADMAP section 3), so the objects' coordinates are held within
1e-2 only. The port's Fetch has ``tcp_pose``: the port also runs the task in
state mode (finite obs), from the table builder's rest keyframe with noise
on every joint but the last two.
"""
import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake

from test_torch_common import f32_reference_solver, jax_cooking, one_torch_thread, tree  # noqa: F401

B = 2


def test_pick_clutter_ycb_fetch_matches_reference(jax_cooking, f32_reference_solver):
    kw = dict(num_envs=B, robot_uids="fetch")
    with pytest.raises(AttributeError, match="tcp_pose"):
        jmake("PickClutterYCB-v1", obs_mode="state", **kw)
    je = jmake("PickClutterYCB-v1", obs_mode="none", **kw)
    te = tmake("PickClutterYCB-v1", obs_mode="none", device="cpu", **kw)
    jb, tb = je.unwrapped, te.unwrapped
    assert tb.agent.uid == "fetch" and "fetch" in tb.SUPPORTED_ROBOTS
    state = tree(jb.get_state_dict(), np.array)
    state["extras"] = {k: np.array(v) for k, v in jb.scene.data.extras.items()}
    te.reset(seed=3, options=dict(reset_to_env_states=tree(state, torch.as_tensor)))
    np.testing.assert_array_equal(tb.scene.data.qpos.numpy(), np.asarray(jb.scene.data.qpos))
    zero = np.zeros((B, 13), np.float32)
    je.step(zero)
    te.step(torch.as_tensor(zero))
    dof = tb.agent.robot.dof
    assert dof == 15 and tb.agent.robot._qadr.tolist() == list(range(dof))
    tq, jq = tb.scene.data.qpos.numpy(), np.asarray(jb.scene.data.qpos)
    np.testing.assert_allclose(tq[:, :dof], jq[:, :dof], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tq[:, dof:], jq[:, dof:], rtol=0, atol=1e-2)
    # the port's state obs (the task reads the Fetch's tcp_pose)
    ts = tmake("PickClutterYCB-v1", obs_mode="state", device="cpu", **kw)
    obs, *_ = ts.step(torch.zeros(13))
    assert obs.shape[0] == B and bool(torch.isfinite(obs).all())
    # the rest keyframe with noise: the arm moved off the keyframe, the gripper did not
    kf = torch.as_tensor(np.asarray(ts.unwrapped.agent.keyframes["rest"].qpos, np.float32))
    ts.reset(seed=1)
    q = ts.unwrapped.agent.robot.qpos
    assert bool((q[:, :-2] != kf[:-2]).any()) and torch.equal(q[:, -2:], kf[-2:].expand(B, 2))
