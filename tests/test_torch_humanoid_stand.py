"""The port's humanoid robots (Unitree H1 and G1, loaded from URDF) and
their Stand tasks (UnitreeH1Stand-v1, UnitreeG1Stand-v1) against the JAX
package's, at 4 envs on the CPU.

Each JAX env, its solver's bf16 cast made an identity, is stepped from its
state after the reset inside ``make`` with seeded random
``pd_joint_delta_pos`` actions. The port's env starts from that state and
takes the same actions: obs within 1e-4, the sparse reward (is_standing)
and terminated equal, the full qpos (the FREE root's 7 included) and every
body's ``cvel`` within 1e-4, ``contact.overflow == 0`` on both sides, and
the bodies moving. Before any step the models are equal, the links and
joints have the same names in the same (depth-first) order, and after the
reset qpos equals the JAX env's exactly.

Each robot takes 4 control steps, as many as stay within round-off of the
1e-4 tolerance with these actions: the obs part by up to 4.4e-5 (H1) and
3.9e-5 (G1) over 4 steps and by 1.2e-4 and 9.9e-5 at the 5th, as the robots
land on their feet from the keyframe with stiff (1000 N m/rad) gains.
"""
import numpy as np
import pytest

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.agents.robots.unitree_g1 import g1
from maniskill_tpu_torch.agents.robots.unitree_h1 import h1

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_tree_close, f32_reference_solver, one_torch_thread, port_rollout,
    reference_rollout,
)

B = 4
STEPS = 4
KW = dict(num_envs=B, obs_mode="state_dict", control_mode="pd_joint_delta_pos")
ROBOTS = {"UnitreeH1Stand-v1": (h1, 19), "UnitreeG1Stand-v1": (g1, 13)}


@pytest.fixture(scope="module")
def reference(f32_reference_solver):
    runs = {}

    def get(env_id):
        if env_id not in runs:
            je = jmake(env_id, **KW)
            runs[env_id] = (je, reference_rollout(je, STEPS))
        return runs[env_id]

    return get


@pytest.mark.parametrize("env_id", list(ROBOTS))
def test_task_matches_reference(env_id, reference):
    je, ref = reference(env_id)
    jb = je.unwrapped
    te = tmake(env_id, device="cpu", **KW)
    tb = te.unwrapped
    mod, dof = ROBOTS[env_id]
    names = [j.name for j in tb.agent.robot.active_joints]
    assert names == [j.name for j in jb.agent.robot.active_joints] == mod.JOINT_NAMES and len(names) == dof
    assert [link.name for link in tb.agent.robot.links] == [link.name for link in jb.agent.robot.links]
    assert_models_equal(tb.scene.model, jb.scene.model)
    assert tb.reward_mode == "sparse"

    out = port_rollout(te, ref)
    np.testing.assert_array_equal(out["qpos0"].numpy(), ref["qpos0"])
    np.testing.assert_allclose(out["cvel0"].numpy(), ref["cvel0"], rtol=0, atol=1e-6)
    assert_tree_close(out["obs0"], ref["obs0"], 1e-6, f"{env_id} reset")
    assert_tree_close(out["obs"], ref["obs"], 1e-4, env_id)
    np.testing.assert_array_equal(out["reward"].numpy(), ref["reward"])
    np.testing.assert_array_equal(out["terminated"].numpy(), ref["terminated"])
    np.testing.assert_array_equal(out["info"]["is_standing"].numpy(), ref["info"]["is_standing"])
    data, jdata = tb.scene.data, jb.scene.data
    np.testing.assert_allclose(data.qpos.numpy(), np.asarray(jdata.qpos), rtol=0, atol=1e-4)
    np.testing.assert_allclose(data.cvel.numpy(), np.asarray(jdata.cvel), rtol=0, atol=1e-4)
    assert data.contact.overflow.tolist() == [0] * B
    assert np.asarray(jdata.contact.overflow).tolist() == [0] * B
    assert np.abs(np.asarray(jdata.qvel)).max() > 0.1, "nothing moved"


@pytest.mark.parametrize("env_id", list(ROBOTS))
def test_reset_is_a_noisy_keyframe(env_id):
    """The port's own reset: the root at the keyframe pose, the joints at the
    keyframe plus N(0, 0.05) noise drawn per env, all standing."""
    te = tmake(env_id, device="cpu", **dict(KW, num_envs=64))
    _, info = te.reset(seed=0)
    agent = te.unwrapped.agent
    kf = agent.keyframes["standing"]
    np.testing.assert_allclose(agent.robot.root_pose.raw_pose.numpy(), np.broadcast_to(kf.pose, (64, 7)),
                               atol=1e-6)
    noise = agent.robot.qpos.numpy() - kf.qpos
    assert 0.03 < noise.std() < 0.07 and abs(noise.mean()) < 0.01
    assert len(np.unique(noise[:, 0])) == 64
    assert bool(info["is_standing"].all())
