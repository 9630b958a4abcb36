"""The port's batched motion planner against the JAX package's, and the
repo's recorded motion-planning demos replayed in the port, on the CPU.

(a) StackCube-v1 and PickCube-v1 at 4 envs: both planners run their
    scripted solution from the same start state (the JAX env's, through
    ``set_state_dict``). Every move's IK waypoint agrees within 1e-4 rad and
    the success flags are equal. The JAX solver runs with its bf16 matvec
    cast made an identity (``f32_solver``, tests/test_torch_common.py), and
    its planner's IK runs jitted (in the JAX package it runs op by op).
(b) Every ``demos/<env>/mp_<env>.h5``, open loop: all episodes of a file as
    the envs of one batch, each set to its recorded ``env_states`` at step 0,
    then the recorded ``pd_joint_pos`` actions (an episode that ends early
    holds its last action). An episode counts as solved if ``success`` holds
    at its own last step. The port solves at least the recorded count less
    2 of every file, except LiftPegUpright-v1: its recorded episodes do not
    replay open loop in the JAX package either (16 of 24 with the bf16
    solver, 20 of 24 with the f32 one, on the CPU), so there the bar is the
    JAX package's own f32 replay less 2, measured here. The largest
    deviation of any object's position from the recorded states is printed.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.agents.controllers.utils.kinematics import Kinematics as JKinematics
from maniskill_tpu.examples.motionplanning import panda_solver as jsolver_mod
from maniskill_tpu.examples.motionplanning.solutions import SOLUTIONS as JSOLUTIONS
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.examples.motionplanning import panda_solver as tsolver_mod
from maniskill_tpu_torch.examples.motionplanning.solutions import SOLUTIONS as TSOLUTIONS

from test_torch_common import f32_reference_solver, f32_solver, one_torch_thread, tree  # noqa: F401

h5py = pytest.importorskip("h5py")

DEMOS = ["PushCube-v1", "PickCube-v1", "PullCube-v1", "StackCube-v1", "PlaceSphere-v1",
         "StackPyramid-v1", "LiftPegUpright-v1", "PullCubeTool-v1"]
REPLAY_BAR_FROM_REFERENCE = {"LiftPegUpright-v1"}


@pytest.fixture
def jitted_reference_ik(monkeypatch):
    """The JAX planner's ``compute_ik`` under ``jax.jit``, the scene's data
    passed in as an argument (it reads ``scene.data`` and ``scene.model``)."""
    compute_ik = JKinematics.compute_ik

    def traced(kin, data, target, q0, pos_only, iterations, damping):
        kin.scene.bind(data)
        return compute_ik(kin, target, q0, pos_only=pos_only, iterations=iterations, damping=damping)

    ik = jax.jit(traced, static_argnums=(0, 4, 5, 6))

    def jitted(self, target_pose, q0, pos_only=False, iterations=8, damping=0.05):
        data = self.scene.data
        try:
            return ik(self, data, target_pose, q0, pos_only, iterations, damping)
        finally:
            self.scene.bind(data)  # the trace left a tracer bound

    monkeypatch.setattr(JKinematics, "compute_ik", jitted)


def _recording(monkeypatch, cls, waypoints):
    follow = cls.follow_qpos_path

    def record(self, q_goal, max_steps=100):
        waypoints.append(np.array(q_goal))
        return follow(self, q_goal, max_steps)

    monkeypatch.setattr(cls, "follow_qpos_path", record)


@pytest.mark.parametrize("env_id", ["StackCube-v1", "PickCube-v1"])
def test_planner_matches_reference(env_id, f32_reference_solver, jitted_reference_ik, monkeypatch):
    kw = dict(num_envs=4, obs_mode="state", control_mode="pd_joint_pos")
    je = jmake(env_id, **kw)
    te = tmake(env_id, device="cpu", **kw)
    je.reset(seed=21)
    te.reset(seed=21, options=dict(reset_to_env_states=tree(
        je.unwrapped.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))))
    jw, tw = [], []
    _recording(monkeypatch, jsolver_mod.PandaMotionPlanningSolver, jw)
    _recording(monkeypatch, tsolver_mod.PandaMotionPlanningSolver, tw)
    jinfo = JSOLUTIONS[env_id](je)[-1]
    tinfo = TSOLUTIONS[env_id](te)[-1]
    assert len(tw) == len(jw) >= 3
    for i, (a, b) in enumerate(zip(jw, tw)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=f"waypoint {i}")
    np.testing.assert_array_equal(tinfo["success"].numpy(), np.asarray(jinfo["success"]))
    assert int(te.unwrapped.elapsed_steps[0]) == int(np.asarray(je.unwrapped.elapsed_steps)[0])
    assert tinfo["success"].all(), "the planner failed an env"


def _demo(env_id):
    f = h5py.File(f"demos/{env_id}/mp_{env_id}.h5", "r")
    with open(f"demos/{env_id}/mp_{env_id}.json") as fh:
        meta = json.load(fh)
    keys = [f"traj_{e['episode_id']}" for e in meta["episodes"]]
    lens = np.array([f[k]["actions"].shape[0] for k in keys])
    T = int(lens.max())
    actions = np.stack([np.concatenate([f[k]["actions"][:], np.repeat(f[k]["actions"][-1:], T - n, 0)])
                        for k, n in zip(keys, lens)])

    def pad(a):
        return np.concatenate([a, np.repeat(a[-1:], T + 1 - len(a), 0)])

    def states(group):
        return {name: states(g) if isinstance(g, h5py.Group)
                else np.stack([pad(f[k][g.name.split("/", 2)[2]][:]) for k in keys])
                for name, g in group.items()}

    env_states = states(f[keys[0]]["env_states"])  # leaves (B, T + 1, ...)
    recorded = sum(e["success"] for e in meta["episodes"])
    return meta["env_info"]["env_kwargs"]["reward_mode"], lens, actions, env_states, recorded


def _replay(make, env_id, to_tensor, as_numpy, **kw):
    reward_mode, lens, actions, env_states, recorded = _demo(env_id)
    env = make(env_id, num_envs=len(lens), obs_mode="state", control_mode="pd_joint_pos",
               reward_mode=reward_mode, **kw)
    env.reset(seed=0, options=dict(reset_to_env_states=tree(env_states, lambda v: to_tensor(v[:, 0]))))
    base = env.unwrapped
    solved = np.zeros(len(lens), bool)
    errs = []
    rows = np.arange(len(lens))
    for t in range(actions.shape[1]):
        _, _, _, _, info = env.step(to_tensor(actions[:, t]))
        done = lens == t + 1
        solved[done] = as_numpy(info["success"])[done]
        live = lens > t
        errs.append(max(float(np.abs(as_numpy(base.scene.actors[n].pose.p) - s[rows, t + 1, :3])[live].max())
                        for n, s in env_states["actors"].items()))
    return int(solved.sum()), recorded, np.array(errs)


@pytest.mark.parametrize("env_id", DEMOS)
def test_demo_replays_in_port(env_id):
    ported, recorded, errs = _replay(tmake, env_id, torch.as_tensor, lambda v: v.numpy(), device="cpu")
    bar = recorded - 2
    if env_id in REPLAY_BAR_FROM_REFERENCE:
        with f32_solver():
            reference, _, _ = _replay(jmake, env_id, jnp.asarray, np.asarray)
        bar = min(bar, reference - 2)
        print(f"{env_id}: the JAX package's own f32 replay solves {reference}")
    print(f"{env_id}: port replay solves {ported}, recorded {recorded}, bar {bar}; largest object "
          f"position deviation from the recorded states {errs.max():.3e} m (step {int(errs.argmax()) + 1} of "
          f"{len(errs)}), at steps 10/20/40: {', '.join(f'{e:.2e}' for e in errs[[9, 19, 39]])}")
    assert ported >= bar, (env_id, ported, recorded, bar)
