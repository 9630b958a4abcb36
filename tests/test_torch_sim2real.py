"""The port's Sim2RealEnv (maniskill_tpu_torch/envs/sim2real_env.py) against
the JAX package's (maniskill_tpu/envs/sim2real_env.py) on the CPU.

One mock real agent, written once as a mixin over each package's
``BaseRealAgent``, tracks the commanded targets ideally and serves 480x640
frames. PushCube-v1 at one env, in ``state`` and in ``rgb``, starts both
packages from one env state (the JAX env's, handed to the port: parity by
state, not by seed) and takes the same seeded actions. Per step:
- the targets commanded to the real robot within 1e-5 rad;
- the obs (the state vector, or agent and extra) within 1e-5, ``success``
  equal and the reward within 1e-5;
- the sim qpos after the sync equal to the real qpos within 1e-5;
- in rgb the cropped and resized real frames bit-equal, ``sensor_param``
  within 1e-5.
Then, on the port alone: the alignment check raising on a 7-dof agent, the
wrapper replay through a counting port ``Wrapper``, and
``_center_crop_resize`` bit-equal to the JAX function over a few shapes.

To keep the file cheap on the CPU: the JAX ``physics.forward`` that the JAX
sync calls is jitted once (eager it takes ~16 s a call); one JAX env, made
in ``state`` (its cameras exist in every obs mode), serves both legs (the
JAX ``Sim2RealEnv.get_obs`` reads the base env's ``obs_mode`` on each call,
so the rgb leg sets it to ``"rgb"``; the frames are the real robot's);
and the JAX side skips its construction check, which would compile another
sim reset (the port's check runs).
"""
import jax
import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu import physics as jphysics
from maniskill_tpu.agents.base_real_agent import BaseRealAgent as JBaseRealAgent
from maniskill_tpu.envs.sim2real_env import Sim2RealEnv as JSim2RealEnv
from maniskill_tpu.envs.sim2real_env import _center_crop_resize as jcrop
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch.agents.base_real_agent import BaseRealAgent as TBaseRealAgent
from maniskill_tpu_torch.envs.sim2real_env import Sim2RealEnv as TSim2RealEnv
from maniskill_tpu_torch.envs.sim2real_env import _center_crop_resize as tcrop
from maniskill_tpu_torch.utils.registration import make as tmake
from maniskill_tpu_torch.wrappers.base import Wrapper

from test_torch_common import one_torch_thread, tree  # noqa: F401

STEPS = 2


class _Mock:
    """Echoes commanded targets as the real qpos; serves 480x640 frames."""

    def __init__(self, dof):
        super().__init__()
        self.dof = dof
        self._qpos = np.zeros(dof, np.float32)
        self.commanded = []
        self.stopped = False

    def start(self):
        pass

    def stop(self):
        self.stopped = True

    def reset(self, qpos=None):
        if qpos is not None:
            self._qpos = np.asarray(qpos, np.float32).reshape(-1)[: self.dof]

    def set_target_qpos(self, qpos):
        q = np.asarray(qpos, np.float32).reshape(-1)[: self.dof]
        self.commanded.append(q)
        self._qpos = q

    def get_qpos(self):
        return self._qpos

    def get_qvel(self):
        return np.zeros(self.dof, np.float32)

    def get_sensor_data(self):
        img = (np.arange(480 * 640 * 3) % 251).astype(np.uint8)
        return {"base_camera": {"rgb": img.reshape(480, 640, 3)}}


class JMock(_Mock, JBaseRealAgent):
    pass


class TMock(_Mock, TBaseRealAgent):
    pass


def _state_reset(state, to_env):
    """A real reset that puts the sim env in ``state`` and the robot at the
    sim's qpos (no prompt)."""

    def reset(env, seed=None, options=None):
        env.base_sim_env.set_state_dict(to_env(state))
        env.agent.reset(np.asarray(env.base_sim_env.agent.robot.qpos).reshape(-1))

    return reset


@pytest.fixture(scope="module")
def jax_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jphysics, "forward", jax.jit(jphysics.forward))
        yield jmake("PushCube-v1", num_envs=1, obs_mode="state")


def _leaves(x, prefix=()):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, x


@pytest.mark.parametrize("obs_mode", ["state", "rgb"])
def test_sim2real_matches_reference(obs_mode, jax_env, monkeypatch):
    je = jax_env
    monkeypatch.setattr(je.unwrapped, "obs_mode", obs_mode)
    te = tmake("PushCube-v1", num_envs=1, obs_mode=obs_mode, device="cpu")
    state = tree(je.unwrapped.get_state_dict(), np.array)
    jenv = JSim2RealEnv(je, JMock(9), real_reset_function=_state_reset(state, lambda s: s), skip_data_checks=True)
    tenv = TSim2RealEnv(te, TMock(9), real_reset_function=_state_reset(
        state, lambda s: tree(s, lambda v: torch.as_tensor(v))))
    assert tenv.action_space == te.action_space
    jobs, _ = jenv.reset(seed=0)
    tobs, _ = tenv.reset(seed=0)
    rng = np.random.default_rng(0)
    for step in range(STEPS + 1):
        if step:
            act = rng.uniform(-1, 1, te.unwrapped.single_action_space.shape).astype(np.float32)
            jobs, jrew, jterm, _, jinfo = jenv.step(act)
            tobs, trew, tterm, _, tinfo = tenv.step(act)
            np.testing.assert_allclose(tenv.agent.commanded[-1], jenv.agent.commanded[-1], rtol=0, atol=1e-5)
            assert jterm == tterm
            assert bool(np.asarray(jinfo["success"]).reshape(-1)[0]) == bool(tinfo["success"].reshape(-1)[0])
            np.testing.assert_allclose(trew, jrew, rtol=0, atol=1e-5)
        for path, jv in _leaves(jobs):
            tv = tobs
            for k in path:
                tv = tv[k]
            assert isinstance(tv, torch.Tensor) and tuple(tv.shape) == np.shape(jv), path
            if path[:1] == ("sensor_data",):
                np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=str(path))
            else:
                np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5, err_msg=str(path))
        tq = te.unwrapped.agent.robot.qpos.numpy().reshape(-1)
        np.testing.assert_allclose(tq, tenv.agent.get_qpos(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tq, np.asarray(je.unwrapped.agent.robot.qpos).reshape(-1), rtol=0, atol=1e-5)
    assert len(tenv.agent.commanded) == len(jenv.agent.commanded) == STEPS
    tenv.close()
    assert tenv.agent.stopped


def _no_prompt_reset(env, seed=None, options=None):
    env.sim_env.reset(seed=seed, options=options)
    env.agent.reset(env.base_sim_env.agent.robot.qpos.numpy().reshape(-1))


def test_alignment_check_catches_a_7_dof_agent():
    """A real agent whose proprioception has 7 dofs (the sim Panda has 9)
    fails construction, as in the JAX package."""
    te = tmake("PushCube-v1", num_envs=1, obs_mode="state", device="cpu")
    with pytest.raises(AssertionError, match="Shape mismatch"):
        TSim2RealEnv(te, TMock(7), real_reset_function=_no_prompt_reset)


def test_wrapper_replay():
    """A port ``Wrapper`` around the sim env runs for every real step and
    reset (a reset also counts the sim reset inside the real reset
    function), and the sim env's own chain is restored after each."""

    class Counting(Wrapper):
        def __init__(self, env):
            super().__init__(env)
            self.steps_seen = self.resets_seen = 0

        def step(self, action):
            self.steps_seen += 1
            return self.env.step(action)

        def reset(self, *, seed=None, options=None):
            self.resets_seen += 1
            return self.env.reset(seed=seed, options=options)

    se = Counting(tmake("PushCube-v1", num_envs=1, obs_mode="state", device="cpu"))
    inner = se.env.env
    env = TSim2RealEnv(se, TMock(9), real_reset_function=_no_prompt_reset)
    resets = se.resets_seen
    env.reset(seed=0)
    env.step(np.zeros(env.action_space.shape, np.float32))
    assert (se.steps_seen, se.resets_seen) == (1, resets + 2)
    assert se.env.env is inner
    assert len(env.agent.commanded) == 1


@pytest.mark.parametrize("shape,out", [((480, 640, 3), (128, 128)), ((720, 1280, 3), (96, 160)),
                                       ((480, 640), (64, 32)), ((31, 17, 1), (128, 128)),
                                       ((100, 100, 3), (240, 320))])
def test_center_crop_resize_matches_reference(shape, out):
    img = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    want = jcrop(img, *out)
    got = tcrop(img, *out)
    assert got.shape == want.shape == out + shape[2:]
    np.testing.assert_array_equal(got, want)
