"""The port's wrappers (maniskill_tpu_torch/wrappers) against the JAX
package's, on the CPU.

Each JAX wrapper and its port get the same inputs: a scripted env whose
obs, rewards and terminations are fixed functions of the step and action
(the JAX side holds jax arrays and derives from ``gymnasium.Env``, the port
side holds tensors), or the same obs dict taken from the port's PushCube
rgb+depth env. Held equal: the flatten wrappers' obs (state, rgb, depth,
rgbd) and the MultiAgent dict action split, FrameStack, ActionRepeat with
early-terminating envs, CPUGymWrapper's unbatched returns and metrics,
CachedResetWrapper's restored states for the JAX package's pool draws, and
VisualEncoderWrapper's embedding with the JAX wrapper's flax params carried
over (within 1e-5). The last tests mirror tests/test_wrappers.py on the
port's PushCube-v1 and TwoRobotPickCube-v1.
"""
import gymnasium as gym
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniskill_tpu import wrappers as jw

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch import wrappers as tw
from maniskill_tpu_torch.utils import gym_utils

from test_torch_common import one_torch_thread, tree  # noqa: F401

B, D = 2, 3


class Scripted(gym.Env):
    """A batched env of fixed dynamics: obs = 10 t + sum(action), reward =
    (t + 1) mean(action); env 0 terminates at its 2nd step."""

    def __init__(self, backend, num_envs=B, raw_obs=None, obs_mode="state"):
        self.xp = jnp if backend == "jax" else torch
        self.as_array = jnp.asarray if backend == "jax" else torch.as_tensor
        self.num_envs, self.obs_mode = num_envs, obs_mode
        self.t = 0
        self.device = torch.device("cpu")
        box = gym.spaces.Box(-1.0, 1.0, (D,), np.float32)
        self.single_action_space = box if backend == "jax" else gym_utils.Box(-1.0, 1.0, (D,))
        self.single_observation_space = (box if backend == "jax" else gym_utils.Box(-np.inf, np.inf, (D,)))
        self._init_raw_obs = raw_obs
        self.reset_states = []
        self.seed_seen = None

    def _obs(self, action):
        return self.as_array(np.full((self.num_envs, D), 10.0 * self.t, np.float32) + action.sum(-1, keepdims=True))

    def reset(self, *, seed=None, options=None):
        self.t, self.seed_seen = 0, seed
        if options and "reset_to_env_states" in options:
            self.reset_states.append(tree(options["reset_to_env_states"], np.asarray))
        return self._obs(np.zeros((self.num_envs, D), np.float32)), {}

    def step(self, action):
        action = np.asarray(action, np.float32)
        self.t += 1
        reward = self.as_array((self.t * action.mean(-1)).astype(np.float32))
        term = self.as_array(np.array([self.t >= 2] + [False] * (self.num_envs - 1)))
        trunc = self.as_array(np.zeros(self.num_envs, bool))
        info = dict(success=term, elapsed_steps=self.as_array(np.full(self.num_envs, self.t)))
        return self._obs(action), reward, term, trunc, info

    def get_state_dict(self):
        base = float(self.seed_seen or 0)
        cube = np.arange(self.num_envs * 4, dtype=np.float32).reshape(self.num_envs, 4) + 100 * base
        return dict(actors=dict(cube=self.as_array(cube)))


def np_(x):
    if isinstance(x, dict):
        return {k: np_(v) for k, v in x.items()}
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_tree_equal(a, b, atol=0.0):
    a, b = np_(a), np_(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_tree_equal(a[k], b[k], atol)
        return
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=atol, rtol=0)


@pytest.fixture(scope="module")
def rgbd_obs():
    env = tmake("PushCube-v1", num_envs=B, obs_mode="rgb+depth", device="cpu")
    obs, _ = env.reset(seed=0)
    obs, *_ = env.step(torch.full((B, 8), 0.3))
    return tree(obs, lambda v: v.clone().numpy())


def _pair(obs_np, obs_mode="rgb+depth"):
    j = Scripted("jax", raw_obs=tree(obs_np, jnp.asarray), obs_mode=obs_mode)
    t = Scripted("torch", raw_obs=tree(obs_np, torch.as_tensor), obs_mode=obs_mode)
    return j, t


def test_flatten_observation(rgbd_obs):
    j, t = _pair(rgbd_obs)
    jo = jw.FlattenObservationWrapper(j).observation(tree(rgbd_obs, jnp.asarray))
    to = tw.FlattenObservationWrapper(t).observation(tree(rgbd_obs, torch.as_tensor))
    assert_tree_equal(jo, to)


@pytest.mark.parametrize("kw", [dict(), dict(sep_depth=False), dict(depth=False, state=False)],
                         ids=["rgb_depth_state", "rgbd", "rgb_only"])
def test_flatten_rgbd_observation(rgbd_obs, kw):
    j, t = _pair(rgbd_obs)
    jwrap, twrap = jw.FlattenRGBDObservationWrapper(j, **kw), tw.FlattenRGBDObservationWrapper(t, **kw)
    jo = jwrap.observation(tree(rgbd_obs, jnp.asarray))
    to = twrap.observation(tree(rgbd_obs, torch.as_tensor))
    assert_tree_equal(jo, to)
    for k in jo:
        assert np_(to[k]).dtype == np.asarray(jo[k]).dtype, k
        assert twrap.single_observation_space[k].shape == jwrap.single_observation_space[k].shape


def test_flatten_action_space_splits_multi_agent_actions():
    env = tmake("TwoRobotPickCube-v1", num_envs=B, device="cpu")
    space = env.unwrapped.single_action_space
    jspace = gym.spaces.Dict({k: gym.spaces.Box(s.low, s.high, dtype=np.float32) for k, s in space.spaces.items()})
    j = Scripted("jax")
    j.single_action_space = jspace
    jwrap, twrap = jw.FlattenActionSpaceWrapper(j), tw.FlattenActionSpaceWrapper(env)
    assert twrap.single_action_space.shape == jwrap.single_action_space.shape == (16,)
    np.testing.assert_array_equal(twrap.single_action_space.low, jwrap.single_action_space.low)
    flat = np.random.default_rng(0).uniform(-1, 1, (B, 16)).astype(np.float32)
    assert_tree_equal(jwrap.action(jnp.asarray(flat)), twrap.action(torch.as_tensor(flat)))
    twrap.reset(seed=0)
    _, rew, *_ = twrap.step(torch.as_tensor(flat))
    assert tuple(rew.shape) == (B,)


def test_frame_stack():
    j, t = Scripted("jax"), Scripted("torch")
    jwrap, twrap = jw.FrameStack(j, num_stack=3), tw.FrameStack(t, num_stack=3)
    assert twrap.single_observation_space.shape == jwrap.single_observation_space.shape == (3, D)
    assert_tree_equal(jwrap.reset(seed=0)[0], twrap.reset(seed=0)[0])
    for k in range(4):
        a = np.full((B, D), 0.1 * (k + 1), np.float32)
        assert_tree_equal(jwrap.step(a)[0], twrap.step(a)[0])


def test_action_repeat():
    j, t = Scripted("jax"), Scripted("torch")
    jwrap, twrap = jw.ActionRepeatWrapper(j, repeat=3), tw.ActionRepeatWrapper(t, repeat=3)
    jwrap.reset(seed=0), twrap.reset(seed=0)
    for k in range(2):
        a = np.full((B, D), 0.5 - k, np.float32)
        jo, jr, jt, jtr, _ = jwrap.step(a)
        to, tr_, tt, ttr, _ = twrap.step(a)
        for x, y in ((jo, to), (jr, tr_), (jt, tt), (jtr, ttr)):
            assert_tree_equal(x, y)
        assert j.t == t.t


def test_cpu_gym_wrapper():
    j, t = Scripted("jax", num_envs=1), Scripted("torch", num_envs=1)
    jwrap = jw.CPUGymWrapper(j, record_metrics=True)
    twrap = tw.CPUGymWrapper(t, record_metrics=True)
    jo, _ = jwrap.reset(seed=0)
    to, _ = twrap.reset(seed=0)
    np.testing.assert_array_equal(jo, to)
    for k in range(3):
        a = np.full((1, D), 0.2 * (k + 1), np.float32)
        jout, tout = jwrap.step(a), twrap.step(a)
        np.testing.assert_array_equal(jout[0], tout[0])
        assert isinstance(tout[1], float) and isinstance(tout[2], bool) and isinstance(tout[3], bool)
        assert jout[1:4] == tout[1:4]
        assert jout[4]["episode"] == tout[4]["episode"]
        assert bool(jout[4]["success"]) == bool(tout[4]["success"])


def test_cached_reset_restores_the_same_pool_rows():
    j, t = Scripted("jax"), Scripted("torch")
    jwrap = jw.CachedResetWrapper(j, num_resets=6, seed=4)
    twrap = tw.CachedResetWrapper(t, num_resets=6, seed=4)
    assert_tree_equal(jwrap._pool, twrap._pool)
    draws = np.random.RandomState(4).randint(0, 6, size=(2, B))  # the JAX wrapper's RandomState(seed)
    for idx in draws:
        jwrap.reset()
        twrap.reset(options=dict(cached_idx=torch.as_tensor(idx)))
    assert len(j.reset_states) == len(t.reset_states) == 2
    for a, b in zip(j.reset_states, t.reset_states):
        assert_tree_equal(a, b)
    twrap.reset()  # its own draw, from its generator
    assert len(t.reset_states) == 3


def test_visual_encoder_with_carried_params(rgbd_obs):
    j, t = _pair(rgbd_obs)
    jwrap = jw.VisualEncoderWrapper(j)
    params = tree(jwrap.params, np.asarray)
    twrap = tw.VisualEncoderWrapper(t, params=params)
    jo = jwrap.observation(tree(rgbd_obs, jnp.asarray))
    to = twrap.observation(tree(rgbd_obs, torch.as_tensor))
    assert tuple(to["embedding"].shape) == (B, 256)
    assert_tree_equal(jo, to, atol=1e-5)


# ---- tests/test_wrappers.py's checks on the port's envs ---------------------
def test_port_flatten_action_space_and_cpu_gym():
    env = tmake("PushCube-v1", num_envs=2, device="cpu")
    wrapped = tw.FlattenActionSpaceWrapper(env)
    assert wrapped.single_action_space.shape == (8,)
    wrapped.reset(seed=0)
    _, rew, *_ = wrapped.step(np.zeros((2, 8), np.float32))
    assert tuple(rew.shape) == (2,)
    env1 = tmake("PushCube-v1", num_envs=1, device="cpu")
    gym_env = tw.CPUGymWrapper(env1, record_metrics=True)
    obs, _ = gym_env.reset(seed=0)
    assert isinstance(obs, np.ndarray) and obs.ndim == 1
    obs, rew, term, trunc, info = gym_env.step(np.zeros(8, np.float32))
    assert isinstance(rew, float) and isinstance(term, bool) and "episode" in info


def test_port_frame_stack_and_action_repeat():
    env = tmake("PushCube-v1", num_envs=2, device="cpu")
    fs = tw.FrameStack(env, num_stack=3)
    obs, _ = fs.reset(seed=0)
    assert tuple(obs.shape[:2]) == (2, 3)
    obs, *_ = fs.step(torch.zeros(2, 8))
    assert tuple(obs.shape[:2]) == (2, 3)
    rep = tw.ActionRepeatWrapper(env, repeat=2)
    rep.reset(seed=0)
    rep.step(torch.zeros(2, 8))
    assert int(env.unwrapped.elapsed_steps.max()) == 2
