"""The port's LeRobot adapter (maniskill_tpu_torch/agents/robots/lerobot/)
against the JAX package's, and the LeRobot pairing with Sim2RealEnv, on the
CPU. ``lerobot`` is not installed and neither adapter imports it: a stub
SO100 follower (``name="so100_follower"``, six motor keys, a bus that tracks
the commanded degrees, one camera serving 480x640 uint8 frames) stands in.

- The adapters: the action dicts sent for the same radians within 1e-9
  degrees (the elbow's 6.8 degree offset included), the cached and uncached
  qpos (the port's (6,), the JAX adapter's (1, 6)), the soft reset's
  sequence of targets with ``time.sleep`` patched out, and the sensor-data
  errors and filters.
- The JAX pairing fails (a reference fault): ``LeRobotRealAgent`` cannot
  drive the JAX ``Sim2RealEnv``. Its ``get_qvel`` raises, and the obs reads
  proprioception in every obs mode but ``none``; with a qvel its (1, 6) qpos
  is batched again to (1, 1, 6), which the alignment check refuses; its
  (1, H, W, 3) frames are cropped as if H were the width.
- The port's pair runs: ``Sim2RealEnv`` over ``SO100GraspCube-v1`` at one
  env with the data check on. It is held, step by step, to the JAX pair with
  the JAX classes patched to the port's behaviour through ``MonkeyPatch``
  (unbatched qpos and frames; the agent obs in the sim env's own layout):
  the action dicts sent within 1e-4 degrees, the state obs within 1e-5, the
  sim qpos after each sync equal to the stub's within 1e-5.
"""
import types

import jax
import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu import physics as jphysics
from maniskill_tpu.agents.robots.lerobot import manipulator as jman
from maniskill_tpu.envs.sim2real_env import Sim2RealEnv as JSim2RealEnv
from maniskill_tpu.utils import common as jcommon
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch.agents.robots.lerobot import LeRobotRealAgent as TLeRobot
from maniskill_tpu_torch.agents.robots.lerobot import manipulator as tman
from maniskill_tpu_torch.envs.sim2real_env import Sim2RealEnv as TSim2RealEnv
from maniskill_tpu_torch.utils.registration import make as tmake

from test_torch_common import one_torch_thread, tree  # noqa: F401

JLeRobot = jman.LeRobotRealAgent
KEYS = ["shoulder_pan", "shoulder_lift", "elbow_flex", "wrist_flex", "wrist_roll", "gripper"]
UID = "SO100GraspCube-v1"
KW = dict(num_envs=1, obs_mode="state", domain_randomization=False)


class StubFollower:
    """A LeRobot follower arm: the bus reads back what was commanded."""

    name = "so100_follower"

    def __init__(self, deg=None, h=480, w=640):
        self.bus = self
        self.pos = dict(zip(KEYS, np.zeros(6) if deg is None else np.asarray(deg, np.float64)))
        self.sent = []
        self.cameras = {"base_camera": self}
        self.frame = (np.arange(h * w * 3) % 251).astype(np.uint8).reshape(h, w, 3)
        self.connected = None

    def sync_read(self, what):
        assert what == "Present_Position"
        return dict(self.pos)

    def send_action(self, action):
        self.sent.append(dict(action))
        self.pos = {k: action[f"{k}.pos"] for k in KEYS}

    def async_read(self):
        return self.frame

    def connect(self):
        self.connected = True

    def disconnect(self):
        self.connected = False


def test_adapter_actions_and_qpos_match_reference():
    rng = np.random.default_rng(0)
    deg = rng.uniform(-90, 90, 6)
    js, ts = StubFollower(deg), StubFollower(deg)
    ja, ta = JLeRobot(js), TLeRobot(ts)
    ta.start()
    assert ts.connected
    jq, tq = ja.get_qpos(), ta.get_qpos()
    assert jq.shape == (1, 6) and tq.shape == (6,)
    want = np.deg2rad(deg - np.array([0, 0, 6.8, 0, 0, 0]))
    np.testing.assert_allclose(tq, want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tq, jq[0])
    for _ in range(3):
        q = rng.uniform(-1.5, 1.5, 6)
        ja.set_target_qpos(q)
        ta.set_target_qpos(q)
        assert list(ts.sent[-1]) == [f"{k}.pos" for k in KEYS]
        for k in ts.sent[-1]:
            assert abs(ts.sent[-1][k] - js.sent[-1][k]) <= 1e-9
        assert abs(ts.sent[-1]["elbow_flex.pos"] - (np.rad2deg(q[2]) + 6.8)) <= 1e-9
        # uncached after a command, then served from the cache
        np.testing.assert_array_equal(ta.get_qpos(), ja.get_qpos()[0])
        ts.pos = js.pos = {k: 0.0 for k in KEYS}
        np.testing.assert_array_equal(ta.get_qpos(), ja.get_qpos()[0])
        assert not np.allclose(ta.get_qpos(), 0)
    uncached_j, uncached_t = JLeRobot(js, use_cached_qpos=False), TLeRobot(ts, use_cached_qpos=False)
    np.testing.assert_array_equal(uncached_t.get_qpos(), uncached_j.get_qpos()[0])
    np.testing.assert_allclose(uncached_t.get_qpos(), np.deg2rad([0, 0, -6.8, 0, 0, 0]), rtol=0, atol=1e-12)
    with pytest.raises(NotImplementedError):
        ta.get_qvel()
    with pytest.raises(NotImplementedError):
        ta.set_target_qvel(np.zeros(6))
    ta.stop()
    assert ts.connected is False


def test_soft_reset_targets_match_reference(monkeypatch):
    """0.025 rad per 1/30 s toward the goal: the same targets, in order."""
    slept = []
    monkeypatch.setattr(jman.time, "sleep", slept.append)
    assert tman.time is jman.time
    deg = np.array([10.0, -20.0, 30.0, 0.0, 5.0, 0.0])
    goal = np.array([0.1, -0.2, 0.05, 0.3, 0.0, 0.2])
    js, ts = StubFollower(deg), StubFollower(deg)
    JLeRobot(js).reset(goal)
    TLeRobot(ts).reset(goal)
    assert len(ts.sent) == len(js.sent) > 10
    for a, b in zip(ts.sent, js.sent):
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-9
    steps = np.diff([[a[f"{k}.pos"] for k in KEYS] for a in ts.sent], axis=0)
    assert np.abs(steps).max() <= np.rad2deg(0.025) + 1e-9
    np.testing.assert_allclose(TLeRobot(ts).get_qpos(), goal, rtol=0, atol=1e-9)
    assert len(slept) == 2 * len(ts.sent)
    sent = len(ts.sent)
    TLeRobot(ts).reset(None)
    assert len(ts.sent) == sent


def test_sensor_data_matches_reference():
    js, ts = StubFollower(), StubFollower()
    ja, ta = JLeRobot(js), TLeRobot(ts)
    for a in (ja, ta):
        with pytest.raises(RuntimeError, match="capture_sensor_data"):
            a.get_sensor_data()
        a.capture_sensor_data()
    jd, td = ja.get_sensor_data(), ta.get_sensor_data()
    assert list(td) == list(jd) == ["base_camera"]
    assert jd["base_camera"]["rgb"].shape == (1, 480, 640, 3)
    assert td["base_camera"]["rgb"].shape == (480, 640, 3)
    np.testing.assert_array_equal(td["base_camera"]["rgb"], jd["base_camera"]["rgb"][0])
    assert ta.get_sensor_data(["wrist"]) == ja.get_sensor_data(["wrist"]) == {}
    assert list(ta.get_sensor_data(["base_camera"])) == ["base_camera"]


@pytest.fixture(scope="module")
def jax_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jphysics, "forward", jax.jit(jphysics.forward))
        yield jmake(UID, **KW)


@pytest.fixture
def no_sleep(monkeypatch):
    monkeypatch.setattr(jman.time, "sleep", lambda s: None)


def _state_reset(state, to_env):
    def reset(env, seed=None, options=None):
        env.base_sim_env.set_state_dict(to_env(state))
        env.agent.reset(np.asarray(env.base_sim_env.agent.robot.qpos).reshape(-1))

    return reset


def test_jax_pairing_fails(jax_env, no_sleep, monkeypatch):
    jb = jax_env.unwrapped
    state = tree(jb.get_state_dict(), np.array)
    jenv = JSim2RealEnv(jax_env, JLeRobot(StubFollower()), real_reset_function=_state_reset(state, lambda s: s),
                        skip_data_checks=True)
    with pytest.raises(NotImplementedError, match="velocity"):
        jenv.reset()
    # with a qvel, the (1, 6) qpos is batched again, and the agent obs has
    # keys the sim env's (qpos only) lacks: the check refuses the state
    monkeypatch.setattr(JLeRobot, "get_qvel", lambda self: np.zeros(6, np.float32))
    monkeypatch.setattr(jb, "obs_mode", "state_dict")
    real = jenv.get_obs()
    assert np.shape(real["agent"]["qpos"]) == (1, 1, 6)
    assert list(jb._get_obs_agent()) == ["qpos"] and list(real["agent"]) == ["qpos", "qvel", "controller"]
    monkeypatch.setattr(jb, "obs_mode", "state")
    with pytest.raises(AssertionError, match="Shape mismatch"):
        jenv._check_observations(jb.get_obs(), jenv.get_obs())
    # the (1, H, W, 3) frame is cropped as if it were (H=1, W=480)
    frames = JLeRobot(StubFollower())
    frames.capture_sensor_data()
    owner = types.SimpleNamespace(_sim_sensor_shapes={"base_camera": (128, 128)})
    bad = JSim2RealEnv.preprocess_sensor_data(owner, frames.get_sensor_data())["base_camera"]["rgb"]
    assert np.shape(bad) != (1, 128, 128, 3)


def _jax_get_obs(self, info=None):
    """The port's ``get_obs`` in JAX terms: the sim env's own agent layout,
    each leaf from the real robot where it reports it."""
    if info is None:
        info = self.get_info()
    base = self.base_sim_env
    try:
        real = self.agent.get_proprioception()
    except NotImplementedError:
        real = dict(qpos=self.agent.get_qpos())
    agent_obs = {k: jcommon.batch(np.asarray(real[k], np.float32)) if k in real else v
                 for k, v in base._get_obs_agent().items()}
    state_dict = dict(agent=agent_obs, extra=base._get_obs_extra(info))
    assert base.obs_mode == "state"
    return jcommon.flatten_state_dict(state_dict)


def test_repaired_pair_matches_patched_reference(jax_env, no_sleep, monkeypatch):
    monkeypatch.setattr(JLeRobot, "get_qpos", lambda self, _f=JLeRobot.get_qpos: _f(self).reshape(-1))
    monkeypatch.setattr(JSim2RealEnv, "get_obs", _jax_get_obs)
    jb = jax_env.unwrapped
    state = tree(jb.get_state_dict(), np.array)
    rest = np.rad2deg(np.asarray(jb.agent.robot.qpos).reshape(-1)) + [0, 0, 6.8, 0, 0, 0]
    js, ts = StubFollower(rest), StubFollower(rest)
    te = tmake(UID, device="cpu", **KW)
    jenv = JSim2RealEnv(jax_env, JLeRobot(js), real_reset_function=_state_reset(state, lambda s: s),
                        skip_data_checks=True)
    tenv = TSim2RealEnv(te, TLeRobot(ts), real_reset_function=_state_reset(
        state, lambda s: tree(s, lambda v: torch.as_tensor(v))))
    jobs, _ = jenv.reset()
    tobs, _ = tenv.reset()
    assert tobs.shape == te.unwrapped.get_obs().shape
    rng = np.random.default_rng(3)
    for step in range(3):
        if step:
            act = rng.uniform(-1, 1, 6).astype(np.float32)
            jobs, _, _, _, _ = jenv.step(act)
            tobs, _, _, _, _ = tenv.step(act)
            for k in ts.sent[-1]:
                assert abs(ts.sent[-1][k] - js.sent[-1][k]) <= 1e-4, (step, k)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=0, atol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(te.unwrapped.agent.robot.qpos.numpy().reshape(-1), tenv.agent.get_qpos(),
                                   rtol=0, atol=1e-5)
    assert len(ts.sent) == len(js.sent) >= 2
