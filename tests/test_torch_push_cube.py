"""The port's PushCube-v1 (Panda, table, cube, red/white target; 100/20 Hz)
against the JAX package's, on the CPU, and the port's masked reset and
vector env on it.

- The Model from the port's builders equals the JAX one in every table
  (the target's five 1e-5-thick cylinders included).
- From the same ``reset_to_env_states``, 3 control steps of seeded random
  actions: qpos at 1e-4, qvel at 1e-3, obs and dense reward at 1e-3,
  ``success`` equal, ``contact.overflow == 0`` on both sides; the table
  carries the resting cube's weight (0.064 kg x 9.81 = 0.628 N).
- One base_camera frame of the same state through the port's plain tiled
  path against the JAX camera: the target lies 1e-3 above the table with
  rings 1e-5 apart, the closest depth race of the ported scenes.
- A masked reset: the reset envs start a fresh episode (elapsed 0, zero
  qvel, a new cube pose), the others stay bit-identical, in both packages.
- ``ManiSkillVectorEnv``: same-step auto-reset with ``final_observation``,
  ``ignore_terminations`` and ``record_metrics``.
- One whole PPO ``train_step`` in the visual branch (rgb, 4 envs).

The reference solver runs with its bf16 matvec cast made an identity (see
tests/test_torch_common.py), applied before the JAX env compiles its step.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.parallel import train as ttrain
from maniskill_tpu_torch.vector import ManiSkillVectorEnv

from test_torch_common import f32_reference_solver, one_torch_thread, tree  # noqa: F401

B = 4
ENV = dict(obs_mode="state_dict", reward_mode="dense", control_mode="pd_joint_delta_pos")
CUBE_WEIGHT = 0.064 * 9.81


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.fixture(scope="module")
def envs(f32_reference_solver):
    """(JAX env, port env), the JAX solver in f32 before its step compiles."""
    je = jmake("PushCube-v1", num_envs=B, **ENV)
    te = tmake("PushCube-v1", num_envs=B, device="cpu", **ENV)
    return je, te


def _same_start(je, te, seed):
    je.reset(seed=seed)
    state = tree(je.unwrapped.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))
    te.reset(seed=seed, options=dict(reset_to_env_states=state))
    np.testing.assert_array_equal(te.unwrapped.scene.data.qpos.numpy(), np.asarray(je.unwrapped.scene.data.qpos))


def test_model_matches_reference(envs):
    je, te = envs
    jm, tm = je.unwrapped.scene.model, te.unwrapped.scene.model
    for f in dataclasses.fields(tm):
        jv, tv = getattr(jm, f.name), getattr(tm, f.name)
        if jv is None or tv is None:
            assert jv is None and tv is None, f.name
            continue
        if isinstance(jv, (tuple, str, int, float)):
            assert jv == tv, (f.name, jv, tv)
            continue
        jv, tv = np.asarray(jv), _np(tv)
        assert jv.shape == tv.shape, (f.name, jv.shape, tv.shape)
        if jv.dtype.kind in "biu":
            np.testing.assert_array_equal(tv, jv, err_msg=f.name)
        else:
            np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-7, err_msg=f.name)
    assert len(tm.mocap_bodies) == 1  # the target is a dof-less marker


def test_env_steps_match_reference(envs):
    je, te = envs
    _same_start(je, te, 0)
    rng = np.random.default_rng(0)
    for _ in range(3):
        action = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
        jobs, jrew, jterm, _, jinfo = je.step(action)
        tobs, trew, tterm, _, tinfo = te.step(torch.as_tensor(action))
    jdata, tdata = je.unwrapped.scene.data, te.unwrapped.scene.data
    np.testing.assert_allclose(tdata.qpos.numpy(), np.asarray(jdata.qpos), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tdata.qvel.numpy(), np.asarray(jdata.qvel), rtol=0, atol=1e-3)
    assert np.abs(np.asarray(jdata.qvel)).max() > 0.1, "the arm did not move"
    for part in ("agent", "extra"):
        for path, jv in jax.tree_util.tree_leaves_with_path(jobs[part]):
            tv = tobs[part]
            for p in path:
                tv = tv[p.key]
            np.testing.assert_allclose(_np(tv).astype(np.float32), np.asarray(jv, np.float32),
                                       rtol=0, atol=1e-3, err_msg=f"{part}{path}")
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(tinfo["success"].numpy(), np.asarray(jinfo["success"]))
    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
    assert tdata.contact.overflow.tolist() == [0] * B
    assert np.asarray(jdata.contact.overflow).tolist() == [0] * B


def test_cube_rests_on_table(envs):
    """Zero actions: the table's force on the cube is its weight in both."""
    je, te = envs
    _same_start(je, te, 1)
    for _ in range(2):
        je.step(np.zeros((B, 8), np.float32))
        te.step(torch.zeros(B, 8))
    for env in (je, te):
        b = env.unwrapped
        force = _np(b.scene.get_pairwise_contact_forces(b.table_scene.table, b.obj))
        np.testing.assert_allclose(force[:, 2], CUBE_WEIGHT, rtol=2e-3)
        np.testing.assert_allclose(force[:, :2], 0.0, atol=1e-4)


def test_rgb_frame_matches_reference(envs):
    """The base_camera frame of one state: segmentation agrees on >= 0.999
    of the pixels and rgb is equal wherever it does."""
    je, te = envs
    _same_start(je, te, 2)
    jb, tb = je.unwrapped, te.unwrapped
    jcam, tcam = jb._sensors["base_camera"], tb._sensors["base_camera"]
    jcam._get_mesh(tuple(jb._hidden_objects))

    def jax_obs(data):
        jb.scene.bind(data)
        return jcam.get_obs(rgb=True, segmentation=True, hidden_actors=jb._hidden_objects)

    data = jb.scene.data
    jo = {k: np.asarray(v) for k, v in jax.jit(jax_obs)(data).items()}
    jb.scene.bind(data)  # the trace left a tracer bound
    to = {k: v.numpy() for k, v in tcam.get_obs(rgb=True, segmentation=True,
                                                hidden_actors=tb._hidden_objects).items()}
    seg_same = (to["segmentation"] == jo["segmentation"])[..., 0]
    assert seg_same.mean() >= 0.999, seg_same.mean()
    target = tb.goal_region.per_scene_id
    assert (jo["segmentation"] == target).sum() > 100, "the target is not in view"
    np.testing.assert_array_equal(to["rgb"][seg_same], jo["rgb"][seg_same])


def test_masked_reset_matches_reference_semantics(envs):
    """Envs 1 and 2 reset through a device bool mask (the reference by
    indices): they get elapsed 0, zero qvel and a new cube pose; envs 0 and
    3 stay bit-identical."""
    je, te = envs
    mask = np.array([False, True, True, False])
    for env, opts in ((je, dict(env_idx=np.nonzero(mask)[0])), (te, dict(env_idx=torch.as_tensor(mask)))):
        base = env.unwrapped
        env.reset(seed=5)
        for _ in range(2):
            env.step(np.full((B, 8), 0.5, np.float32) if env is je else torch.full((B, 8), 0.5))
        qpos0, qvel0 = _np(base.scene.data.qpos).copy(), _np(base.scene.data.qvel).copy()
        cube0 = _np(base.obj.pose.p).copy()
        env.reset(options=opts)
        qpos1, qvel1 = _np(base.scene.data.qpos), _np(base.scene.data.qvel)
        assert _np(base.elapsed_steps).tolist() == [2, 0, 0, 2]
        np.testing.assert_array_equal(qpos1[~mask], qpos0[~mask])
        np.testing.assert_array_equal(qvel1[~mask], qvel0[~mask])
        assert not np.abs(qvel1[mask]).any()
        assert (np.abs(_np(base.obj.pose.p)[mask, :2] - cube0[mask, :2]) > 1e-6).all()


def test_vector_env_autoreset_and_metrics(envs):
    """The cube placed on the target succeeds at once: the vector env
    returns the final obs and info, resets those envs in the same step and
    records the finished episode; with ignore_terminations nothing resets."""
    _, te = envs
    base = te.unwrapped
    for ignore in (False, True):
        venv = ManiSkillVectorEnv(te, auto_reset=True, ignore_terminations=ignore, record_metrics=True)
        assert venv.max_episode_steps == 50
        venv.reset(seed=3)
        state = base.get_state_dict()
        goal = base.goal_region.pose.p
        cube = state["actors"]["cube"].clone()
        cube[:2, :2] = goal[:2, :2]  # envs 0 and 1 start on the target
        state["actors"]["cube"] = cube
        venv.reset(options=dict(reset_to_env_states=state))
        obs, rew, term, trunc, info = venv.step(torch.zeros(B, 8))
        assert info["episode"]["success_once"].tolist() == [True, True, False, False]
        assert info["episode"]["l"].tolist() == [1] * B
        if ignore:
            assert not term.any() and "final_observation" not in info
            assert base.elapsed_steps.tolist() == [1] * B
            continue
        assert term.tolist() == [True, True, False, False]
        assert info["_final_info"].tolist() == [True, True, False, False]
        final = info["final_observation"]
        np.testing.assert_array_equal(final["extra"]["obj_pose"][2:].numpy(), obs["extra"]["obj_pose"][2:].numpy())
        assert (final["extra"]["obj_pose"][:2] != obs["extra"]["obj_pose"][:2]).any()
        assert base.elapsed_steps.tolist() == [0, 0, 1, 1]
        assert venv.success_once.tolist() == [False, False, False, False]
        assert venv.returns[:2].tolist() == [0.0, 0.0] and (venv.returns[2:] != 0).all()


def test_rgb_train_step():
    """One whole iteration of the visual branch (PushCube-v1 rgb, 4 envs,
    rollout 2) on the CPU: finite, and the NatureCNN sees 128x128 frames."""
    env = tmake("PushCube-v1", num_envs=4, obs_mode="rgb", device="cpu")
    raw, _ = env.reset(seed=0)
    trainer = ttrain.PPOTrainer(env, ttrain.PPOConfig(rollout_steps=2, update_epochs=1, num_minibatches=1), raw)
    obs = trainer.obs_tf(raw)
    assert obs["rgb"].shape == (4, 128, 128, 3) and obs["rgb"].dtype == torch.uint8
    assert obs["state"].shape == (4, 34)
    obs, _, metrics = trainer.train_step(obs, torch.zeros(4, dtype=torch.int32))
    assert np.isfinite(float(metrics["loss"]))
    for k in ("bad_params", "bad_obs", "bad_rewards"):
        assert int(metrics[k]) == 0, k
    assert obs["rgb"].shape == (4, 128, 128, 3)


def test_vector_env_truncates_and_resets_at_the_time_limit(envs):
    """With terminations ignored, all envs truncate together at the 50-step
    limit and restart in the same step."""
    _, te = envs
    venv = ManiSkillVectorEnv(te, auto_reset=True, ignore_terminations=True, record_metrics=True)
    venv.reset(seed=4)
    for i in range(1, 51):
        obs, rew, term, trunc, info = venv.step(torch.zeros(B, 8))
        assert bool(trunc.all()) == (i == 50)
    assert info["_elapsed_steps"].tolist() == [50] * B and info["_final_info"].all()
    assert info["final_info"]["episode"]["l"].tolist() == [50] * B
    assert te.unwrapped.elapsed_steps.tolist() == [0] * B
    assert venv.lengths.tolist() == [0] * B
