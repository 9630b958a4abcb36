"""The port's six primitive tabletop tasks (StackCube, PullCube, PlaceSphere,
LiftPegUpright, PullCubeTool, StackPyramid) against the JAX package's, at
4 envs on the CPU.

For each task both packages start from the JAX env's state after its reset
(through ``set_state_dict``) and take 10 steps of the same seeded random
``pd_joint_delta_pos`` actions. Then: the obs within 1e-4, the normalized
dense reward within 1e-4 (StackPyramid has only the sparse reward, compared
the same way), ``success`` and ``fail`` equal, ``contact.overflow == 0`` on
both sides; the candidate collision pairs, body types and geoms of the two
models are equal (the kinematic bin and the two-box tool included). Each
task's JAX env is made once, with the solver's bf16 matvec cast made an
identity before it compiles (``f32_solver``, tests/test_torch_common.py);
the pointcloud test reuses StackCube's.
"""
import numpy as np
import pytest
import torch

import jax
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake

from test_torch_common import f32_reference_solver, one_torch_thread, tree  # noqa: F401

B = 4
TASKS = ["StackCube-v1", "PullCube-v1", "PlaceSphere-v1", "LiftPegUpright-v1", "PullCubeTool-v1", "StackPyramid-v1"]


def _kwargs(env_id):
    reward_mode = "sparse" if env_id == "StackPyramid-v1" else "normalized_dense"
    return dict(num_envs=B, obs_mode="state_dict", reward_mode=reward_mode, control_mode="pd_joint_delta_pos")


@pytest.fixture(scope="module")
def jax_env(f32_reference_solver):
    """``jax_env(env_id)``: the task's JAX env, made once per module."""
    envs = {}

    def get(env_id):
        if env_id not in envs:
            envs[env_id] = jmake(env_id, **_kwargs(env_id))
        return envs[env_id]

    return get


@pytest.mark.parametrize("env_id", TASKS)
def test_task_matches_reference(env_id, jax_env):
    je = jax_env(env_id)
    te = tmake(env_id, device="cpu", **_kwargs(env_id))
    je.reset(seed=3)
    te.reset(seed=3, options=dict(reset_to_env_states=tree(
        je.unwrapped.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))))
    np.testing.assert_array_equal(te.unwrapped.scene.data.qpos.numpy(), np.asarray(je.unwrapped.scene.data.qpos))
    jm, tm = je.unwrapped.scene.model, te.unwrapped.scene.model
    for f in ("pair_geom1", "pair_geom2", "body_type", "geom_body", "geom_type"):
        np.testing.assert_array_equal(np.asarray(getattr(tm, f)), np.asarray(getattr(jm, f)), err_msg=f)
    assert tm.max_active_contacts == jm.max_active_contacts

    rng = np.random.default_rng(7)
    for _ in range(10):
        action = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
        jobs, jrew, jterm, _, jinfo = je.step(action)
        tobs, trew, tterm, _, tinfo = te.step(torch.as_tensor(action))
    for path, jv in jax.tree_util.tree_leaves_with_path(jobs):
        tv = tobs
        for p in path:
            tv = tv[p.key]
        np.testing.assert_allclose(tv.numpy().astype(np.float32), np.asarray(jv, np.float32),
                                   rtol=0, atol=1e-4, err_msg=f"{env_id} obs{path}")
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=0, atol=1e-4)
    for k in ("success", "fail"):
        assert (k in tinfo) == (k in jinfo), k
        if k in jinfo:
            np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]), err_msg=k)
    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
    assert te.unwrapped.scene.data.contact.overflow.tolist() == [0] * B
    assert np.asarray(je.unwrapped.scene.data.contact.overflow).tolist() == [0] * B
    qvel = np.asarray(je.unwrapped.scene.data.qvel)
    assert np.abs(qvel).max() > 0.1, "nothing moved"


def test_stack_cube_pointcloud_matches_reference(jax_env):
    """The pointcloud obs of one StackCube-v1 state at 4 envs: the port's
    env in ``obs_mode="pointcloud"`` against the JAX package's camera and
    ``sensor_data_to_pointcloud`` on the same state. Segmentation agrees on
    at least 0.999 of the points (the JAX package's CPU rasterizer and the
    port's tiled path may resolve an edge pixel differently: 3 of 65,536
    here), and where it agrees rgb is within one 8-bit step (equal on at
    least 0.9999 of the points; the shading's float rounding puts 3 channel
    values one step apart here) and xyzw within 1e-3 m."""
    from maniskill_tpu.envs.utils.observations import sensor_data_to_pointcloud as j_to_pointcloud

    je = jax_env("StackCube-v1")
    te = tmake("StackCube-v1", num_envs=B, obs_mode="pointcloud", control_mode="pd_joint_delta_pos", device="cpu")
    je.reset(seed=4)
    te.reset(seed=4, options=dict(reset_to_env_states=tree(
        je.unwrapped.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))))
    jb = je.unwrapped
    jcam = jb._sensors["base_camera"]
    jcam._get_mesh(tuple(jb._hidden_objects))

    def jax_pointcloud(data):
        jb.scene.bind(data)
        sensor_data = {"base_camera": jcam.get_obs(rgb=True, segmentation=True, position=True,
                                                   hidden_actors=jb._hidden_objects)}
        obs = dict(sensor_data=sensor_data, sensor_param={"base_camera": jcam.get_params()})
        return j_to_pointcloud(obs, jb._sensors)["pointcloud"]

    data = jb.scene.data
    jpc = {k: np.asarray(v) for k, v in jax.jit(jax_pointcloud)(data).items()}
    jb.scene.bind(data)  # the trace left a tracer bound
    tpc = {k: v.numpy() for k, v in te.unwrapped.get_obs()["pointcloud"].items()}
    assert sorted(tpc) == sorted(jpc) == ["rgb", "segmentation", "xyzw"]
    assert tpc["xyzw"].shape == (B, 128 * 128, 4)
    same = (tpc["segmentation"] == jpc["segmentation"])[..., 0]
    assert same.mean() >= 0.999, same.mean()
    trgb, jrgb = tpc["rgb"][same].astype(np.int32), jpc["rgb"][same].astype(np.int32)
    np.testing.assert_allclose(trgb, jrgb, rtol=0, atol=1)
    assert (trgb == jrgb).all(-1).mean() >= 0.9999
    np.testing.assert_allclose(tpc["xyzw"][same], jpc["xyzw"][same], rtol=0, atol=1e-3)
    cube_a = te.unwrapped.cubeA.per_scene_id
    assert (tpc["segmentation"] == cube_a).sum() > 20 and (tpc["xyzw"][..., 3] == 0).any()
