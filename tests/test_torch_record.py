"""The port's RecordEpisode, trajectory dataset and merge against the JAX
package's, on the CPU.

- Both RecordEpisode wrappers on PushCube-v1 at 2 envs, fed the same actions
  (with a partial reset of env 1 after 3 steps), write files with the same
  tree, dtypes and shapes, the same episode split and the same JSON keys.
- The port's ``env_states`` rows equal its env's ``get_state_dict()`` after
  the reset and after each step, and its ``obs`` rows the obs it returned.
- On one JAX-written file, the port's ManiSkillTrajectoryDataset returns
  the JAX package's items.
- The port's merge of two files equals the JAX package's merge.
"""
import json

import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.trajectory.dataset import ManiSkillTrajectoryDataset as JDataset
from maniskill_tpu.trajectory.merge_trajectory import merge_trajectories as jmerge
from maniskill_tpu.utils.registration import make as jmake
from maniskill_tpu.wrappers.record import RecordEpisode as JRecordEpisode

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.trajectory.dataset import ManiSkillTrajectoryDataset as TDataset
from maniskill_tpu_torch.trajectory.merge_trajectory import merge_trajectories as tmerge
from maniskill_tpu_torch.wrappers.record import RecordEpisode as TRecordEpisode

from test_torch_common import one_torch_thread  # noqa: F401

h5py = pytest.importorskip("h5py")

ENV, N_ENVS = "PushCube-v1", 2


def _actions():
    rng = np.random.default_rng(0)
    return rng.uniform(-1, 1, (5, N_ENVS, 8)).astype(np.float32)


def _record(wrapper, env, out_dir, name, on_step=None):
    """3 steps, a partial reset of env 1, 2 more steps, close."""
    rec = wrapper(env, str(out_dir), save_video=False, trajectory_name=name)
    obs, _ = rec.reset(seed=0)
    if on_step:
        on_step(obs)
    for t, a in enumerate(_actions()):
        if t == 3:
            obs, _ = rec.reset(options=dict(env_idx=[1]))
            if on_step:
                on_step(obs, partial=[1])
        obs, *_ = rec.step(a)
        if on_step:
            on_step(obs)
    rec.close()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    out = tmp_path_factory.mktemp("rec")
    _record(JRecordEpisode, jmake(ENV, num_envs=N_ENVS), out, "jax")
    seen = dict(states=[], obs=[])

    def on_step(obs, partial=None):
        state = tenv.unwrapped.get_state_dict()
        snap = lambda t: {k: snap(v) for k, v in t.items()} if isinstance(t, dict) else t.clone().numpy()  # noqa: E731
        if partial:
            seen["partial"] = (snap(state), obs.clone().numpy())
        else:
            seen["states"].append(snap(state))
            seen["obs"].append(obs.clone().numpy())

    tenv = tmake(ENV, num_envs=N_ENVS, device="cpu")
    _record(TRecordEpisode, tenv, out, "port", on_step)
    return out, seen


def _tree(g):
    return {k: _tree(v) if isinstance(v, h5py.Group) else (v.shape, v.dtype) for k, v in g.items()}


def test_same_schema_as_the_jax_package(files):
    out, _ = files
    with h5py.File(out / "jax.h5") as j, h5py.File(out / "port.h5") as t:
        assert list(j.keys()) == list(t.keys()) == ["traj_0", "traj_1", "traj_2"]
        for k in j.keys():
            assert _tree(j[k]) == _tree(t[k]), k
        # the partial reset split env 1's episodes: 3 steps, then env 0's 5, env 1's 2
        assert [t[f"traj_{i}/actions"].shape[0] for i in range(3)] == [3, 5, 2]
        np.testing.assert_array_equal(t["traj_0/actions"][()], _actions()[:3, 1])
        np.testing.assert_array_equal(t["traj_1/actions"][()], _actions()[:, 0])
    jm, tm = (json.load(open(out / f"{n}.json")) for n in ("jax", "port"))
    assert jm.keys() == tm.keys()
    assert jm["env_info"] == tm["env_info"]
    assert [e.keys() for e in jm["episodes"]] == [e.keys() for e in tm["episodes"]]
    drop = lambda e: {k: v for k, v in e.items() if k != "episode_seed"}  # noqa: E731 (draws differ)
    assert [drop(e) for e in jm["episodes"]] == [drop(e) for e in tm["episodes"]]
    assert [e["episode_seed"] for e in tm["episodes"]][:2] == [1, 0]


def test_env_states_and_obs_rows_are_the_envs(files):
    out, seen = files
    states, obs = seen["states"], seen["obs"]  # after the reset and steps 1-5
    p_state, p_obs = seen["partial"]

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]

    with h5py.File(out / "port.h5") as f:
        # env 0: one episode of 5 steps, rows 0..5
        for path, _ in leaves(states[0]):
            rows = f[f"traj_1/env_states/{path}"][()]
            want = np.stack([dict(leaves(s))[path][0] for s in states])
            np.testing.assert_array_equal(rows, want, err_msg=path)
            # env 1: rows 0..3 then, after the partial reset, rows 0..2
            want1 = np.stack([dict(leaves(s))[path][1] for s in states[:4]])
            np.testing.assert_array_equal(f[f"traj_0/env_states/{path}"][()], want1, err_msg=path)
            want2 = np.stack([dict(leaves(p_state))[path][1]] + [dict(leaves(s))[path][1] for s in states[4:]])
            np.testing.assert_array_equal(f[f"traj_2/env_states/{path}"][()], want2, err_msg=path)
        np.testing.assert_array_equal(f["traj_1/obs"][()], np.stack([o[0] for o in obs]))
        np.testing.assert_array_equal(f["traj_2/obs"][0], p_obs[1])


def test_dataset_items_equal_the_jax_packages(files):
    out, _ = files
    jd, td = JDataset(str(out / "jax.h5")), TDataset(str(out / "jax.h5"))
    assert len(jd) == len(td) == 10
    assert jd.episode_keys == td.episode_keys and jd.meta == td.meta
    for i in range(len(jd)):
        a, b = jd[i], td[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)
            assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype, k
    jd.close(), td.close()


def test_merge_equals_the_jax_packages(files, tmp_path):
    out, _ = files
    inputs = [str(out / "jax.h5"), str(out / "port.h5")]
    jmerge(str(tmp_path / "j.h5"), inputs)
    tmerge(str(tmp_path / "t.h5"), inputs)
    assert json.load(open(tmp_path / "j.json")) == json.load(open(tmp_path / "t.json"))

    def assert_same(a, b):
        assert list(a.keys()) == list(b.keys())
        for k in a.keys():
            if isinstance(a[k], h5py.Group):
                assert_same(a[k], b[k])
            else:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k][()], b[k][()])

    with h5py.File(tmp_path / "j.h5") as j, h5py.File(tmp_path / "t.h5") as t:
        assert len(t.keys()) == 6
        assert_same(j, t)


def test_unbatched_actions_broadcast(tmp_path):
    env = tmake(ENV, num_envs=N_ENVS, device="cpu")
    rec = TRecordEpisode(env, str(tmp_path), save_video=False, trajectory_name="u", record_reward=False)
    rec.reset(seed=3)
    rec.step(torch.full((8,), 0.25))
    rec.close()
    with h5py.File(tmp_path / "u.h5") as f:
        np.testing.assert_array_equal(f["traj_1/actions"][()], np.full((1, 8), 0.25, np.float32))
        assert "rewards" not in f["traj_0"]


def test_json_encoder_matches_the_jax_package(tmp_path):
    from maniskill_tpu.utils import io_utils as jio

    from maniskill_tpu_torch.utils import io_utils as tio

    obj = dict(a=np.int64(3), b=np.float32(0.5), c=np.arange(4).reshape(2, 2), d=[np.int32(1), "x"])
    jio.dump_json(tmp_path / "j.json", obj)
    tio.dump_json(tmp_path / "t.json", dict(obj, e=torch.tensor([1.5, 2.0])))
    want = dict(jio.load_json(tmp_path / "j.json"), e=[1.5, 2.0])
    assert tio.load_json(tmp_path / "t.json") == want


def test_video_frames_are_saved_without_imageio(tmp_path):
    """RecordEpisode(save_video=True) tiles each rendered batch into one frame
    and writes the episode's frames as .npz (the JAX package raises where
    imageio is missing)."""
    env = tmake(ENV, num_envs=N_ENVS, device="cpu", render_mode="sensors")
    rec = TRecordEpisode(env, str(tmp_path), save_trajectory=False, trajectory_name="v")
    rec.reset(seed=0)
    for _ in range(2):
        rec.step(torch.zeros(N_ENVS, 8))
    rec.close()
    frames = np.load(tmp_path / "0.npz")["frames"]
    assert frames.shape == (3, 128, 256, 3) and frames.dtype == np.uint8
    assert frames.max() > 0
