"""The port's h5py-free HDF5 reader and writer (maniskill_tpu_torch/utils/h5.py)
against h5py, on the CPU.

- Every dataset of the repo's 8 demo files read by the port equals h5py's:
  the same names in the same order, shapes, dtypes (bool included), values,
  and numpy scalars for scalar datasets.
- h5py reads what the port writes as it was written: nested groups, scalars,
  bool, every float and int dtype of the subset, an empty group, and 1,100
  ``traj_*`` groups (a group B-tree of two levels); h5py can then append to
  the file.
- The port refuses a chunked, a gzip-filtered and a compact dataset, and a
  file of h5py's ``libver="latest"``, with ``UnsupportedHDF5``.
- A process that blocks jax, flax, optax, gymnasium, maniskill_tpu, h5py,
  imageio and pandas imports the data path's modules and the last trainers'
  (Diffusion Policy, ACT, RFCL, the SB3 adapter, the LeRobot converter,
  whose ``main`` alone needs pandas and says so), records two PushCube steps
  on the CPU, reads the file back and runs one Diffusion Policy and one ACT
  epoch.
"""
import glob
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from maniskill_tpu_torch.utils import h5

h5py = pytest.importorskip("h5py")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMOS = sorted(glob.glob(os.path.join(REPO, "demos", "*", "mp_*.h5")))


def assert_same_tree(ref, mine, path="/"):
    assert list(ref.keys()) == list(mine.keys()), path
    for key in ref.keys():
        a, b = ref[key], mine[key]
        if isinstance(a, h5py.Group):
            assert isinstance(b, h5.Group), path + key
            assert_same_tree(a, b, path + key + "/")
            continue
        x, y = a[()], b[()]
        assert type(x) is type(y), (path + key, type(x), type(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype, (path + key, np.asarray(x).dtype, np.asarray(y).dtype)
        assert np.shape(x) == np.shape(y) == a.shape == b.shape, path + key
        assert b.dtype == a.dtype, path + key
        np.testing.assert_array_equal(x, y, err_msg=path + key)


def test_the_demo_files_are_eight():
    assert len(DEMOS) == 8, DEMOS


@pytest.mark.parametrize("path", DEMOS, ids=lambda p: os.path.basename(p))
def test_reads_demo_equal_to_h5py(path):
    with h5py.File(path, "r") as ref, h5.File(path, "r") as mine:
        assert_same_tree(ref, mine)
        first = sorted(ref.keys())[0]
        assert mine[f"{first}/env_states/actors"].keys() == list(ref[first]["env_states"]["actors"].keys())
        assert f"{first}/actions" in mine and f"{first}/nothing" not in mine


def _written(tmp_path):
    rng = np.random.default_rng(0)
    data = {}
    path = str(tmp_path / "port.h5")
    with h5.File(path, "w") as f:
        for i in range(1100):
            g = f.create_group(f"traj_{i}")
            for name, value in (("actions", rng.normal(size=(5, 3)).astype(np.float32)),
                                ("success", bool(i % 3 == 0)),
                                ("terminated", rng.uniform(size=5) < 0.5),
                                ("env_states/actors/cube", rng.normal(size=(6, 13)).astype(np.float32))):
                g.create_dataset(name, data=value)
                data[f"traj_{i}/{name}"] = value
        f.create_group("empty")
        for dt in ("i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f4", "f8", "?", ">i4", ">f8"):
            value = (rng.normal(size=(3, 2)) * 50).astype(dt)
            f.create_dataset(f"dtypes/{dt}", data=value)
            data[f"dtypes/{dt}"] = value
        for name, value in (("scalar_f8", np.float64(3.5)), ("scalar_i4", np.int32(-7)),
                            ("scalar_bool", np.bool_(True)), ("zero_rows", np.zeros((0, 4), np.float32))):
            f.create_dataset(name, data=value)
            data[name] = value
    return path, data


def test_h5py_reads_the_port_writers_file(tmp_path):
    path, data = _written(tmp_path)
    with h5py.File(path, "r") as ref:
        traj = [k for k in ref.keys() if k.startswith("traj_")]
        assert len(traj) == 1100
        assert list(ref["empty"].keys()) == []
        for name, want in data.items():
            got = ref[name][()]
            assert np.asarray(got).dtype == np.asarray(want).dtype, name
            assert np.shape(got) == np.shape(want), name
            np.testing.assert_array_equal(got, want, err_msg=name)
        assert isinstance(ref["traj_7/success"][()], np.bool_)
        with h5.File(path, "r") as mine:
            assert_same_tree(ref, mine)
    with h5py.File(path, "a") as f:  # h5py takes the layout as its own
        f.create_dataset("traj_1100/actions", data=np.ones((2, 3), np.float32))
    with h5py.File(path, "r") as ref:
        assert len(ref.keys()) == 1101 + 6  # the traj_ groups, dtypes, empty and 4 datasets
        np.testing.assert_array_equal(ref["traj_1099/actions"][()], data["traj_1099/actions"])


def test_group_copy_and_unsupported_dtype(tmp_path):
    src_path, data = _written(tmp_path)
    out = str(tmp_path / "copy.h5")
    with h5.File(src_path, "r") as src, h5.File(out, "w") as dst:
        h5.copy(src["traj_3"], dst, "traj_0")
        with pytest.raises(TypeError, match="outside the supported subset"):
            dst.create_dataset("half", data=np.zeros(2, np.float16))
        with pytest.raises(ValueError, match="already exists"):
            dst.create_group("traj_0")
    with h5py.File(out, "r") as f:
        np.testing.assert_array_equal(f["traj_0/env_states/actors/cube"][()], data["traj_3/env_states/actors/cube"])


@pytest.mark.parametrize("kind, message", [
    ("chunked", "chunked storage"),
    ("gzip", "filter pipeline"),
    ("compact", "compact storage"),
])
def test_refuses_datasets_outside_the_subset(tmp_path, kind, message):
    path = str(tmp_path / f"{kind}.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("plain", data=np.arange(4.0))
        kw = dict(chunked=dict(chunks=(5, 5)), gzip=dict(compression="gzip"))
        if kind == "compact":
            space = h5py.h5s.create_simple((2,))
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            h5py.h5d.create(f.id, b"x", h5py.h5t.NATIVE_DOUBLE, space, dcpl=dcpl)
        else:
            f.create_dataset("x", data=np.zeros((10, 10)), **kw[kind])
    with h5.File(path, "r") as f:
        np.testing.assert_array_equal(f["plain"][()], np.arange(4.0))
        with pytest.raises(h5.UnsupportedHDF5, match=message):
            f["x"][()]


def test_refuses_a_new_format_file(tmp_path):
    path = str(tmp_path / "latest.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.zeros(3))
    with pytest.raises(h5.UnsupportedHDF5, match="superblock version"):
        h5.File(path, "r")


def test_data_path_imports_without_jax_h5py_or_imageio(tmp_path):
    """The port's data path and trainers (and the sim2real, asset and tree
    modules) import no jax, flax, optax, gymnasium, maniskill_tpu, h5py,
    imageio or pandas: a process that blocks
    them records two PushCube steps on the CPU, reads the file back and
    trains one Diffusion Policy and one ACT epoch."""
    code = textwrap.dedent(f'''
        import sys
        import importlib.abc

        BLOCKED = ("jax", "jaxlib", "flax", "optax", "gymnasium", "maniskill_tpu", "h5py", "imageio", "pandas")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import: {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        for name in BLOCKED:  # absent, as on the card's machine: find_spec gives None, import raises
            sys.modules[name] = None
        import numpy as np
        import maniskill_tpu_torch.envs
        from maniskill_tpu_torch import make
        from maniskill_tpu_torch.utils import h5, io_utils, visualization
        from maniskill_tpu_torch.wrappers import RecordEpisode, FlattenRGBDObservationWrapper, CPUGymWrapper
        from maniskill_tpu_torch.wrappers import FrameStack, ActionRepeatWrapper, CachedResetWrapper
        from maniskill_tpu_torch.wrappers import VisualEncoderWrapper, FlattenActionSpaceWrapper
        from maniskill_tpu_torch.trajectory import dataset, merge_trajectory, replay_trajectory
        from maniskill_tpu_torch.examples.baselines import bc, rlpd
        from maniskill_tpu_torch.examples.motionplanning import run
        from maniskill_tpu_torch.examples.baselines import act, diffusion_policy as dp, rfcl as rfcl_cli
        from maniskill_tpu_torch.parallel import rfcl
        from maniskill_tpu_torch.trajectory import convert_to_lerobot
        from maniskill_tpu_torch.vector.sb3 import ManiSkillSB3VectorEnv
        from maniskill_tpu_torch.envs.sim2real_env import Sim2RealEnv
        from maniskill_tpu_torch.agents.robots.lerobot import LeRobotRealAgent
        from maniskill_tpu_torch.utils import download_asset, tree, logging_utils
        from maniskill_tpu_torch.utils.assets import DATA_SOURCES
        from maniskill_tpu_torch.parallel import make_sharded_ppo_step
        import torch

        env = RecordEpisode(make("PushCube-v1", num_envs=2, device="cpu"), {str(tmp_path)!r},
                            save_video=False, trajectory_name="t")
        env.reset(seed=0)
        for _ in range(2):
            env.step(np.zeros((2, 8), np.float32))
        env.close()
        with h5.File({str(tmp_path / "t.h5")!r}) as f:
            assert f.keys() == ["traj_0", "traj_1"], f.keys()
            assert f["traj_1/actions"].shape == (2, 8)
            assert f["traj_1/env_states/actors/cube"].shape == (3, 13)
        visualization.images_to_video([np.zeros((4, 4, 3), np.uint8)] * 2, {str(tmp_path)!r}, "v")
        try:
            convert_to_lerobot.main(["--traj-path", "t.h5", "--output-dir", "out"])
            raise AssertionError("the converter ran without pandas")
        except ImportError as e:
            assert "pandas" in str(e), e
        g = torch.Generator().manual_seed(0)
        X, Y = torch.randn(16, 22, generator=g), torch.rand(16, 8, 8, generator=g) * 2 - 1
        XI = torch.randint(0, 256, (16, 2, 32, 32, 3), generator=g, dtype=torch.uint8)
        model = dp.Denoiser("unet", 8, 8, 22, (32, 32, 3), 2, 64, (16, 32))
        loss = dp.epoch_step(model, torch.optim.Adam(model.parameters()), X, Y, XI,
                             torch.as_tensor(dp.ddpm_schedule(6)[2]), dp.draw_epoch(g, 16, 8, 6, 8, 8))
        assert torch.isfinite(loss), loss
        model = act.ACT(22, 8, 8, dim=16, heads=2, layers=1, latent_dim=4)
        loss = act.epoch_step(model, torch.optim.AdamW(model.parameters(), weight_decay=1e-4), X, Y, 10.0,
                              act.draw_epoch(g, 16, 8, 4))
        assert torch.isfinite(loss), loss
        loaded = [m for m, mod in sys.modules.items() if m.split(".")[0] in BLOCKED and mod is not None]
        assert not loaded, loaded
        print("RECORD_OK")
    ''')
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and "RECORD_OK" in res.stdout, res.stderr[-3000:]
    assert json.load(open(tmp_path / "t.json"))["episodes"][1]["elapsed_steps"] == 2
    assert np.load(tmp_path / "v.npz")["frames"].shape == (2, 4, 4, 3)
