"""The port's seven demo scripts (maniskill_tpu_torch/examples/demo_*.py),
each ``main(argv)`` at one env and a few steps on the CPU.

demo_robot prints the robot's structure as the JAX package's demo prints it
(line for line, but for the action space's repr) and lists the same robot
uids; the others are held to what the env itself gives: the frames of
demo_reset_distribution are ``env.render()`` after each seeded reset, the
cloud of demo_vis_pcd is the env's pointcloud, the legend of
demo_vis_segmentation names every segmentation id in the frame.
"""
import io
import os
from contextlib import redirect_stdout

import numpy as np
import torch

from maniskill_tpu.examples import demo_robot as jdemo_robot

from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.examples import (demo_manual_control, demo_random_action, demo_reset_distribution,
                                          demo_robot, demo_vis_pcd, demo_vis_segmentation, demo_vis_textures)

from test_torch_common import one_torch_thread  # noqa: F401

CPU = ["--device", "cpu"]


def test_random_action():
    out = demo_random_action.main(["-e", "PushCube-v1", "-n", "1", "--steps", "3"] + CPU)
    assert out["reward"].shape == (3,) and np.isfinite(out["reward"]).all()
    assert bool(torch.isfinite(out["env"].unwrapped.scene.data.qpos).all())


def test_reset_distribution(tmp_path):
    out = demo_reset_distribution.main(["-n", "2", "--seed", "4", "--record-dir", str(tmp_path)] + CPU)
    frames = np.load(out["path"])["frames"]
    assert frames.shape == (2, 512, 512, 3) and frames.dtype == np.uint8
    assert not np.array_equal(frames[0], frames[1]), "two seeds, two cube positions"
    env = tmake("PushCube-v1", num_envs=1, obs_mode="state", reward_mode="none", render_mode="rgb_array",
                device="cpu")
    env.reset(seed=5)
    np.testing.assert_array_equal(env.render()[0].numpy(), frames[1])


def _structure(text):
    keep = ("robot:", "dof:", "links", "active joints:", "control modes:", "keyframes:")
    return [line.strip() for line in text.splitlines() if line.strip().startswith(keep)]


def test_robot_structure_matches_reference(tmp_path):
    buf = io.StringIO()
    with redirect_stdout(buf):
        jdemo_robot.main(["-r", "panda"])
    ref = buf.getvalue()
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = demo_robot.main(["-r", "panda", "--keyframes", "--steps", "2", "--save-frames", str(tmp_path)] + CPU)
    assert _structure(buf.getvalue()) == _structure(ref) and len(_structure(ref)) == 6
    assert out["keyframes"] == ["rest"] and out["settled"]["rest"].shape == (9,)
    np.testing.assert_allclose(out["settled"]["rest"][:7], [0, np.pi / 8, 0, -5 * np.pi / 8, 0, 3 * np.pi / 4,
                                                            np.pi / 4], atol=0.05)
    assert os.listdir(tmp_path)
    buf = io.StringIO()
    with redirect_stdout(buf):
        jdemo_robot.main(["--list"])
    assert demo_robot.main(["--list"])["uids"] == buf.getvalue().split()


def test_manual_control_keys(monkeypatch, tmp_path):
    keys = iter("wg1xdq")
    monkeypatch.setattr(demo_manual_control, "_read_key", lambda: next(keys))
    out = demo_manual_control.main(["-e", "PickCube-v1", "-c", "pd_ee_delta_pos", "--save-frames",
                                    str(tmp_path)] + CPU)
    acts = out["action"]
    assert acts.shape == (4, 4)  # w g 1 d (x resets, q quits)
    np.testing.assert_array_equal(acts[0], [1, 0, 0, 1])
    np.testing.assert_array_equal(acts[1], [0, 0, 0, -1])  # g closes the gripper
    np.testing.assert_array_equal(acts[2], [0, 0, 0, -1])  # an unmapped key: no motion
    np.testing.assert_array_equal(acts[3], [0, -1, 0, -1])
    assert len(os.listdir(tmp_path)) == 4
    keys = iter("2+-q")  # the generic mode: pick a dimension, nudge it
    monkeypatch.setattr(demo_manual_control, "_read_key", lambda: next(keys))
    out = demo_manual_control.main(["-e", "PushCube-v1", "-c", "pd_joint_delta_pos"] + CPU)
    np.testing.assert_array_equal(out["action"][:, 2], [1, -1])
    assert np.abs(out["action"][:, [0, 1, 3, 4, 5, 6]]).sum() == 0


def test_vis_pcd(tmp_path):
    path = tmp_path / "cloud.ply"
    out = demo_vis_pcd.main(["--steps", "1", "-o", str(path)] + CPU)
    xyz = out["xyz"]
    assert len(xyz) > 1000 and np.isfinite(xyz).all()
    header = path.read_text().split("end_header\n")
    assert f"element vertex {len(xyz)}" in header[0] and len(header[1].splitlines()) == len(xyz)
    assert xyz[:, 2].min() > -0.05  # the table top and what stands on it
    demo_vis_pcd.main(["--steps", "0", "-o", str(tmp_path / "cloud.npy")] + CPU)
    assert np.load(tmp_path / "cloud.npy").shape[1] == 6


def test_vis_segmentation(tmp_path):
    out = demo_vis_segmentation.main(["-o", str(tmp_path / "seg.png")] + CPU)
    ids = set(np.unique(out["seg"]).tolist()) - {0}
    assert ids and ids <= set(out["legend"]), (ids, out["legend"])
    assert any("cube" in v for v in out["legend"].values())
    assert os.path.exists(out["path"]) and out["rgb"].shape == (128, 128, 3)


def test_vis_textures(tmp_path):
    out = demo_vis_textures.main(["-o", "rgb+depth+normal+segmentation", "--out", str(tmp_path / "t.png")] + CPU)
    assert out["names"] == ["base_camera/depth", "base_camera/normal", "base_camera/rgb",
                            "base_camera/segmentation"]
    assert out["tiled"].shape == (256, 256, 3) and os.path.exists(out["path"])
