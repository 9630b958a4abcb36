"""The port's benchmarking CLIs (maniskill_tpu_torch/examples/benchmarking)
on the CPU.

- ``Profiler.update_csv`` writes the JAX package's columns in its order, and
  replaces a row of the same config, as the JAX ``Profiler`` does on the same
  stats (the files compared byte for byte).
- ``gpu_sim`` and ``bench_render`` ``main([...])`` at 4 envs and 2 steps
  with ``--device cpu``: the rates, the CSV row and the JSON line (the JAX
  CLI's keys; ``vs_baseline`` against 32,138 fps). Without ``--device`` they
  want the card and raise here: no CLI falls back to the CPU.
- ``Profiler.trace`` writes a torch.profiler trace.
"""
import csv
import json
import os

import pytest
import torch

from maniskill_tpu.examples.benchmarking import profiling as jprofiling

from maniskill_tpu_torch.examples.benchmarking import bench_render, gpu_sim
from maniskill_tpu_torch.examples.benchmarking import profiling as tprofiling

from test_torch_common import one_torch_thread  # noqa: F401

CONFIG = dict(env_id="PickCube-v1", num_envs=4, obs_mode="state", control_mode="pd_joint_delta_pos",
              sim_freq=120, control_freq=60)


def _stats(profiler, fps):
    profiler.stats = {
        "env.step": dict(fps=fps, psps=fps / 4, total_steps=2, num_envs=4, dt=0.5, cpu_mem_mb=512.25, gpu_mem_mb=0.0),
        "env.reset": dict(fps=fps / 3, psps=fps / 12, total_steps=10, num_envs=4, dt=0.1, cpu_mem_mb=600.04,
                          gpu_mem_mb=12.5),
    }


def test_update_csv_matches_reference(tmp_path):
    paths = {}
    for name, module in (("jax", jprofiling), ("port", tprofiling)):
        path = paths[name] = tmp_path / f"{name}.csv"
        p = module.Profiler()
        _stats(p, 1234.5678)
        p.update_csv(str(path), CONFIG)
        p.update_csv(str(path), dict(CONFIG, num_envs=8))  # a second row
        _stats(p, 999.0)
        p.update_csv(str(path), CONFIG)  # replaces the first row
    assert paths["port"].read_text() == paths["jax"].read_text()
    with open(paths["port"]) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == list(CONFIG) + ["env.step/fps", "env.step/psps", "env.reset/fps", "env.reset/psps",
                                            "cpu_mem_mb", "gpu_mem_mb"]
    assert [r["num_envs"] for r in rows] == ["8", "4"] and rows[1]["env.step/fps"] == "999.0"


def test_gpu_sim_on_the_cpu(tmp_path, capsys):
    path = tmp_path / "rates.csv"
    out = gpu_sim.main(["-e", "PickCube-v1", "-n", "4", "--num-steps", "2", "--device", "cpu",
                        "--save-results", str(path)])
    stats = out["profiler"].stats
    assert set(stats) == {"env.step", "env.reset"}
    assert stats["env.step"]["total_steps"] == 2 and stats["env.step"]["fps"] > 0
    assert stats["env.step"]["gpu_mem_mb"] == 0.0  # no card: no device memory to read
    base = out["env"].unwrapped
    assert (base.sim_freq, base.control_freq) == (120, 60)
    with open(path) as f:
        (row,) = list(csv.DictReader(f))
    assert {k: row[k] for k in CONFIG} == {k: str(v) for k, v in CONFIG.items()}
    printed = capsys.readouterr().out
    assert "env.step:" in printed and "env.reset:" in printed and "nbody=" in printed


def test_bench_render_on_the_cpu(capsys):
    out = bench_render.main(["-n", "4", "--steps", "2", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "cartpole_rgb_128x128_fps" and line["unit"] == "env*frames/s"
    assert line["vs_baseline"] == round(line["value"] / 32138.0, 3) or abs(
        line["vs_baseline"] - line["value"] / 32138.0) < 1e-3
    assert out["obs"]["sensor_data"]["base_camera_0"]["rgb"].shape == (4, 128, 128, 3)


@pytest.mark.parametrize("cli", ["gpu_sim", "bench_render"])
def test_clis_want_the_card(cli):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    main = {"gpu_sim": gpu_sim.main, "bench_render": bench_render.main}[cli]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["-n", "2"])


def test_profiler_trace(tmp_path):
    p = tprofiling.Profiler()
    with p.trace(str(tmp_path / "trace")):
        torch.ones(8) + 1
    trace = tmp_path / "trace" / "trace.json"
    assert trace.exists() and "traceEvents" in json.loads(trace.read_text())
    assert os.path.getsize(trace) > 0
