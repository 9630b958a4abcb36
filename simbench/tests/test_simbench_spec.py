"""Each cell, configuration, traffic mix and per-layer metric is a file of its
own that the harness finds by name; adding one edits no existing file."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from simbench import spec

ROOT = spec.ROOT
BENCH = spec.benchmark()


def test_benchmark_names_only_files_that_exist():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert spec.config(c["name"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        cell = spec.workload(w["name"])
        assert cell["config"] == w["config"] and cell["traffic_name"] == w["traffic"]
        assert cell["chips"] == w["chips"] and cell["why"] == w["why"]
        assert (ROOT / "simbench" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_setup_another_e2e_and_a_layer(name):
    metrics = spec.cell_metrics(name, ["env_steps_per_s", "train_env_steps_per_s", "setup_s"], BENCH)
    names = [m["name"] for m in metrics["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2
    assert metrics["per_layer"]


def test_metric_reader_silent_without_records():
    for m in BENCH["per_layer"]:
        assert spec.metric_reader(m["name"])({}) is None


def _digest(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    """A copy of the harness gains a traffic mix, a cell and a metric reader as
    three new files; a CPU run of the new cell reads them by name, and every
    file that was there is unchanged."""
    copy = tmp_path / "simbench"
    shutil.copytree(ROOT / "simbench", copy, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path)
    (copy / "traffic" / "state_2_uniform.json").write_text(json.dumps(
        {"num_envs": 2, "obs_mode": "state", "stagger_episodes": True}))
    (copy / "workloads" / "dummy_cell.json").write_text(json.dumps(
        {"config": "pickcube_panda", "driver": "vector_env", "chips": 1, "why": "a test cell",
         "traffic": "state_2_uniform", "check": {"sample_envs": 1, "limits": {}}}))
    (copy / "metrics" / "steps_seen.sim.py").write_text(
        "def read(rec):\n    return float(len(rec.get('step_s') or [])) or None\n")
    after = _digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "from simbench import run, spec\n"
        f"assert spec.HERE == __import__('pathlib').Path({str(copy)!r})\n"
        "res, lines = run.run_cell('dummy_cell', 5, 0.5, False, device='cpu', t_start=time.perf_counter())\n"
        "print(json.dumps([res['metrics'], spec.metric_reader('steps_seen.sim')({'step_s': [1, 2]})]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=tmp_path, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    metrics, read = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["env_steps_per_s"]["value"] > 0 and metrics["setup_s"]["value"] > 0
    assert read == 2.0
