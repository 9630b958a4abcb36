"""A run at a tiny size on the CPU: the result line's form, the refusal
without a card, no JAX in the process, and the check catching a broken
step (the CPU run skips only the harness's look for a card)."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from simbench import faults, run, spec

ROOT = spec.ROOT
TINY = {"traffic": {"num_envs": 4}, "check": {"sample_envs": 2}}
# 8 envs x 4 steps in 4 minibatches of 8, one epoch
PPO_TINY = {"traffic": {"num_envs": 8, "ppo": {"update_epochs": 1, "num_minibatches": 4}}}
# enough envs that some episode ends in the checked rollout (64 x 4 of 50 steps)
PPO_ENDS = {"traffic": {"num_envs": 64, "ppo": {"update_epochs": 1, "num_minibatches": 4}}}


def tiny_run(workload, seed=2**31 + 77, trace=False, seconds=0.5, overrides=TINY):
    return run.run_cell(workload, seed, seconds, trace, device="cpu", overrides=overrides,
                        t_start=time.perf_counter())


@pytest.mark.parametrize("workload", ["pickcube_state_4096", "pickcube_ppo_4096", "cartpole_rgb512_4096"])
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_result_line_is_well_formed(trace, workload):
    ppo = workload == "pickcube_ppo_4096"
    named = workload in {w["name"] for w in spec.benchmark()["workloads"]}
    res, lines = tiny_run(workload, trace=trace, overrides=PPO_TINY if ppo else TINY)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0 and line["correct"] is True
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if not trace:
        assert set(line["metrics"]) == {"train_env_steps_per_s" if ppo else "env_steps_per_s", "setup_s"}
    else:
        assert "breakdown" in line and {"busy_s", "window_s"} <= set(line["device"])
        # device metrics stay silent off the card; the host-clock ones read
        assert not {"physics_device_ms.sim", "device_idle.sim", "device_idle.train"} & set(line["metrics"])
        # a cell that BENCHMARK.json does not name reports no per-layer metric
        assert {"rollout_ms.train", "update_ms.train"} <= set(line["metrics"]) or not (ppo and named)
        assert named or not line["metrics"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, row in line["checks"].items():
        assert row["limit"] is not None and row["value"] <= row["limit"]
    assert lines[-len(line["checks"]):] == [
        f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in line["checks"].items()]


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this sandbox has a card")
    out = subprocess.run([sys.executable, "-m", "simbench.run", "--workload", "pickcube_state_4096",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_cli_fails_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copytree(ROOT / "simbench", tmp_path / "simbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "simbench.run", "--workload", "pickcube_state_4096",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("workload", ["pickcube_state_4096", "cartpole_rgb512_4096", "pickcube_ppo_4096"])
def test_no_jax_after_a_run(workload):
    code = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from simbench import run, spec\n"
        f"res, _ = run.run_cell({workload!r}, 3, 0.2, False, device='cpu', t_start=time.perf_counter(),\n"
        f"    overrides={PPO_TINY if 'ppo' in workload else TINY!r})\n"
        "print(json.dumps([spec.loaded_forbidden(sys.modules), 'maniskill_tpu_torch' in sys.modules]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    forbidden, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert forbidden == [] and port


def test_forbidden_names_are_compared_whole():
    assert spec.loaded_forbidden(["maniskill_tpu_torch", "maniskill_tpu_torch.physics", "jaxtyping"]) == []
    assert spec.loaded_forbidden(["jax.numpy", "maniskill_tpu.envs", "flax"]) == [
        "flax", "jax.numpy", "maniskill_tpu.envs"]


# ---------------------------------------------------------------------------
# the timed path broken underneath: each fault the cells can have
# ---------------------------------------------------------------------------
CAUGHT_BY = {
    ("vector_env", "state_unchanged"): ("pickcube_state_4096", {"state_gap", "obs_gap"}),
    ("vector_env", "half_batch"): ("pickcube_state_4096", {"state_gap", "obs_gap"}),
    ("vector_env", "reward_altered"): ("pickcube_state_4096", {"reward_gap"}),
    ("vector_env", "frame_altered"): ("cartpole_rgb512_4096", {"frame_gap"}),
    ("ppo", "state_unchanged"): ("pickcube_ppo_4096", {"grad_gap", "change_gap"}),
    ("ppo", "half_batch"): ("pickcube_ppo_4096", {"loss_gap", "grad_gap", "change_gap"}),
    ("ppo", "loss_altered"): ("pickcube_ppo_4096", {"loss_gap"}),
    ("ppo", "bootstrap_dropped"): ("pickcube_ppo_4096", {"reward_gap"}),
    ("ppo", "stale_obs"): ("pickcube_ppo_4096", {"obs_gap", "sample_gap"}),
}
# faults that show only where an episode ends in the checked rollout
ON_EPISODE_END = {"bootstrap_dropped", "stale_obs"}


@pytest.mark.parametrize("driver,fault", [(d, f) for d, names in faults.FAULTS.items() for f in names])
def test_a_broken_step_is_not_correct(driver, fault):
    workload, caught = CAUGHT_BY[(driver, fault)]
    if driver == "ppo":
        overrides = PPO_ENDS if fault in ON_EPISODE_END else PPO_TINY
    else:
        overrides = {"traffic": {"num_envs": 2}, "check": {"sample_envs": 2}}
    with faults.planted(driver, fault):
        res, _ = tiny_run(workload, overrides=overrides, seconds=0.2)
    assert res["correct"] is False and res["failed"] > 0
    over = {k for k, v in res["checks"].items() if v["value"] > v["limit"]}
    assert caught <= over, res["checks"]
