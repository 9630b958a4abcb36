"""The plain reference: it imports nothing of the program, agrees with the
program on the CPU, and on the card the control (the reference one precision
below, TF32 matmuls) fails the comparison where the program passes it."""
import json
import os
import subprocess
import sys

import pytest

from simbench import check, control, spec

ROOT = spec.ROOT


def test_reference_imports_nothing_of_the_program():
    code = (
        f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
        "import simbench.reference.tasks, simbench.check\n"
        "print([m for m in sys.modules if m.split('.')[0] in ('maniskill_tpu_torch', 'maniskill_tpu', 'jax')])\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


SMALL = {"traffic": {"num_envs": 3}, "check": {"sample_envs": 2}}
PPO_SMALL = {"traffic": {"num_envs": 8, "ppo": {"update_epochs": 1, "num_minibatches": 4}}}


@pytest.mark.parametrize("workload", ["pickcube_state_4096", "pickcube_rgb128_2048", "cartpole_rgb512_4096",
                                      "pickcube_ppo_4096"])
def test_reference_agrees_with_the_program_on_the_cpu(workload):
    rows = control.readings(workload, 2**31 + 5, 0.3, device="cpu",
                            overrides=PPO_SMALL if "ppo" in workload else SMALL)
    limits = spec.workload(workload)["check"]["limits"]
    ok, table = check.judge(rows["program"], limits)
    assert ok, table


@pytest.mark.cuda
@pytest.mark.parametrize("workload,n", [("pickcube_state_4096", 256), ("pickcube_rgb128_2048", 128),
                                        ("cartpole_rgb512_4096", 64), ("pickcube_ppo_4096", 512)])
def test_control_fails_where_the_program_passes(card, workload, n):
    traffic = {"num_envs": n}
    rows = control.readings(workload, 17, 1.0, device=card,
                            overrides={"traffic": traffic, "check": {"sample_envs": 4}})
    limits = spec.workload(workload)["check"]["limits"]
    assert check.judge(rows["program"], limits)[0], json.dumps(rows)
    assert not check.judge(rows["control"], limits)[0], json.dumps(rows)
