"""The port's motion-planning CLI
(maniskill_tpu_torch/examples/motionplanning/run.py) on the CPU: StackCube-v1
at 4 envs, one batch, prints its success line; an env without a scripted
solution is refused. The CLI imports no JAX, so this file needs none."""
import re

import pytest

from maniskill_tpu_torch.examples.motionplanning import run

from test_torch_common import one_torch_thread  # noqa: F401


def test_cli_solves_stack_cube(capsys):
    run.main(["--env-id", "StackCube-v1", "--device", "cpu", "--num-envs", "4", "--seed", "3"])
    out = capsys.readouterr().out
    m = re.search(r"StackCube-v1 batch 0: success ([0-9.]+) \((\d+)/4 cumulative\)", out)
    assert m, out
    assert int(m.group(2)) >= 3, out


def test_cli_refuses_an_env_without_a_solution():
    with pytest.raises(SystemExit, match="no scripted solution"):
        run.main(["--env-id", "PushT-v1", "--device", "cpu", "--num-envs", "1"])
