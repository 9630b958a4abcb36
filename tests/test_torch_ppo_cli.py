"""The port's PPO CLI (maniskill_tpu_torch/examples/baselines/ppo.py) on the
CPU: it evaluates the repo's JAX-trained state checkpoint, and a short
training run saves weights that load back as a flax parameter tree.

The CLI imports no JAX, so this file needs none. It runs on one torch
thread (``one_torch_thread``): the eager CPU step is thousands of small ops,
and with the suite's parallel workers torch's default threads oversubscribe
the cores (on 8 cores with six workers the checkpoint's evaluation took
177.62 s, against 20.76 s alone).
"""
import numpy as np

from maniskill_tpu_torch.examples.baselines import ppo
from maniskill_tpu_torch.parallel import train

from test_torch_common import one_torch_thread  # noqa: F401

STATE_CKPT = "examples_checkpoints/ppo_pickcube_state.pkl"


def test_cli_evaluates_the_state_checkpoint(capsys):
    """Greedy and stochastic evaluation (50 steps, success once) of the
    checkpoint at 4 envs: the trained policy succeeds in most."""
    rate = ppo.main(["--env-id", "PickCube-v1", "--device", "cpu", "--num-envs", "4", "--evaluate", STATE_CKPT])
    out = capsys.readouterr().out
    assert "final eval greedy success_once" in out and "final eval stochastic success_once" in out
    assert rate >= 0.5


def test_cli_trains_and_saves_a_flax_tree(tmp_path):
    """One iteration on PushCube-v1 state; the saved pickle holds the JAX
    package's ActorCritic layout and loads back into the port."""
    path = tmp_path / "ppo_params.pkl"
    ppo.main(["--env-id", "PushCube-v1", "--device", "cpu", "--num-envs", "2", "--rollout-steps", "2",
              "--total-steps", "4", "--update-epochs", "1", "--num-minibatches", "1", "--checkpoint", str(path)])
    tree = train.load_jax_checkpoint(path)
    params = tree["params"]
    assert sorted(params) == ["Dense_0", "Dense_1", "Dense_2", "Dense_3", "Dense_4", "Dense_5", "log_std"]
    assert params["Dense_0"]["kernel"].shape == (44, 256) and params["Dense_3"]["kernel"].shape == (256, 1)
    assert all(np.isfinite(v).all() for layer in params.values() for v in
               (layer.values() if isinstance(layer, dict) else [layer]))
    model = train.ActorCritic(44, 8)
    model.load_state_dict(train.params_from_flax(tree))
