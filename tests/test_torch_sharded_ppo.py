"""The port's data-parallel PPO step (``ShardedPPOTrainer``,
``make_sharded_ppo_step`` in maniskill_tpu_torch/parallel/train.py) against
the one-trainer update, on the CPU with two shards on ``[cpu, cpu]``.

- From one trajectory of 8 envs handed over as tensors (the second shard
  takes envs 4-7), the sharded update over two shards of 4 envs equals
  ``PPOTrainer.update`` over all 8: the parameters within 1e-5 and the loss
  within 1e-5, at ``num_minibatches`` 1 and 2 and two epochs; the replicas
  hold the same parameters after it.
- With one shard, ``train_step`` (rollout and update) equals
  ``PPOTrainer.train_step`` exactly.
- ``make_sharded_ppo_step`` with no card and no devices raises;
  ``make_sharded_ppo_step(["cpu", "cpu"], num_envs=8, smoke=True)`` takes a
  step, prints the ``dryrun_multichip ok:`` line and a second step's loss is
  finite (the counterpart of tests/test_multidevice.py's sharded step).
"""
import numpy as np
import pytest
import torch

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make
from maniskill_tpu_torch.parallel import PPOConfig, PPOTrainer, ShardedPPOTrainer, make_sharded_ppo_step
from maniskill_tpu_torch.parallel.train import gaussian_logp

from test_torch_common import one_torch_thread  # noqa: F401

N, T = 8, 2


def _env(n, seed=0):
    env = make("PushCube-v1", num_envs=n, obs_mode="state", device="cpu")
    obs, _ = env.reset(seed=seed)
    return env, obs


@pytest.fixture(scope="module")
def envs():
    return _env(N), _env(N // 2), _env(N // 2, seed=N // 2)


def _trajectory(model, obs_dim, act_dim, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.as_tensor(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    obs, act = f(T, N, obs_dim), f(T, N, act_dim)
    with torch.no_grad():
        mean, log_std, value = model(obs)
        logp = gaussian_logp(act, mean, log_std) + 0.1 * f(T, N)
    done = torch.as_tensor(rng.random((T, N)) < 0.3)
    term = done & torch.as_tensor(rng.random((T, N)) < 0.5)
    return f(N, obs_dim), (obs, act, logp, f(T, N), done, value, term)


def _split(x, lo, hi):
    return x[lo:hi] if x.ndim == 2 and x.shape[0] == N else x[:, lo:hi]


@pytest.mark.parametrize("minibatches", [1, 2])
def test_sharded_update_matches_one_trainer(envs, minibatches):
    (e8, o8), (ea, oa), (eb, ob) = envs
    cfg = PPOConfig(rollout_steps=T, update_epochs=2, num_minibatches=minibatches)
    one = PPOTrainer(e8, cfg, o8, seed=0)
    sharded = ShardedPPOTrainer([ea, eb], cfg, [oa, ob], seed=0)
    for p, q in zip(one.model.parameters(), sharded.model.parameters()):
        assert torch.equal(p, q)
    last, traj = _trajectory(one.model, o8.shape[-1], e8.unwrapped.single_action_space.shape[0])
    want = one.update(last, traj)
    halves = [(0, N // 2), (N // 2, N)]
    got = sharded.update([_split(last, lo, hi) for lo, hi in halves],
                         [tuple(_split(x, lo, hi) for x in traj) for lo, hi in halves])
    gap = max((p - q).abs().max().item() for p, q in zip(one.model.parameters(), sharded.model.parameters()))
    assert gap <= 1e-5, gap
    moved = max((p - q).abs().max().item() for p, q in zip(one.model.parameters(),
                                                           PPOTrainer(e8, cfg, o8, seed=0).model.parameters()))
    assert moved > 1e-4, "the update did not move the parameters"
    for t in sharded.trainers[1:]:
        for p, q in zip(sharded.model.parameters(), t.model.parameters()):
            assert torch.equal(p, q)
    for k in ("loss", "mean_reward", "ep_success", "term_frac", "max_action", "max_adv"):
        np.testing.assert_allclose(got[k].item(), want[k].item(), rtol=0, atol=1e-5, err_msg=k)
    for k in ("bad_params", "bad_rewards", "bad_obs"):
        assert got[k].item() == want[k].item() == 0, k


def test_one_shard_is_a_ppo_trainer_step():
    cfg = PPOConfig(rollout_steps=T, update_epochs=1, num_minibatches=2)
    (ea, oa), (eb, ob) = _env(4), _env(4)
    one = PPOTrainer(ea, cfg, oa, seed=0)
    sharded = ShardedPPOTrainer([eb], cfg, [ob], seed=0)
    el = torch.zeros(4, dtype=torch.int32)
    obs_a, el_a, m_a = one.train_step(oa, el)
    obs_b, el_b, m_b = sharded.train_step([ob], [el])
    assert torch.equal(obs_a, obs_b[0]) and torch.equal(el_a, el_b[0])
    for p, q in zip(one.model.parameters(), sharded.model.parameters()):
        assert torch.equal(p, q)
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k


def test_make_sharded_ppo_step_smoke(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # the card by default, never a silent CPU
        make_sharded_ppo_step(num_envs=8)
    run_once, env = make_sharded_ppo_step(["cpu", "cpu"], num_envs=8, smoke=True)
    assert "dryrun_multichip ok:" in capsys.readouterr().out
    assert isinstance(env, list) and [e.unwrapped.num_envs for e in env] == [4, 4]
    metrics = run_once()
    assert np.isfinite(float(metrics["loss"]))
    for e in env:
        e.close()
