"""The port's counter-based BatchedRNG
(maniskill_tpu_torch/envs/utils/randomization/batched_rng.py), on the CPU.

Its numbers differ from the JAX package's by design (ROADMAP: parity by
state, not by seed), so these tests hold it to its own contract: draws
depend only on each env's seed and the draw count, lie in range, have the
moments of their distributions, and need no host generator. The CPU/CUDA
equality is in tests/test_torch_cuda.py.
"""
import math

import numpy as np
import pytest
import torch

from maniskill_tpu_torch.envs.utils.randomization.batched_rng import BatchedRNG, _hash32, _mul32


def _draws(rng):
    return [rng.uniform(-0.1, 0.1, (2,)), rng.normal(0.0, 0.02, size=(9,)),
            rng.quaternions(lock_x=True, lock_y=True), rng.quaternions(),
            rng.randint(3, 11, size=(5,)), rng.choice(7)]


def test_draws_depend_only_on_each_envs_seed():
    """A batch of 4 and a batch of 8 holding the same seeds (in another
    order) draw the same numbers for each seed, bit for bit."""
    seeds8 = torch.tensor([7, 2**40 + 3, -5, 0, 11, 2**31 - 1, 12345, 99])
    perm = torch.tensor([5, 0, 7, 2])
    a, b = _draws(BatchedRNG.from_seeds(seeds8)), _draws(BatchedRNG.from_seeds(seeds8[perm].tolist()))
    for x, y in zip(a, b):
        assert torch.equal(x[perm], y)
    again = _draws(BatchedRNG.from_seeds(seeds8))
    assert all(torch.equal(x, y) for x, y in zip(a, again))
    assert not torch.equal(a[0][0], a[0][1])  # different seeds, different draws


def test_draws_lie_in_range():
    rng = BatchedRNG.from_seeds(np.arange(1000))
    u = rng.uniform(-0.1, 0.1, (2,))
    assert u.dtype == torch.float32 and u.shape == (1000, 2)
    assert bool((u >= -0.1).all() & (u < 0.1).all())
    r = rng.randint(3, 11, size=(5,))
    assert r.dtype == torch.int32 and int(r.min()) == 3 and int(r.max()) == 10
    assert set(rng.choice(4).tolist()) == {0, 1, 2, 3}
    q = rng.quaternions(lock_x=True, lock_y=True)
    torch.testing.assert_close(q.norm(dim=-1), torch.ones(1000))
    assert not q[:, 1:3].any()  # a pure yaw
    torch.testing.assert_close(rng.quaternions().norm(dim=-1), torch.ones(1000))
    assert bool(torch.isfinite(rng.normal(size=(64,))).all())


def test_moments_of_4096_by_64_draws():
    """Kolmogorov-Smirnov distance against U(0, 1) and N(0, 1) below 0.003
    (its 1% critical value is 1.63 / sqrt(262144) = 0.0032), and the first
    four moments within a few standard errors."""
    rng = BatchedRNG.from_seeds(torch.arange(4096))
    u = np.sort(rng.uniform(size=(64,)).numpy().ravel().astype(np.float64))
    n = u.size
    grid = np.arange(1, n + 1) / n
    assert np.max(np.maximum(grid - u, u - (grid - 1 / n))) < 0.003
    assert abs(u.mean() - 0.5) < 5 * math.sqrt(1 / 12 / n)
    z = np.sort(rng.normal(size=(64,)).numpy().ravel().astype(np.float64))
    cdf = 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))
    assert np.max(np.maximum(grid - cdf, cdf - (grid - 1 / n))) < 0.003
    assert abs(z.mean()) < 5 / math.sqrt(n)
    assert abs(z.var() - 1) < 5 * math.sqrt(2 / n)
    assert abs(np.mean(z**3)) < 5 * math.sqrt(15 / n)
    assert abs(np.mean(z**4) - 3) < 5 * math.sqrt(96 / n)


def test_hash_arithmetic_stays_inside_int64():
    """The 16-bit-piece product equals the exact product mod 2**32 at the
    extremes, and the hash maps [0, 2**32) into itself."""
    xs = [0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF, 0x80000000, 123456789]
    for c in (0x7FEB352D, 0x846CA68B, 0xFFFFFFFF):
        got = _mul32(torch.tensor(xs, dtype=torch.int64), c).tolist()
        assert got == [(x * c) % 2**32 for x in xs]
    h = _hash32(torch.tensor(xs, dtype=torch.int64))
    assert bool((h >= 0).all() & (h < 2**32).all()) and len(set(h.tolist())) == len(xs)


def test_no_host_generator(monkeypatch):
    """Seeding, drawing and an env reset construct no torch.Generator."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make

    env = make("PushCube-v1", num_envs=2, obs_mode="state", device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a torch.Generator was constructed")

    monkeypatch.setattr(torch, "Generator", refuse)
    _draws(BatchedRNG.from_seeds(torch.arange(4)))
    env.reset(seed=3)
    env.reset(options=dict(env_idx=torch.tensor([True, False])))


@pytest.mark.parametrize("seed", [0, 2**31 - 1])
def test_env_reset_is_reproducible(seed):
    """The same seed gives the same episode; another seed another one."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make

    env = make("PushCube-v1", num_envs=3, obs_mode="state", device="cpu")
    a, _ = env.reset(seed=seed)
    b, _ = env.reset(seed=seed)
    c, _ = env.reset(seed=seed + 1)
    assert torch.equal(a, b) and not torch.equal(a, c)
