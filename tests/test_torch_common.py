"""Helpers shared by the port's parity tests (the other tests/test_torch_*.py
files import them), and a check of the f32 solver switch they rely on.

- ``tree(x, fn)`` maps ``fn`` over the leaves of a nested dict (a state dict
  handed from one package to the other).
- ``f32_solver()`` makes the JAX solver's bf16 cast an identity. The
  reference solver casts J and W to bf16 for the TPU's matrix unit
  (maniskill_tpu/physics/solver.py:293-306); the port keeps them f32. For
  parity the reference runs with that cast made an identity, so both sides
  compute the same f32 algorithm (with the cast, contact rows differ by
  ~5e-3 in qvel: bf16's 8-bit mantissa). It must be entered before the JAX
  env compiles its step. ``f32_reference_solver`` is the module-scoped
  fixture of it.
- ``one_torch_thread`` (autouse) runs the module that imports it on one
  torch thread: the port's eager CPU step is thousands of small ops, and
  with parallel test workers and torch's default thread count they
  oversubscribe the cores (4-20x slower).

JAX is imported where it is used, so that a file that needs only the
thread fixture needs no JAX.
"""
import contextlib
import types

import numpy as np
import pytest
import torch


def tree(x, fn):
    return {k: tree(v, fn) for k, v in x.items()} if isinstance(x, dict) else fn(x)


@contextlib.contextmanager
def f32_solver():
    import jax.numpy as jnp
    from maniskill_tpu.physics import solver as jsolver

    proxy = types.ModuleType("jnp_f32_solver")
    proxy.__dict__.update(jnp.__dict__)
    proxy.bfloat16 = jnp.float32
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsolver, "jnp", proxy)
        yield


@pytest.fixture(scope="module")
def f32_reference_solver():
    with f32_solver():
        yield


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_f32_solver_makes_the_bf16_cast_an_identity():
    """Inside ``f32_solver`` the solver module's ``jnp.bfloat16`` casts keep
    every f32 bit and the rest of ``jnp`` is untouched; on leaving it the
    bf16 cast rounds again."""
    import jax
    import jax.numpy as jnp
    from maniskill_tpu.physics import solver as jsolver

    x = jnp.asarray(np.random.default_rng(0).normal(size=64).astype(np.float32))
    cast = jax.jit(lambda v: v.astype(jsolver.jnp.bfloat16).astype(jnp.float32))
    rounded = np.asarray(cast(x))
    assert np.abs(rounded - np.asarray(x)).max() > 0
    with f32_solver():
        assert jsolver.jnp is not jnp and jsolver.jnp.matmul is jnp.matmul
        exact = jax.jit(lambda v: v.astype(jsolver.jnp.bfloat16).astype(jnp.float32))(x)
        np.testing.assert_array_equal(np.asarray(exact), np.asarray(x))
    assert jsolver.jnp is jnp
    np.testing.assert_array_equal(np.asarray(cast(x)), rounded)
