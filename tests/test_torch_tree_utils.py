"""The port's tree helpers and small public names against the JAX package's,
on the same numpy inputs (bit-equal): ``utils/tree.py``'s ``replace`` and
``map_structure``, ``utils/common.py``'s ``tree_replace_masked`` (over nested
dicts and tuples, and over a physics ``Data``), ``agents/controllers``'
``deepcopy_dict`` and ``utils/registration.py``'s ``register``; and the
package logger, whose handler prints the modules' own loggers.
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maniskill_tpu.agents.controllers import deepcopy_dict as jdeepcopy
from maniskill_tpu.utils import common as jcommon
from maniskill_tpu.utils import registration as jreg
from maniskill_tpu.utils import tree as jtree

from maniskill_tpu_torch.agents.controllers import deepcopy_dict as tdeepcopy
from maniskill_tpu_torch.utils import common as tcommon
from maniskill_tpu_torch.utils import registration as treg
from maniskill_tpu_torch.utils import tree as ttree

B = 5


def _nested(rng):
    return {
        "a": rng.normal(size=(B, 3)).astype(np.float32),
        "b": {"c": rng.integers(0, 9, (B,)).astype(np.int32), "d": rng.normal(size=(B, 2, 4)).astype(np.float32)},
        "e": (rng.random((B,)) > 0.5),
    }


def _to(x, fn):
    if isinstance(x, dict):
        return {k: _to(v, fn) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_to(v, fn) for v in x)
    return fn(x)


def _assert_equal(t, j):
    if isinstance(j, dict):
        assert list(t) == list(j)
        for k in j:
            _assert_equal(t[k], j[k])
    elif isinstance(j, tuple):
        assert type(t) is tuple and len(t) == len(j)
        for a, b in zip(t, j):
            _assert_equal(a, b)
    else:
        assert t.dtype == torch.from_numpy(np.array(j)).dtype
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_replace_and_map_structure_match_reference(seed):
    rng = np.random.default_rng(seed)
    old, new = _nested(rng), _nested(rng)
    mask = rng.random(B) > 0.5
    want = jtree.replace(_to(old, jnp.asarray), _to(new, jnp.asarray), jnp.asarray(mask))
    got = ttree.replace(_to(old, torch.as_tensor), _to(new, torch.as_tensor), torch.as_tensor(mask))
    _assert_equal(got, want)
    # a host (numpy) mask too
    _assert_equal(ttree.replace(_to(old, torch.as_tensor), _to(new, torch.as_tensor), mask), want)
    _assert_equal(ttree.map_structure(lambda x: x[1:3], _to(old, torch.as_tensor)),
                  jtree.map_structure(lambda x: x[1:3], _to(old, jnp.asarray)))


@pytest.mark.parametrize("seed", [0, 1])
def test_tree_replace_masked_matches_reference(seed):
    rng = np.random.default_rng(seed)
    old = (_nested(rng), rng.normal(size=(B, 7)).astype(np.float32))
    new = (_nested(rng), rng.normal(size=(B, 7)).astype(np.float32))
    mask = rng.random(B) > 0.5
    want = jcommon.tree_replace_masked(_to(old, jnp.asarray), _to(new, jnp.asarray), jnp.asarray(mask))
    got = tcommon.tree_replace_masked(_to(old, torch.as_tensor), _to(new, torch.as_tensor), torch.as_tensor(mask))
    _assert_equal(got, want)


def test_tree_replace_masked_over_data():
    """Over the port's ``Data`` dataclass: every tensor field merged per env,
    the rest taken from ``new``, no field of ``old`` changed."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make

    env = make("PushCube-v1", num_envs=4, obs_mode="state", device="cpu")
    scene = env.unwrapped.scene
    old = scene.data
    env.step(torch.ones(4, 8))
    new = scene.data
    mask = torch.tensor([True, False, True, False])
    out = tcommon.tree_replace_masked(old, new, mask)
    assert type(out) is type(new)
    for name in ("qpos", "qvel", "drive_target"):
        o, n, m = getattr(old, name), getattr(new, name), getattr(out, name)
        assert not torch.equal(o, n), name
        assert torch.equal(m[mask], n[mask]) and torch.equal(m[~mask], o[~mask]), name
    assert torch.equal(out.contact.pos[~mask], old.contact.pos[~mask])
    env.close()


def test_deepcopy_dict_and_register_match_reference():
    d = {"a": [1, {"b": np.arange(3)}], "c": {"d": "e"}}
    jd, td = jdeepcopy(d), tdeepcopy(d)
    for out in (jd, td):
        assert out is not d and out["a"] is not d["a"] and out["a"][1]["b"] is not d["a"][1]["b"]
        assert out["c"] == {"d": "e"} and out["a"][0] == 1
        np.testing.assert_array_equal(out["a"][1]["b"], d["a"][1]["b"])

    class Env:
        def __init__(self, **kw):
            self.kw = kw

    name = "TreeUtilsRegisterTest-v0"
    try:
        for reg in (jreg, treg):
            spec = reg.register(name, Env, max_episode_steps=7, default_kwargs=dict(x=1))
            assert (spec.uid, spec.cls, spec.max_episode_steps, spec.default_kwargs) == (name, Env, 7, dict(x=1))
            # a second register keeps the first spec
            assert reg.register(name, object) is spec
            assert reg.REGISTERED_ENVS[name] is spec
            assert spec.make(y=2).kw == dict(x=1, y=2)
        env = treg.make(name)
        assert env.max_episode_steps == 7 and env.env.kw == dict(x=1)
    finally:
        jreg.REGISTERED_ENVS.pop(name, None)
        treg.REGISTERED_ENVS.pop(name, None)


def test_package_logger_serves_the_module_loggers(capsys):
    from maniskill_tpu_torch.building import urdf_loader
    from maniskill_tpu_torch.utils.logging_utils import logger

    assert logger.name == "maniskill_tpu_torch" and len(logger.handlers) == 1
    assert urdf_loader.logger.parent is logger or urdf_loader.logger.name.startswith("maniskill_tpu_torch.")
    handler = logger.handlers[0]
    records = []
    handler.emit = records.append
    try:
        urdf_loader.logger.warning("a loader warning")
    finally:
        del handler.emit
    assert [r.getMessage() for r in records] == ["a loader warning"]
    assert records[0].levelno == logging.WARNING
