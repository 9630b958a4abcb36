"""The port's RoboCasaOpenDrawer-v1 against the JAX package's, on the CPU.

The JAX task cannot be made as it stands: its ``_load_scene`` reads
``self.articulated``, which the platform never sets. The test patches the
JAX class through pytest's ``MonkeyPatch`` (``patch_jax_robocasa``: an
``articulated`` alias; no JAX file is edited); the port sets both names.

- At 2 envs from the JAX env's state after the reset inside ``make``: 2
  zero-action steps, qpos within 1e-5, obs, reward and info within 1e-4.
- The reach term of the dense reward reads 0.0 at reset in both packages:
  the Fetch's TCP starts ~2.28 m from the drawer, where 1 - tanh(5 d)
  rounds to 0 in float32.
- Teleported states (the target drawer set to open amounts around
  ``OPEN_MIN``): ``evaluate``, the dense and the normalized dense reward
  within 1e-5, and ``success`` flips at ``OPEN_MIN`` on both sides.
"""
import numpy as np
import pytest
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake

from test_torch_common import (  # noqa: F401
    assert_steps_match, f32_solver, one_torch_thread, patch_jax_robocasa, teleport,
)

B = 2
UID = "RoboCasaOpenDrawer-v1"
TOL = 1e-5


@pytest.fixture(scope="module")
def envs():
    import functools

    import jax
    from maniskill_tpu import physics as jphys

    with pytest.MonkeyPatch.context() as mp, f32_solver():
        patch_jax_robocasa(mp)
        kw = dict(num_envs=B, obs_mode="state")
        je, te = jmake(UID, **kw), tmake(UID, device="cpu", **kw)
        jforward = jax.jit(functools.partial(jphys.forward, je.unwrapped.scene.model))
        yield je, te, jforward, np.array(je.unwrapped.scene.data.qpos)  # the reset's


def test_open_drawer_steps_match_reference(envs):
    je, te, _, _ = envs
    jb, tb = je.unwrapped, te.unwrapped
    assert tb.articulated is tb.articulated_fixtures and not tb.objects
    assert tb.target_joint.name == jb.target_joint.name and tb.drawer_stack.name == jb.drawer_stack.name
    assert tb.reward_mode == "dense"
    actions = [np.zeros((B, 13), np.float32)] * 2
    assert_steps_match(je, te, actions, 1e-4, 1e-5, UID)


def test_open_drawer_reach_term_is_zero_at_reset_and_success_flips(envs):
    je, te, jforward, q0 = envs
    jb, tb = je.unwrapped, te.unwrapped
    (jinfo, jrew, _), (tinfo, trew, _) = teleport(jb, tb, jforward, q0)
    dist = np.linalg.norm(tb.target_link.pose.p.numpy() - tb.agent.tcp.pose.p.numpy(), axis=-1)
    assert (dist > 2.0).all(), dist
    np.testing.assert_array_equal(trew, np.zeros(B, np.float32))
    np.testing.assert_array_equal(jrew, np.zeros(B, np.float32))
    adr = tb.target_joint.q_adr
    assert adr == jb.target_joint.q_adr
    for amount in (0.05, 0.1499, tb.OPEN_MIN, 0.2, 0.35):
        q = q0.copy()
        q[:, adr] = amount
        (jinfo, jrew, jn), (tinfo, trew, tn) = teleport(jb, tb, jforward, q)
        assert sorted(tinfo) == sorted(jinfo) == ["open_amount", "success"]
        np.testing.assert_array_equal(tinfo["success"], jinfo["success"])
        assert tinfo["success"].tolist() == [amount >= tb.OPEN_MIN] * B
        np.testing.assert_allclose(tinfo["open_amount"], jinfo["open_amount"], rtol=0, atol=TOL)
        np.testing.assert_allclose(trew, jrew, rtol=0, atol=TOL, err_msg=str(amount))
        np.testing.assert_allclose(tn, jn, rtol=0, atol=TOL, err_msg=str(amount))
        np.testing.assert_allclose(tn, trew / 7.0, rtol=1e-6)
