"""The port's RoboCasaPnPCounterToSink-v1 against the JAX package's, on the
CPU.

The JAX task cannot step as it stands: its reset stores the sink tables on
the env inside the traced reset, and the step's ``evaluate`` reads the
leaked tracer. The test patches the JAX class through pytest's
``MonkeyPatch`` (``patch_jax_robocasa``: numpy sink tables; no JAX file is
edited); the port builds them on the host when the scene loads.

- At 2 envs from the JAX env's state after the reset inside ``make``: 2
  zero-action steps, qpos within 1e-5, obs, reward and info within 1e-4.
- Teleported states (the target object on the counter, above the basin,
  inside it, and inside it but moving): ``evaluate``, the dense and the
  normalized dense reward within 1e-5, and ``in_basin`` and ``success``
  flip as the object enters the basin (``success`` only at rest).
"""
import numpy as np
import pytest

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.scene_builder.robocasa import fixtures as F
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake

from test_torch_common import (  # noqa: F401
    assert_steps_match, f32_solver, one_torch_thread, patch_jax_robocasa, teleport,
)

B = 2
UID = "RoboCasaPnPCounterToSink-v1"
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
        yield je, te, jforward, np.array(je.unwrapped.scene.data.qpos)


def test_pnp_steps_match_reference(envs):
    je, te, _, _ = envs
    jb, tb = je.unwrapped, te.unwrapped
    assert [o.name for o in tb.objects] == [o.name for o in jb.objects] and tb.target_object.name == "can_0"
    np.testing.assert_array_equal(tb._sink_center.numpy(), jb._sink_center)
    np.testing.assert_array_equal(tb._sink_half.numpy(), jb._sink_half)
    assert tb._sink_yaw == jb._sink_yaw
    actions = [np.zeros((B, 13), np.float32)] * 2
    assert_steps_match(je, te, actions, 1e-4, 1e-5, UID)


def test_pnp_teleported_object_flips_in_basin_and_success(envs):
    je, te, jforward, q0 = envs
    jb, tb = je.unwrapped, te.unwrapped
    model = tb.scene.model
    adr = int(model.body_q_adr[tb.target_object.body_id])
    cx, cy = tb._sink_center.numpy()
    cases = [  # (position, in basin)
        (q0[0, adr:adr + 3], False),  # its spawn on a counter
        ((cx, cy, F.COUNTER_H + 0.1), False),  # above the basin
        ((cx, cy, F.COUNTER_H - 0.08), True),
        ((cx + 0.05, cy - 0.1, F.COUNTER_H - 0.09), True),
    ]
    for pos, inside in cases:
        q = q0.copy()
        q[:, adr:adr + 3] = pos
        q[:, adr + 3:adr + 7] = (1, 0, 0, 0)
        (jinfo, jrew, jn), (tinfo, trew, tn) = teleport(jb, tb, jforward, q)
        assert sorted(tinfo) == sorted(jinfo) == ["in_basin", "is_grasped", "success"]
        for k in jinfo:
            np.testing.assert_array_equal(tinfo[k], jinfo[k], err_msg=f"{pos} {k}")
        assert tinfo["in_basin"].tolist() == tinfo["success"].tolist() == [inside] * B, pos
        np.testing.assert_allclose(trew, jrew, rtol=0, atol=TOL, err_msg=str(pos))
        np.testing.assert_allclose(tn, jn, rtol=0, atol=TOL, err_msg=str(pos))
    # inside the basin but moving: in_basin without success
    tb.target_object.set_linear_velocity(np.array([0.3, 0.0, 0.0], np.float32))
    info = tb.evaluate()
    assert info["in_basin"].tolist() == [True] * B and info["success"].tolist() == [False] * B
