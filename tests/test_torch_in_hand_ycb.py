"""The port's RotateSingleObjectInHandLevel3-v1 against the JAX package's,
at 4 envs on the CPU: a different YCB stand-in in each env, cooked to 4
hulls by the native cooking library and scaled so its longest edge is
7 cm, through ``set_per_env_hulls``.

Both packages draw the 4 models from ``RandomState(2024)`` at the first
build (the power drill, the marker and the master chef can twice), so the
models are equal: the per-env hull vertices and facet directions included.
One JAX env (its solver's bf16 cast made an identity) takes one zero-action
step from its state after the reset inside ``make`` and 2 seeded random
steps; the port's env starts from that state with its extras and takes the
same actions. All 3 steps are held: obs, reward and the three extras
within 1e-4, success and terminated equal, ``contact.overflow == 0``. The
objects land on the palm in the 4th step, where the padded hull proxies'
tied vertex depths let round-off pick other contact points (ROADMAP §3,
"the cylinder YCB stand-ins rock"): the drill and the cans part by up to
5e-3 in qpos there while the marker stays within 1e-7, so no step after
the landing is held.
"""
import numpy as np
import torch

import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake

from test_torch_common import (  # noqa: F401
    assert_models_equal, assert_tree_close, f32_reference_solver, jax_cooking, one_torch_thread, tree,
)

B = 4
STEPS = 3
UID = "RotateSingleObjectInHandLevel3-v1"
KW = dict(num_envs=B, obs_mode="state_dict", control_mode="pd_joint_delta_pos")
EXTRAS = ("rot_dir", "prev_unit_vector", "cum_rotation_angle")


def test_level3_matches_reference(f32_reference_solver, jax_cooking):
    je = jmake(UID, **KW)
    jb = je.unwrapped
    te = tmake(UID, device="cpu", **KW)
    tb = te.unwrapped
    assert list(tb.model_ids) == list(jb.model_ids)
    assert len(set(tb.model_ids)) == 3
    assert_models_equal(tb.scene.model, jb.scene.model)
    assert tb.scene.model.hull_verts.shape[0] == B
    np.testing.assert_array_equal(tb._obj_heights.numpy(), np.asarray(jb._obj_heights))

    extras = {k: np.array(jb.scene.data.extras[k]) for k in EXTRAS}
    state = dict(tree(jb.get_state_dict(), np.array), extras=extras)
    obs0, _ = te.reset(seed=3, options=dict(reset_to_env_states=tree(state, torch.as_tensor)))
    assert_tree_close(obs0, tree(jb._init_raw_obs, np.asarray), 1e-6, "reset")
    rng = np.random.default_rng(7)
    for i in range(STEPS):
        action = rng.uniform(-1, 1, (B, 16)).astype(np.float32) * (i > 0)
        jobs, jrew, jterm, _, jinfo = je.step(action)
        obs, reward, terminated, _, info = te.step(torch.as_tensor(action))
        what = f"step {i + 1}"
        assert_tree_close(obs, tree(jobs, np.asarray), 1e-4, what)
        np.testing.assert_allclose(reward.numpy(), np.asarray(jrew), rtol=0, atol=1e-4, err_msg=what)
        np.testing.assert_array_equal(terminated.numpy(), np.asarray(jterm), err_msg=what)
        np.testing.assert_array_equal(info["success"].numpy(), np.asarray(jinfo["success"]), err_msg=what)
        for k in EXTRAS:
            np.testing.assert_allclose(tb.scene.data.extras[k].numpy(), np.asarray(jb.scene.data.extras[k]),
                                       rtol=0, atol=1e-4, err_msg=f"{what} {k}")
        assert tb.scene.data.contact.overflow.tolist() == [0] * B
        assert np.asarray(jb.scene.data.contact.overflow).tolist() == [0] * B
    # the objects fell and the hand moved
    assert (tb.obj.pose.p[:, 2] < tb._obj_heights + 0.25 + 0.03).all()
    assert np.abs(np.asarray(jb.scene.data.qvel)).max() > 0.1
