"""Visual PPO's depth leg in the port (maniskill_tpu_torch/parallel/train.py:
``make_obs_transform``, ``NatureCNN``'s depth and rgbd towers) against the
JAX package's (maniskill_tpu/parallel/train.py), on the CPU.

- The obs transform on PushCube-v1 rgbd at 2 envs, from one state: the
  JAX package's keys, shapes and dtypes; the int16 depth (mm) within 1 mm
  of the JAX package's on every pixel and equal on >= 0.999 of them (the
  two renderers round z x 1000 apart on a few edge pixels: 3 of 32,768 in
  this state), and nonzero where the table is in view.
- ``VisualActorCritic`` over rgb + depth + state, and over an rgbd key +
  state, its params carried from a flax init: mean and value within 1e-4
  relative to the largest magnitude (bf16 convolutions rounded at other
  places by XLA's CPU convolution and torch's, the bound of the rgb
  checkpoint's test), the log std equal; ``build_model`` sizes the same
  towers from the obs.
- The params round-trip exactly.
- One PPO iteration on the rgbd env updates the depth tower, whose weights
  carry to the JAX package's layout.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import maniskill_tpu.envs  # noqa: F401
from maniskill_tpu.parallel import train as jtrain
from maniskill_tpu.utils.registration import make as jmake

import maniskill_tpu_torch.envs  # noqa: F401
from maniskill_tpu_torch import make as tmake
from maniskill_tpu_torch.parallel import train as ttrain

from test_torch_common import assert_trees_equal, close_rel, one_torch_thread, tree  # noqa: F401

B = 2
DEPTH_AGREE_MIN = 0.999
RTOL = 1e-4  # relative to the largest magnitude, as the rgb checkpoint's test


@pytest.fixture(scope="module")
def rgbd_obs():
    """(JAX transformed obs, port transformed obs, port env) of PushCube-v1
    rgbd from the JAX env's reset state."""
    je = jmake("PushCube-v1", num_envs=B, obs_mode="rgbd")
    jraw, _ = je.reset(seed=3)
    te = tmake("PushCube-v1", num_envs=B, obs_mode="rgbd", device="cpu")
    state = tree(je.unwrapped.get_state_dict(), lambda v: torch.as_tensor(np.array(v)))
    traw, _ = te.reset(seed=3, options=dict(reset_to_env_states=state))
    jobs = jtrain.make_obs_transform(je.unwrapped)(jraw)
    tobs = ttrain.make_obs_transform(te.unwrapped)(traw)
    return jobs, tobs, te


def test_obs_transform_holds_the_depth(rgbd_obs):
    jobs, tobs, _ = rgbd_obs
    assert sorted(tobs) == sorted(jobs) == ["depth", "rgb", "state"]
    for k in jobs:
        assert tuple(tobs[k].shape) == jobs[k].shape, k
        assert str(tobs[k].dtype).split(".")[-1] == str(jobs[k].dtype), k
    assert tobs["depth"].shape == (B, 128, 128, 1) and tobs["depth"].dtype == torch.int16
    jd, td = np.asarray(jobs["depth"]).astype(np.int32), tobs["depth"].numpy().astype(np.int32)
    assert np.abs(jd - td).max() <= 1
    agree = (jd == td).mean()
    assert agree >= DEPTH_AGREE_MIN, agree
    # the table fills the lower half of the base camera's view
    assert (td[:, 64:] > 0).all()


def _flax_init(key_shapes, seed):
    rng = np.random.default_rng(seed)
    obs = {}
    for k, shape in key_shapes.items():
        if k == "state":
            obs[k] = rng.normal(size=(4,) + shape).astype(np.float32)
        elif k == "depth":
            obs[k] = rng.integers(0, 3000, (4,) + shape, dtype=np.int16)
        else:
            obs[k] = rng.integers(0, 256, (4,) + shape, dtype=np.uint8)
    params = jtrain.VisualActorCritic(8).init(jax.random.PRNGKey(seed), {k: jnp.asarray(v) for k, v in obs.items()})
    return jax.device_get(params), obs


CASES = {
    "rgb+depth": dict(rgb=(64, 64, 3), depth=(64, 64, 1), state=(34,)),
    "rgbd": dict(rgbd=(64, 64, 4), state=(34,)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_visual_actor_critic_matches_reference(case):
    params, obs = _flax_init(CASES[case], 7)
    tobs = {k: torch.as_tensor(v) for k, v in obs.items()}
    model = ttrain.VisualActorCritic.for_obs(tobs, 8)
    model.load_state_dict(ttrain.params_from_flax(params))
    jm, jls, jv = jtrain.VisualActorCritic(8).apply(params, {k: jnp.asarray(v) for k, v in obs.items()})
    with torch.no_grad():
        tm, tls, tv = model(tobs)
    close_rel(jm, tm.numpy(), RTOL, "mean")
    np.testing.assert_array_equal(tls.numpy(), np.asarray(jls))
    close_rel(jv, tv.numpy(), RTOL, "value")


@pytest.mark.parametrize("case", sorted(CASES))
def test_params_round_trip_exactly(case):
    params, _ = _flax_init(CASES[case], 8)
    assert_trees_equal(params, ttrain.params_to_flax(ttrain.params_from_flax(params)))


def test_build_model_sizes_the_depth_tower(rgbd_obs):
    _, tobs, te = rgbd_obs
    model = ttrain.build_model(te.unwrapped, tobs)
    assert model.feature_net.image_keys == ("rgb", "depth")
    assert model.feature_net.depth_conv8.in_channels == 1 and model.feature_net.out_features == 256 * 3
    with torch.no_grad():
        feats = model.feature_net(dict(tobs, rgb=torch.zeros_like(tobs["rgb"])))
    # with the rgb blanked the depth tower still moves the features
    with torch.no_grad():
        blank = model.feature_net(dict(tobs, rgb=torch.zeros_like(tobs["rgb"]), depth=torch.zeros_like(tobs["depth"])))
    assert torch.isfinite(feats).all() and not torch.equal(feats[:, 256:512], blank[:, 256:512])


def test_rgbd_train_step(rgbd_obs):
    """One whole PPO iteration (rollout 2) on the rgbd env: the trainer's
    policy reads the depth, and its checkpoint holds the depth tower in the
    JAX package's layout."""
    _, _, te = rgbd_obs
    raw, _ = te.reset(seed=0)
    trainer = ttrain.PPOTrainer(te, ttrain.PPOConfig(rollout_steps=2, update_epochs=1, num_minibatches=1), raw)
    obs = trainer.obs_tf(raw)
    before = trainer.model.feature_net.depth_conv8.weight.detach().clone()
    obs, _, metrics = trainer.train_step(obs, torch.zeros(B, dtype=torch.int32))
    assert np.isfinite(float(metrics["loss"]))
    for k in ("bad_params", "bad_obs", "bad_rewards"):
        assert int(metrics[k]) == 0, k
    assert not torch.equal(before, trainer.model.feature_net.depth_conv8.weight)
    params = ttrain.params_to_flax(trainer.model.state_dict())["params"]["feature_net"]
    assert sorted(params) == ["depth_conv3", "depth_conv4", "depth_conv8", "depth_fc", "rgb_conv3", "rgb_conv4",
                              "rgb_conv8", "rgb_fc", "state_fc"]
    assert params["depth_conv8"]["kernel"].shape == (8, 8, 1, 32)
