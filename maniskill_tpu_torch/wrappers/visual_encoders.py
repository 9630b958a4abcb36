"""VisualEncoderWrapper (counterpart of
maniskill_tpu/wrappers/visual_encoders.py): embeds every camera's rgb with a
frozen NatureCNN and returns {embedding, state}.

The network is the JAX package's: flax ``nn.Conv`` layers with their default
SAME padding (32 8x8/4, 64 4x4/2, 64 3x3/1, ReLU), the feature map flattened
in NHWC order, a ReLU dense layer, in float32 on frames scaled by 1/255.
Given ``params`` (a flax tree ``{"params": {"Conv_0": ..., "Dense_0": ...}}``
of numpy arrays, as the JAX wrapper's ``self.params``) the weights are carried
over through ``parallel/train.py:params_from_flax``; without them the
encoder is a frozen random one drawn from a torch generator of seed 0 (it
cannot reproduce ``jax.random.PRNGKey(0)``'s draw).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..parallel.train import _flax_conv_init, _flax_dense_init, params_from_flax
from ..utils import common, gym_utils
from .base import ObservationWrapper

FLAX_NAMES = {"Conv_0": "conv0", "Conv_1": "conv1", "Conv_2": "conv2", "Dense_0": "fc"}


def _same_pad(size: int, k: int, s: int):
    """XLA's SAME padding of one spatial axis: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class NatureCNN(nn.Module):
    CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))  # (channels, kernel, stride)

    def __init__(self, image_shape, out_dim: int = 256, seed: int = 0):
        super().__init__()
        h, w, c = image_shape
        g = torch.Generator().manual_seed(seed)
        self.pads = []
        for i, (ch, k, s) in enumerate(self.CONVS):
            conv = nn.Conv2d(c, ch, k, stride=s)
            _flax_conv_init(conv, g)
            self.add_module(f"conv{i}", conv)
            ph, pw = _same_pad(h, k, s), _same_pad(w, k, s)
            self.pads.append(pw + ph)  # F.pad's order: last axis first
            h, w, c = -(-h // s), -(-w // s), ch
        self.fc = nn.Linear(h * w * c, out_dim)
        _flax_dense_init(self.fc, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C) uint8
        x = (x.to(torch.float32) / 255.0).permute(0, 3, 1, 2)
        for i, pad in enumerate(self.pads):
            x = F.relu(getattr(self, f"conv{i}")(F.pad(x, pad)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return F.relu(self.fc(x))


class VisualEncoderWrapper(ObservationWrapper):
    def __init__(self, env, encoder: str = "frozen_cnn", out_dim: int = 256, params=None):
        super().__init__(env)
        base = env.unwrapped
        assert base.obs_mode not in ("state", "state_dict"), "VisualEncoderWrapper needs a visual obs mode"
        sample = base._init_raw_obs["sensor_data"]
        rgb = next(iter(sample.values()))["rgb"]
        self.model = NatureCNN(tuple(rgb.shape[1:]), out_dim)
        if params is not None:
            self.model.load_state_dict(params_from_flax(params, FLAX_NAMES))
        self.model = self.model.to(base.device).requires_grad_(False)

        emb = self.observation(base._init_raw_obs)
        self.single_observation_space = gym_utils.convert_observation_to_space(emb)
        self.observation_space = gym_utils.batch_space(self.single_observation_space, base.num_envs)

    @torch.no_grad()
    def observation(self, observation):
        obs = dict(observation)
        sensor_data = obs.pop("sensor_data")
        obs.pop("sensor_param", None)
        embeds = [self.model(data["rgb"]) for data in sensor_data.values() if "rgb" in data]
        out = dict(embedding=torch.cat(embeds, -1))
        state = common.flatten_state_dict(obs)
        if state.numel():
            out["state"] = state
        return out
