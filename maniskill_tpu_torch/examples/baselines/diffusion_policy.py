"""Diffusion Policy baseline CLI (counterpart of
maniskill_tpu/examples/baselines/diffusion_policy.py, after Chi et al. 2023).

A conditional DDPM over action chunks: given an observation-history window,
the model denoises a horizon of future actions; at eval the first
``--act-steps`` denoised actions execute before re-planning. The denoiser is
the JAX package's ``ConditionalUnet1D`` (Conv1D residual blocks with FiLM
conditioning on the observation and a sinusoidal timestep embedding, a
down/up path with skips), or with ``--denoiser mlp`` its four-layer MLP.
Demos recorded with uint8 frames train a NatureCNN frame encoder end to end
through the diffusion loss.

The layers are the flax ones carried to torch: convolutions channels-first
with flax's SAME padding, GroupNorm eps 1e-6, the tanh gelu, Mish, and the
up-sampling ``ConvTranspose`` whose kernel flax does not flip
(``params_from_flax`` flips it into torch's ``ConvTranspose1d``). Every draw
(the epoch's permutation, the timesteps and noise, the sampler's x_T and
per-step noise) is a tensor from one ``torch.Generator`` on the device, and
``epoch_step``/``sample_chunk`` also take them as arguments. An epoch reads
nothing back from the device. Runs on the card unless ``--device cpu`` is
given.

Usage:
    python -m maniskill_tpu_torch.examples.baselines.diffusion_policy \\
        --traj-path out/demos.h5 --env-id PickCube-v1 --epochs 200 [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ...parallel.train import _lecun_normal_
from ...wrappers.visual_encoders import NatureCNN, _same_pad

EVAL_STEPS = 50  # the reference CLI's evaluation horizon
TIME_EMB_HALF = 64


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--traj-path", required=True)
    p.add_argument("--env-id", default=None, help="evaluate after training")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--horizon", type=int, default=8, help="action chunk length")
    p.add_argument("--obs-window", type=int, default=2)
    p.add_argument("--act-steps", type=int, default=4, help="actions executed per plan")
    p.add_argument("--diffusion-steps", type=int, default=50)
    p.add_argument("--eval-episodes", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--denoiser", choices=["unet", "mlp"], default="unet")
    p.add_argument("--unet-dims", type=int, nargs="+", default=[64, 128, 256])
    p.add_argument("--obs-mode", default="state",
                   help="obs mode for the eval env; use the mode the demos were recorded with (e.g. rgb)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


# ----------------------------------------------------------------------------
# dataset
# ----------------------------------------------------------------------------
def _is_image(a, batch_dims):
    a = np.asarray(a)
    return a.ndim == batch_dims + 3 and a.dtype == np.uint8


def _split_obs(o, batch_dims):
    """Separate an obs tree into (flat state vector, list of image arrays)."""
    if isinstance(o, dict):
        vec_parts, imgs = [], []
        for _, v in sorted(o.items()):
            vec, im = _split_obs(v, batch_dims)
            if vec is not None:
                vec_parts.append(vec)
            imgs.extend(im)
        vec = np.concatenate(vec_parts, axis=-1) if vec_parts else None
        return vec, imgs
    if _is_image(o, batch_dims):
        return None, [np.asarray(o)]
    o = np.asarray(o, np.float32)
    return o.reshape(o.shape[:batch_dims] + (-1,)), []


def _windows(obs, acts, W, H, img=None):
    """obs (T+1, D), acts (T, A), img (T+1, h, w, c) -> per-step windows:
    (N, W*D), chunks (N, H, A), image windows (N, W, h, w, c)."""
    T = len(acts)
    OBS, CH, IM = [], [], []
    for t in range(T):
        idxs = [max(0, t - i) for i in range(W - 1, -1, -1)]
        OBS.append(np.concatenate([obs[i] for i in idxs], -1))
        CH.append(np.stack([acts[min(t + i, T - 1)] for i in range(H)]))
        if img is not None:
            IM.append(np.stack([img[i] for i in idxs]))
    return np.stack(OBS), np.stack(CH), np.stack(IM) if img is not None else None


def load_dataset(traj_path: str, horizon: int, obs_window: int):
    """The JAX CLI's training set: (X (N, W*D) f32, Y (N, H, A) f32 scaled
    to [-1, 1] by the dataset's per-dim action range, XI (N, W, h, w, c)
    uint8 or None, a_min, a_scale)."""
    from maniskill_tpu_torch.trajectory.dataset import ManiSkillTrajectoryDataset

    ds = ManiSkillTrajectoryDataset(traj_path)
    H, W = horizon, obs_window
    OBS, CHUNK, IMGS = [], [], []
    for ep in range(len(ds.actions)):
        acts = np.asarray(ds.actions[ep], np.float32)
        batched = acts.ndim == 3
        bd = 2 if batched else 1
        vec, imgs = _split_obs(ds.obs[ep], bd)
        img = np.concatenate(imgs, axis=-1) if imgs else None  # cameras -> channels
        if vec is None:
            vec = np.zeros(acts.shape[:bd] + (0,), np.float32)
        if batched:  # (T, B, ...): one episode per env column
            for b in range(acts.shape[1]):
                o_, c_, i_ = _windows(vec[:, b], acts[:, b], W, H, img[:, b] if img is not None else None)
                OBS.append(o_), CHUNK.append(c_), IMGS.append(i_)
        else:
            o_, c_, i_ = _windows(vec, acts, W, H, img)
            OBS.append(o_), CHUNK.append(c_), IMGS.append(i_)
    ds.close()
    X = np.concatenate(OBS, 0)
    Y = np.concatenate(CHUNK, 0)
    # [-1, 1] by the dataset's range (the reference's LinearNormalizer)
    a_min = Y.min(axis=(0, 1))
    a_max = Y.max(axis=(0, 1))
    a_scale = np.maximum(a_max - a_min, 1e-4)
    Y = 2.0 * (Y - a_min) / a_scale - 1.0
    XI = np.concatenate(IMGS, 0) if IMGS and IMGS[0] is not None else None
    return X, Y, XI, a_min, a_scale


def ddpm_schedule(steps: int):
    """(betas, alphas, alpha_bar) as float32 numpy, linear betas in
    [1e-4, 0.02]."""
    betas = np.linspace(1e-4, 0.02, steps, dtype=np.float32)
    alphas = 1.0 - betas
    return betas, alphas, np.cumprod(alphas)


# ----------------------------------------------------------------------------
# the denoiser
# ----------------------------------------------------------------------------
def _init_(layer: nn.Module, fan_in: int, generator: torch.Generator):
    """flax's defaults: a lecun_normal kernel, zero bias."""
    with torch.no_grad():
        _lecun_normal_(layer.weight, fan_in, generator)
        layer.bias.zero_()


def _dense(i: int, o: int, g: torch.Generator) -> nn.Linear:
    layer = nn.Linear(i, o)
    _init_(layer, i, g)
    return layer


def _conv1d(i: int, o: int, k: int, g: torch.Generator, stride: int = 1, padding: int = 0) -> nn.Conv1d:
    layer = nn.Conv1d(i, o, k, stride=stride, padding=padding)
    _init_(layer, i * k, g)
    return layer


class ResBlock1D(nn.Module):
    """Conv1D residual block with FiLM conditioning (the reference's
    ConditionalResidualBlock1D); x is (B, C, T)."""

    def __init__(self, in_ch: int, ch: int, cond_dim: int, g: torch.Generator):
        super().__init__()
        self.conv0 = _conv1d(in_ch, ch, 5, g, padding=2)  # SAME for k 5, stride 1
        self.norm0 = nn.GroupNorm(8, ch, eps=1e-6)
        self.film = _dense(cond_dim, 2 * ch, g)
        self.conv1 = _conv1d(ch, ch, 5, g, padding=2)
        self.norm1 = nn.GroupNorm(8, ch, eps=1e-6)
        self.res = _conv1d(in_ch, ch, 1, g) if in_ch != ch else None

    def forward(self, x, cond):
        h = F.mish(self.norm0(self.conv0(x)))
        scale, shift = self.film(F.mish(cond)).unsqueeze(-1).chunk(2, dim=1)
        h = h * (1 + scale) + shift
        h = F.mish(self.norm1(self.conv1(h)))
        return h + (self.res(x) if self.res is not None else x)


class ConditionalUnet1D(nn.Module):
    """Down path of two blocks and a stride-2 conv per level, two middle
    blocks, up path of a stride-2 transposed conv cropped to the skip, the
    skip concatenated, two blocks; x is (B, A, T)."""

    def __init__(self, act_dim: int, dims: Sequence[int], cond_dim: int, g: torch.Generator):
        super().__init__()
        ch = act_dim
        self.downs = nn.ModuleList()
        for d in dims[:-1]:
            self.downs.append(nn.ModuleList([ResBlock1D(ch, d, cond_dim, g), ResBlock1D(d, d, cond_dim, g),
                                             _conv1d(d, d, 3, g, stride=2)]))
            ch = d
        self.mid = nn.ModuleList([ResBlock1D(ch, dims[-1], cond_dim, g), ResBlock1D(dims[-1], dims[-1], cond_dim, g)])
        ch = dims[-1]
        self.ups = nn.ModuleList()
        for d in reversed(dims[:-1]):
            up = nn.ConvTranspose1d(ch, d, 4, stride=2, padding=1)  # length 2L, as flax's SAME
            _init_(up, ch * 4, g)
            self.ups.append(nn.ModuleList([up, ResBlock1D(2 * d, d, cond_dim, g), ResBlock1D(d, d, cond_dim, g)]))
            ch = d
        self.final = _conv1d(ch, act_dim, 5, g, padding=2)

    def forward(self, x, cond):
        skips = []
        for block0, block1, down in self.downs:
            x = block1(block0(x, cond), cond)
            skips.append(x)
            x = down(F.pad(x, _same_pad(x.shape[-1], 3, 2)))
        for block in self.mid:
            x = block(x, cond)
        for (up, block0, block1), skip in zip(self.ups, reversed(skips)):
            x = up(x)[..., :skip.shape[-1]]
            x = block1(block0(torch.cat([x, skip], 1), cond), cond)
        return self.final(x)


class Denoiser(nn.Module):
    """eps(noisy chunk (B, H, A), obs (B, W*D), frames (B, W, h, w, c) uint8
    or None, t (B,) float) -> (B, H, A)."""

    def __init__(self, kind: str, horizon: int, act_dim: int, obs_dim: int, image_shape=None, obs_window: int = 2,
                 hidden: int = 512, unet_dims: Sequence[int] = (64, 128, 256), seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.kind, self.horizon, self.act_dim = kind, horizon, act_dim
        self.time_in = _dense(2 * TIME_EMB_HALF, 128, g)
        self.time_out = _dense(128, 128, g)
        cond_dim = obs_dim + 128
        self.frames = None
        if image_shape is not None:
            self.frames = NatureCNN(image_shape, 256, seed=seed + 1)
            cond_dim += obs_window * 256
        if kind == "mlp":
            dims = [horizon * act_dim + cond_dim] + [hidden] * 4
            self.mlp = nn.ModuleList([_dense(i, o, g) for i, o in zip(dims[:-1], dims[1:])])
            self.head = _dense(hidden, horizon * act_dim, g)
        else:
            self.unet = ConditionalUnet1D(act_dim, tuple(unet_dims), cond_dim, g)
        freqs = torch.exp(-math.log(1e4) * torch.arange(TIME_EMB_HALF, dtype=torch.float32) / TIME_EMB_HALF)
        self.register_buffer("freqs", freqs, persistent=False)

    def forward(self, noisy, obs, imgs, t):
        emb = t[:, None] * self.freqs[None]
        temb = self.time_out(F.mish(self.time_in(torch.cat([torch.sin(emb), torch.cos(emb)], -1))))
        feats = [obs, temb]
        if imgs is not None:
            B, Wn = imgs.shape[:2]
            feats.insert(0, self.frames(imgs.reshape((B * Wn,) + imgs.shape[2:])).reshape(B, -1))
        cond = torch.cat(feats, -1)
        if self.kind == "mlp":
            x = torch.cat([noisy.reshape(noisy.shape[0], -1), cond], -1)
            for layer in self.mlp:
                x = F.gelu(layer(x), approximate="tanh")
            return self.head(x).reshape(-1, self.horizon, self.act_dim)
        return self.unet(noisy.transpose(1, 2), cond).transpose(1, 2)


# ----------------------------------------------------------------------------
# weights carried from and to the JAX package's flax trees. flax names a
# compact module's children per type in construction order, and in
# ``nn.Dense(128)(mish(nn.Dense(128)(temb)))`` the outer layer is built first
# ----------------------------------------------------------------------------
def _to_torch(kind, leaf: str, v: np.ndarray) -> np.ndarray:
    name = kind if isinstance(kind, str) else kind[0]
    if name == "heads_in":  # DenseGeneral (D, heads, hd) -> (heads * hd, D); bias (heads, hd)
        return v.reshape(v.shape[0], -1).T if leaf == "kernel" else v.reshape(-1)
    if leaf != "kernel":  # biases and norm scales
        return v
    if name == "dense":
        return v.T
    if name == "heads_out":  # DenseGeneral (heads, hd, D) -> (D, heads * hd)
        return v.reshape(-1, v.shape[-1]).T
    if name == "conv":  # (k, in, out) -> (out, in, k); HWIO -> OIHW
        return v.transpose((2, 1, 0) if v.ndim == 3 else (3, 2, 0, 1))
    if name == "conv_t":  # flax applies its (k, in, out) kernel unflipped; torch flips
        return v.transpose(1, 2, 0)[:, :, ::-1]
    raise ValueError(kind)


def _to_flax(kind, leaf: str, v: np.ndarray) -> np.ndarray:
    name = kind if isinstance(kind, str) else kind[0]
    if name == "heads_in":
        return v.T.reshape(v.shape[1], kind[1], -1) if leaf == "kernel" else v.reshape(kind[1], -1)
    if leaf != "kernel":
        return v
    if name == "dense":
        return v.T
    if name == "heads_out":
        return v.T.reshape(kind[1], -1, v.shape[0])
    if name == "conv":
        return v.transpose((2, 1, 0) if v.ndim == 3 else (2, 3, 1, 0))
    if name == "conv_t":
        return v[:, :, ::-1].transpose(2, 0, 1)
    raise ValueError(kind)


_LEAVES = {"dense": ("kernel", "bias"), "conv": ("kernel", "bias"), "conv_t": ("kernel", "bias"),
           "norm": ("scale", "bias"), "heads_in": ("kernel", "bias"), "heads_out": ("kernel", "bias")}
_TORCH_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def carry_from_flax(tree, layout: List[Tuple]) -> Dict[str, torch.Tensor]:
    """A flax tree ({"params": ...} of numpy arrays) -> a torch state dict,
    through ``layout``: (torch module name, flax path "a/b", kind) rows; a
    "param" row names a parameter on both sides."""
    out = {}
    for tname, fpath, kind in layout:
        node = tree["params"]
        for k in fpath.split("/"):
            node = node[k]
        if kind == "param":
            out[tname] = torch.from_numpy(np.array(node, np.float32))
            continue
        name = kind if isinstance(kind, str) else kind[0]
        for leaf in _LEAVES[name]:
            v = _to_torch(kind, leaf, np.array(node[leaf], np.float32))
            out[f"{tname}.{_TORCH_LEAF[leaf]}"] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def carry_to_flax(state_dict, layout: List[Tuple]) -> dict:
    """The inverse of ``carry_from_flax``: float32 numpy leaves."""
    params: dict = {}
    for tname, fpath, kind in layout:
        *mods, last = fpath.split("/")
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        if kind == "param":
            node[last] = state_dict[tname].detach().cpu().numpy().astype(np.float32)
            continue
        node = node.setdefault(last, {})
        name = kind if isinstance(kind, str) else kind[0]
        for leaf in _LEAVES[name]:
            v = state_dict[f"{tname}.{_TORCH_LEAF[leaf]}"].detach().cpu().numpy().astype(np.float32)
            node[leaf] = np.ascontiguousarray(_to_flax(kind, leaf, v))
    return {"params": params}


def _res_layout(tname: str, fpath: str, res: ResBlock1D):
    rows = [(f"{tname}.conv0", f"{fpath}/Conv_0", "conv"), (f"{tname}.norm0", f"{fpath}/GroupNorm_0", "norm"),
            (f"{tname}.film", f"{fpath}/Dense_0", "dense"), (f"{tname}.conv1", f"{fpath}/Conv_1", "conv"),
            (f"{tname}.norm1", f"{fpath}/GroupNorm_1", "norm")]
    if res.res is not None:
        rows.append((f"{tname}.res", f"{fpath}/Conv_2", "conv"))
    return rows


def denoiser_layout(model: Denoiser) -> List[Tuple]:
    """The rows of ``carry_from_flax`` for the JAX CLI's ``Denoiser``."""
    rows = [("time_out", "Dense_0", "dense"), ("time_in", "Dense_1", "dense")]
    if model.frames is not None:
        rows += [(f"frames.{t}", f"FrameEncoder_0/{f}", "conv" if f.startswith("Conv") else "dense")
                 for f, t in (("Conv_0", "conv0"), ("Conv_1", "conv1"), ("Conv_2", "conv2"), ("Dense_0", "fc"))]
    if model.kind == "mlp":
        rows += [(f"mlp.{i}", f"Dense_{i + 2}", "dense") for i in range(len(model.mlp))]
        rows.append(("head", f"Dense_{len(model.mlp) + 2}", "dense"))
        return rows
    unet, u = model.unet, "ConditionalUnet1D_0"
    blocks = [(f"downs.{i}.{j}", b) for i, level in enumerate(unet.downs) for j, b in ((0, level[0]), (1, level[1]))]
    blocks += [(f"mid.{j}", b) for j, b in enumerate(unet.mid)]
    blocks += [(f"ups.{i}.{j}", b) for i, level in enumerate(unet.ups) for j, b in ((1, level[1]), (2, level[2]))]
    for n, (tname, block) in enumerate(blocks):
        rows += _res_layout(f"unet.{tname}", f"{u}/ResBlock1D_{n}", block)
    rows += [(f"unet.downs.{i}.2", f"{u}/Conv_{i}", "conv") for i in range(len(unet.downs))]
    rows += [(f"unet.ups.{i}.0", f"{u}/ConvTranspose_{i}", "conv_t") for i in range(len(unet.ups))]
    rows.append(("unet.final", f"{u}/Conv_{len(unet.downs)}", "conv"))
    return rows


def params_from_flax(tree, model: Denoiser) -> Dict[str, torch.Tensor]:
    return carry_from_flax(tree, denoiser_layout(model))


def params_to_flax(model: Denoiser) -> dict:
    return carry_to_flax(model.state_dict(), denoiser_layout(model))


# ----------------------------------------------------------------------------
# training and sampling
# ----------------------------------------------------------------------------
def draw_epoch(generator: torch.Generator, n: int, batch_size: int, steps: int, horizon: int, act_dim: int):
    """One epoch's draws: the permutation of the n windows, and per
    minibatch the timesteps (nb, bs) and the noise (nb, bs, H, A)."""
    dev = generator.device
    bs = min(batch_size, n)
    nb = max(1, n // bs)
    return dict(perm=torch.randperm(n, generator=generator, device=dev),
                t=torch.randint(0, steps, (nb, bs), generator=generator, device=dev),
                noise=torch.randn((nb, bs, horizon, act_dim), generator=generator, device=dev))


def epoch_step(model: Denoiser, opt, X, Y, XI, alpha_bar: torch.Tensor, draws) -> torch.Tensor:
    """One pass over the epoch's minibatches: noise each chunk to its
    timestep, regress the noise (MSE), one Adam step per minibatch. Returns
    the mean minibatch loss as a device scalar."""
    perm, t, noise = draws["perm"], draws["t"], draws["noise"]
    bs = t.shape[1]
    losses = []
    for i in range(t.shape[0]):
        idx = perm[i * bs:(i + 1) * bs]
        chunk, nz, ti = Y[idx], noise[i], t[i]
        abt = alpha_bar[ti][:, None, None]
        noisy = torch.sqrt(abt) * chunk + torch.sqrt(1 - abt) * nz
        eps = model(noisy, X[idx], XI[idx] if XI is not None else None, ti.to(torch.float32))
        loss = torch.mean((eps - nz) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses).mean()


@torch.no_grad()
def sample_chunk(model: Denoiser, obs, imgs, schedule, x_T: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """DDPM ancestral sampling of one chunk per row from ``x_T`` (B, H, A)
    with the per-step ``noise`` (steps, B, H, A), clipped to [-1, 1]."""
    betas, alphas, alpha_bar = schedule
    steps = len(betas)
    # the reference's f32 coefficients, exact as Python floats
    coef = (np.float32(1) - alphas) / np.sqrt(np.float32(1) - alpha_bar)
    sqrt_a, sigma = np.sqrt(alphas), np.sqrt(betas)
    x = x_T
    for s in range(steps):
        ti = steps - 1 - s
        eps = model(x, obs, imgs, torch.full((x.shape[0],), float(ti), device=x.device))
        x = (x - float(coef[ti]) * eps) / float(sqrt_a[ti])
        if ti > 0:
            x = x + float(sigma[ti]) * noise[s]
    return torch.clamp(x, -1.0, 1.0)


def obs_parts(obs):
    """A batched obs tree of tensors -> (flat state (B, D) f32, frames of
    every camera concatenated on channels (B, h, w, c) uint8, or None), in
    ``_split_obs``'s order."""
    vec, imgs = [], []

    def walk(o):
        if isinstance(o, dict):
            for _, v in sorted(o.items()):
                walk(v)
        elif o.ndim == 4 and o.dtype == torch.uint8:
            imgs.append(o)
        else:
            vec.append(o.to(torch.float32).reshape(o.shape[0], -1))

    walk(obs)
    B = imgs[0].shape[0] if imgs else vec[0].shape[0]
    v = torch.cat(vec, -1) if vec else torch.zeros(B, 0, device=(imgs or vec)[0].device)
    return v, torch.cat(imgs, -1) if imgs else None


def main(argv=None):
    """Returns dict(loss=[per epoch], epochs_per_s, model, epoch (a callable
    that trains one more epoch and returns its mean loss on the device),
    schedule, a_min, a_scale, eval_success=None without --env-id; with it
    also env, obs (the last) and sample_ms, the mean host ms of a
    synchronized sample_chunk)."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    H, W = args.horizon, args.obs_window
    X_np, Y_np, XI_np, a_min_np, a_scale_np = load_dataset(args.traj_path, H, W)
    A = Y_np.shape[-1]
    print(f"dataset: {X_np.shape[0]} windows, state {X_np.shape[1]}, chunk {H}x{A}"
          + (f", images {XI_np.shape[1:]}" if XI_np is not None else ""))

    schedule = ddpm_schedule(args.diffusion_steps)
    alpha_bar = torch.as_tensor(schedule[2], device=dev)
    model = Denoiser(args.denoiser, H, A, X_np.shape[1], XI_np.shape[2:] if XI_np is not None else None, W,
                     args.hidden, args.unet_dims, seed=args.seed).to(dev)
    print(f"denoiser={args.denoiser} params={sum(p.numel() for p in model.parameters()):,}")
    opt = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)
    X, Y = torch.as_tensor(X_np, device=dev), torch.as_tensor(Y_np, device=dev)
    XI = torch.as_tensor(XI_np, device=dev) if XI_np is not None else None
    del X_np, Y_np, XI_np
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)

    def epoch():
        return epoch_step(model, opt, X, Y, XI, alpha_bar,
                          draw_epoch(g, X.shape[0], args.batch_size, args.diffusion_steps, H, A))

    losses = []
    t0 = time.time()
    for e in range(args.epochs):
        losses.append(epoch())
        if e % max(1, args.epochs // 10) == 0 or e == args.epochs - 1:
            print(f"epoch {e}/{args.epochs} eps-mse {float(losses[-1]):.5f} ({time.time() - t0:.1f}s)", flush=True)
    losses = [float(x) for x in losses]
    out = dict(loss=losses, epochs_per_s=args.epochs / max(time.time() - t0, 1e-9), model=model, epoch=epoch,
               schedule=schedule, a_min=a_min_np, a_scale=a_scale_np, eval_success=None)
    if not args.env_id:
        return out

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make

    B = args.eval_episodes
    env = make(args.env_id, num_envs=B, obs_mode=args.obs_mode, device=dev)
    obs, _ = env.reset(seed=123)
    a_min, a_scale = torch.as_tensor(a_min_np, device=dev), torch.as_tensor(a_scale_np, device=dev)
    hist = [obs_parts(obs)] * W
    success = torch.zeros(B, dtype=torch.bool, device=dev)
    sample_s, n_samples = 0.0, 0
    for _ in range(0, EVAL_STEPS, args.act_steps):
        window = torch.cat([v for v, _ in hist[-W:]], -1)
        img_window = torch.stack([im for _, im in hist[-W:]], 1) if hist[0][1] is not None else None
        x_T = torch.randn((B, H, A), generator=g, device=dev)
        noise = torch.randn((args.diffusion_steps, B, H, A), generator=g, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ts = time.perf_counter()
        chunk = sample_chunk(model, window, img_window, schedule, x_T, noise)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        sample_s += time.perf_counter() - ts
        n_samples += 1
        chunk = (chunk + 1.0) / 2.0 * a_scale + a_min  # back to the env's action scale
        for k in range(args.act_steps):
            obs, rew, term, trunc, info = env.step(chunk[:, k])
            hist = hist[1 - W:] + [obs_parts(obs)] if W > 1 else [obs_parts(obs)]
        success |= info["success"]
    out.update(eval_success=float(success.float().mean()), env=env, obs=obs, sample_ms=sample_s / n_samples * 1e3)
    print(f"eval success_once: {out['eval_success']:.3f}")
    return out


if __name__ == "__main__":
    main()
