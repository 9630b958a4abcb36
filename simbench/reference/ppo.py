"""Plain reference of a PPO iteration: the rollout's sampling, bootstrap and
resets, then the first minibatch steps of the update (GAE, the
clipped-ratio and value loss, the global-norm clip, Adam, a learning rate
decaying linearly to 0).

It follows the program from the state it held before the iteration: the
policy's parameters, Adam's moments, the generator that draws the actions,
the reset seeds and the minibatch order, the obs and elapsed counters, and
the env's state before each rollout step (the env's step and reset are the
caller's, from ``tasks.py``). The policy is the tanh MLP of ManiSkill's PPO
baseline (separate actor and critic trunks of two hidden layers, a
state-independent log std clipped to [-4, 1]), written here with
``torch.nn.functional``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
from torch.nn import functional as F

LOG_2PI = math.log(2 * math.pi)
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def policy(P: Dict[str, torch.Tensor], x: torch.Tensor):
    """(mean, log_std, value) of the MLP policy."""
    h = torch.tanh(F.linear(x, P["actor.0.weight"], P["actor.0.bias"]))
    h = torch.tanh(F.linear(h, P["actor.2.weight"], P["actor.2.bias"]))
    mean = F.linear(h, P["actor_mean.weight"], P["actor_mean.bias"])
    v = torch.tanh(F.linear(x, P["critic.0.weight"], P["critic.0.bias"]))
    v = torch.tanh(F.linear(v, P["critic.2.weight"], P["critic.2.bias"]))
    value = F.linear(v, P["value_head.weight"], P["value_head.bias"])[..., 0]
    return mean, torch.clamp(P["log_std"], -4.0, 1.0), value


def logp(action, mean, log_std):
    return -0.5 * torch.sum(((action - mean) / torch.exp(log_std)) ** 2 + 2 * log_std + LOG_2PI, -1)


def gae(rewards, dones, values, last_value, gamma: float, lam: float):
    not_done = 1.0 - dones.to(torch.float32)
    advs = torch.empty_like(rewards)
    running, next_value = torch.zeros_like(last_value), last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_value * not_done[t] - values[t]
        running = delta + gamma * lam * not_done[t] * running
        advs[t], next_value = running, values[t]
    return advs, advs + values


def loss(P, batch, cfg) -> torch.Tensor:
    obs, actions, old_logp, advs, returns = batch
    mean, log_std, value = policy(P, obs)
    ratio = torch.exp(torch.clamp(logp(actions, mean, log_std) - old_logp, -20.0, 20.0))
    advs_n = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
    pg = -torch.mean(torch.minimum(ratio * advs_n, torch.clamp(ratio, 1 - cfg["clip_eps"], 1 + cfg["clip_eps"]) * advs_n))
    v_loss = 0.5 * torch.mean((value - returns) ** 2)
    entropy = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
    return pg + cfg["vf_coef"] * v_loss - cfg["ent_coef"] * entropy


def rollout(rec: Dict, env_step: Callable, env_reset: Callable, gen: torch.Generator, device) -> List[Dict]:
    """The iteration's rollout steps. Step ``t`` samples the action from the
    policy on the obs the reference reached (the recorded obs at ``t`` = 0),
    steps the env from the program's state before it
    (``env_step(pre_t, action, elapsed) -> obs, reward, terminated, qpos,
    qvel, data``), ends the episodes that terminated or reached their
    length, adds the discounted value of their final obs to their reward,
    and resets them from seeds drawn after the action
    (``env_reset(data, rows, seeds) -> obs, qpos, qvel``). Each step's
    action, log-probability, value, reward, done and terminated flags, the
    obs and the state it hands on, and the elapsed counters after it."""
    cfg = rec["config"]
    P = dict(zip(rec["names"], (p.to(device) for p in rec["params"])))
    obs, elapsed = rec["obs"].to(device), rec["elapsed"].to(device)
    out = []
    for t in range(cfg["rollout_steps"]):
        mean, log_std, value = policy(P, obs)
        noise = torch.randn(mean.shape, generator=gen, device=device)
        action = mean + torch.exp(log_std) * noise
        step = env_step(rec["pre"][t], action, elapsed)
        elapsed = elapsed + 1
        done = step["terminated"] | (elapsed >= rec["max_episode_steps"])
        reward = step["reward"] + cfg["gamma"] * policy(P, step["obs"])[2] * done.to(torch.float32)
        seeds = torch.randint(0, 2**31, (obs.shape[0],), generator=gen, device=device)
        next_obs, qpos, qvel = step["obs"].clone(), step["qpos"].clone(), step["qvel"].clone()
        idx = done.nonzero()[:, 0]
        if len(idx):
            start = env_reset(step["data"], idx, seeds[idx])
            next_obs[idx], qpos[idx], qvel[idx] = start["obs"], start["qpos"], start["qvel"]
        elapsed = torch.where(done, 0, elapsed)
        out.append(dict(obs_in=obs, action=action, logp=logp(action, mean, log_std), value=value, reward=reward,
                        done=done, terminated=step["terminated"], obs=next_obs, qpos=qpos, qvel=qvel,
                        elapsed=elapsed))
        obs = next_obs
    return out


def update_steps(rec: Dict, steps: List[Dict], gen: torch.Generator, n: int, device) -> Dict:
    """The first ``n`` minibatch steps of the update after the rollout
    ``steps``, from the parameters and Adam's moments before the iteration:
    each step's loss, the clipped gradient of the first step, and the
    parameters after the ``n``-th. Adam's step count and the learning rate
    follow from the updates run before (``updates_before``)."""
    cfg = rec["config"]
    names: List[str] = rec["names"]
    params = [p.to(device).clone() for p in rec["params"]]
    P = dict(zip(names, params))
    stack = lambda key: torch.stack([s[key] for s in steps])  # noqa: E731
    with torch.no_grad():
        last_value = policy(P, steps[-1]["obs"])[2]
        advs, returns = gae(stack("reward"), stack("done"), stack("value"), last_value, cfg["gamma"], cfg["gae_lambda"])
    flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
    batch = tuple(flat(x) for x in (stack("obs_in"), stack("action"), stack("logp"), advs, returns))
    N = batch[1].shape[0]
    mb = N // cfg["num_minibatches"]
    perm = torch.randperm(N, generator=gen, device=device)
    per_update = cfg["update_epochs"] * cfg["num_minibatches"]
    k0, total = rec["updates_before"] * per_update, rec["total_updates"] * per_update
    m = [x.to(device) for x in rec["adam_m"]]
    v = [x.to(device) for x in rec["adam_v"]]
    losses, grad1 = [], None
    for k in range(n):
        idx = perm[k * mb:(k + 1) * mb]
        leaves = [p.detach().requires_grad_(True) for p in params]
        L = loss(dict(zip(names, leaves)), tuple(b[idx] for b in batch), cfg)
        grads = torch.autograd.grad(L, leaves)
        losses.append(float(L.detach()))
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(x) for x in grads]))
        scale = torch.where(norm < cfg["max_grad_norm"], 1.0, cfg["max_grad_norm"] / norm)
        grads = [x * scale for x in grads]
        if k == 0:
            grad1 = grads
        lr = cfg["lr"] * (1.0 - min(k0 + k, total) / total)
        t = k0 + k + 1
        with torch.no_grad():
            for i, (p, gr) in enumerate(zip(params, grads)):
                m[i] = BETA1 * m[i] + (1 - BETA1) * gr
                v[i] = BETA2 * v[i] + (1 - BETA2) * gr * gr
                denom = (v[i] / (1 - BETA2 ** t)).sqrt() + EPS
                params[i] = p - lr * (m[i] / (1 - BETA1 ** t)) / denom
    return dict(losses=losses, grad1=grad1, params_n=params, params0=[p.to(device) for p in rec["params"]])
