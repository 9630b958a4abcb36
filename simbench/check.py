"""The comparison that decides ``correct``: what the window's steps produced
against the plain reference (``reference/``), each number beside its limit."""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch

from .reference import tasks as ref_tasks


def tf32(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to TF32 (10 mantissa bits, to nearest); the
    gradient passes through unchanged."""
    if x.dtype != torch.float32:
        return x
    with torch.no_grad():
        bits = x.detach().contiguous().view(torch.int32)
        rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach() if x.requires_grad else rounded


_MATMULS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
            torch.mm, torch.Tensor.mm, torch.bmm, torch.Tensor.bmm, torch.einsum, torch.mv, torch.Tensor.mv}
# products with an added term: only the factors are rounded
_FACTORS = {torch.nn.functional.linear: (0, 1), torch.addmm: (1, 2), torch.baddbmm: (1, 2),
            torch.addbmm: (1, 2)}


class _TF32Matmuls(torch.overrides.TorchFunctionMode):
    """Rounds the float32 factors of every matrix product to TF32, as the
    tensor cores do with TF32 on, whichever kernel the library picks."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _MATMULS:
            args = tuple(tf32(a) if isinstance(a, torch.Tensor) else a for a in args)
        elif func in _FACTORS:
            args = tuple(tf32(a) if i in _FACTORS[func] and isinstance(a, torch.Tensor) else a
                         for i, a in enumerate(args))
        return func(*args, **kwargs)


@contextlib.contextmanager
def precision(control: bool):
    """The reference as the configuration states it (float32, TF32 off), or
    the control one precision below: TF32 matmuls, switched on and emulated
    on every product's operands (most of the physics' small products run as
    matrix-vector kernels, which TF32 leaves in float32)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = control
    try:
        if control:
            with _TF32Matmuls():
                yield
        else:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _amax(x: torch.Tensor) -> float:
    if x.numel() == 0:
        return 0.0
    v = float(torch.nan_to_num(x.abs(), nan=math.inf).amax())
    return v


def _flags(obs, terminated, truncated):
    """The observation's columns with the step's termination and truncation
    appended as 0/1 columns: a flag that differs reads a gap of 1."""
    return torch.cat([obs, terminated[:, None].to(obs.dtype), truncated[:, None].to(obs.dtype)], 1)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """The widest absolute value of each row (NaN reads as infinite)."""
    return torch.nan_to_num(x.abs(), nan=math.inf).reshape(x.shape[0], -1).amax(1)


def vector_env(cell: dict, cfg: dict, records: List[Dict], device, control: bool = False) -> Tuple[Dict, int]:
    """Readings of the checked steps: the widest gap of the observation's
    numbers with its flags (termination, truncation and the observation's
    booleans as 0/1 columns), of the obs the step hands on, of the reward
    (where the configuration has one) and of the physics state (qpos,
    qvel), and the share of the sampled envs' pixels whose colour differs.
    An env reset in the step is held to the reference's step up to its end
    and to the reference's reset, drawn from the same episode seed, after
    it; the others hand on their step's obs. Returns (readings, checked
    env-steps with a number over its limit)."""
    ref_cfg = cfg["reference"]
    scene = ref_tasks.Scene(ref_cfg["scene"], device)
    task = ref_tasks.TASKS[ref_cfg["task"]]
    reset = ref_tasks.RESETS[ref_cfg["task"]]
    substeps = cfg["sim_freq"] // cfg["control_freq"]
    limits = cell["check"].get("limits") or {}
    obs_mode = cell["traffic"]["obs_mode"]
    read = dict(obs_gap=0.0, state_gap=0.0)
    if cfg["reward_mode"] != "none":
        read["reward_gap"] = 0.0
    cams = cfg.get("cameras", [])
    if cams and obs_mode != "state":
        read["frame_gap"] = 0.0
    failed = differing_frames = 0
    diff_px = total_px = 0
    for rec in records:
        pre = ref_tasks.data_from_snapshot(rec["pre"], device)
        with precision(control), torch.no_grad():
            out = task(scene, pre, rec["action"].to(device), rec["elapsed"].to(device), substeps,
                       cfg["max_episode_steps"], obs_mode)
            frames = {cam["name"]: ref_tasks.camera_rgb(scene, out["data"], cam, rec["rows"].to(device))
                      for cam in cams if cam["name"] in rec["frames"]}
        done = rec["done"].to(device)
        obs_rows = _rows(_flags(rec["obs"].to(device), rec["terminated"].to(device), rec["truncated"].to(device))
                         - _flags(out["obs"], out["terminated"], out["truncated"]))
        st = torch.cat([rec["post_qpos"].to(device) - out["qpos"], rec["post_qvel"].to(device) - out["qvel"]], 1)
        # a reset env's state after the step is its new episode's
        st_rows = torch.where(done, 0.0, _rows(st))
        idx = done.nonzero()[:, 0]
        # the obs the step hands on: a reset env's new episode, the others'
        # step obs (a partial reset leaves the envs it does not reset alone)
        handed = out["obs"].clone()
        if len(idx):
            # the envs reset in the step: their new episode against the
            # reference's, drawn from the same episode seeds
            with precision(control), torch.no_grad():
                start = reset(scene, ref_tasks.rows_of(out["data"], idx), rec["seeds"].to(device)[idx], obs_mode)
            handed[idx] = start["obs"]
            st_rows[idx] = _rows(torch.cat([rec["post_qpos"].to(device)[idx] - start["qpos"],
                                            rec["post_qvel"].to(device)[idx] - start["qvel"]], 1))
        obs_rows = torch.maximum(obs_rows, _rows(rec["reset_obs"].to(device) - handed))
        rows = dict(obs_gap=obs_rows, state_gap=st_rows)
        if "reward_gap" in read:
            rows["reward_gap"] = _rows(rec["reward"].to(device)[:, None] - out["reward"][:, None])
        bad = torch.zeros_like(done)
        for name, r in rows.items():
            read[name] = max(read[name], _amax(r))
            if limits.get(name) is not None:
                bad |= r > limits[name]
        failed += int(bad.sum())
        for name, frame in frames.items():
            differs = (rec["frames"][name].to(device) != frame).any(-1)
            diff_px += int(differs.sum())
            total_px += differs.numel()
            differing_frames += int(differs.reshape(differs.shape[0], -1).any(1).sum())
    if "frame_gap" in read:
        read["frame_gap"] = diff_px / max(total_px, 1)
        # the limit holds the share over all sampled frames: where it is
        # passed, every sampled frame that differs counts as failed
        if limits.get("frame_gap") is not None and read["frame_gap"] > limits["frame_gap"]:
            failed += differing_frames
    return read, failed


def judge(read: Dict, limits: Dict) -> Tuple[bool, Dict]:
    """Every reading at or under its limit; a reading without a limit fails."""
    table, ok = {}, True
    for name, value in read.items():
        limit = limits.get(name)
        table[name] = dict(value=value, limit=limit)
        ok = ok and limit is not None and value <= limit
    return ok, table


def _leaf_gap(prog: List[torch.Tensor], ref: List[torch.Tensor], keep: List[bool]) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    pn = [float(torch.linalg.vector_norm(x)) for x in prog]
    rn = [float(torch.linalg.vector_norm(x)) for x in ref]
    kept = [r for r, k in zip(rn, keep) if k]
    med = sorted(kept)[len(kept) // 2] if kept else 0.0
    gaps = [abs(p - r) / max(r, med, 1e-30) for p, r, k in zip(pn, rn, keep) if k]
    gaps = [math.inf if math.isnan(x) else x for x in gaps]
    return max(gaps) if gaps else 0.0


def _moved(grads: List[torch.Tensor]) -> List[bool]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move under Adam by round-off alone)."""
    gn = [float(torch.linalg.vector_norm(x)) for x in grads]
    med = sorted(gn)[len(gn) // 2]
    return [x >= 1e-3 * med for x in gn]


def ppo_left_out(cell: dict, cfg: dict, records: List[Dict], device) -> List[str]:
    """The names of the leaves that ``ppo`` leaves out of the change."""
    out = set()
    for rec in records:
        grads = _ppo_reference(cfg, rec, 1, device)[1]["grad1"]
        out.update(n for n, k in zip(rec["names"], _moved(grads)) if not k)
    return sorted(out)


def _ppo_reference(cfg: dict, rec: Dict, n: int, device):
    """(rollout steps, update) of the reference from ``rec``'s state."""
    from .reference import ppo as ref_ppo

    scene = ref_tasks.Scene(cfg["reference"]["scene"], device)
    task = ref_tasks.TASKS[cfg["reference"]["task"]]
    reset = ref_tasks.RESETS[cfg["reference"]["task"]]
    substeps = cfg["sim_freq"] // cfg["control_freq"]

    def env_step(pre, action, elapsed):
        with torch.no_grad():
            return task(scene, ref_tasks.data_from_snapshot(pre, device), action, elapsed, substeps,
                        cfg["max_episode_steps"], "state")

    def env_reset(data, rows, seeds):
        with torch.no_grad():
            return reset(scene, ref_tasks.rows_of(data, rows), seeds, "state")

    gen = torch.Generator(device=device)
    gen.set_state(rec["generator"])
    with torch.no_grad():
        steps = ref_ppo.rollout(rec, env_step, env_reset, gen, device)
    return steps, ref_ppo.update_steps(rec, steps, gen, n, device)


def ppo(cell: dict, cfg: dict, records: List[Dict], device, control: bool = False) -> Tuple[Dict, int]:
    """Readings of the window's checked iteration. Its rollout steps: the
    widest gap of the sampled actions, their log-probabilities and the
    values (``sample_gap``); of the obs handed on (a reset env's new one),
    with the done and terminated flags and, after the last step, whether
    the elapsed counters agree, as 0/1 columns (``obs_gap``); of the reward
    with its bootstrap (``reward_gap``); of the physics state handed on
    (``state_gap``). Its update's first minibatch steps: the widest relative
    gap of a step's loss, the worst leaf's gap of the first gradient's norm
    as Adam took it (its first moment after the step, less beta1 times the
    one before, over 1 - beta1), and the worst leaf's gap of the parameters'
    change after the steps. Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the change: Adam moves
    them by round-off alone. Returns (readings, readings over their limit)."""
    from .reference import ppo as ref_ppo

    n = max(len(rec["losses"]) for rec in records)
    limits = cell["check"].get("limits") or {}
    read = dict(sample_gap=0.0, obs_gap=0.0, reward_gap=0.0, state_gap=0.0, loss_gap=0.0, grad_gap=0.0,
                change_gap=0.0)
    for rec in records:
        with precision(control):
            steps, ref = _ppo_reference(cfg, rec, n, device)
        t_obs, t_act, t_logp, t_rew, t_done, t_val, t_term = (x.to(device) for x in rec["traj"])
        T = len(steps)
        for t, s in enumerate(steps):
            got_obs = t_obs[t + 1] if t + 1 < T else rec["obs_after"].to(device)
            read["sample_gap"] = max(read["sample_gap"], _amax(t_act[t] - s["action"]), _amax(t_logp[t] - s["logp"]),
                                     _amax(t_val[t] - s["value"]))
            flags = [t_done[t], t_term[t]]
            ref_flags = [s["done"], s["terminated"]]
            if t + 1 == T:
                flags.append(rec["elapsed_after"].to(device) != s["elapsed"])
                ref_flags.append(torch.zeros_like(s["done"]))
            cols = torch.cat([got_obs] + [f[:, None].to(torch.float32) for f in flags], 1)
            ref_cols = torch.cat([s["obs"]] + [f[:, None].to(torch.float32) for f in ref_flags], 1)
            read["obs_gap"] = max(read["obs_gap"], _amax(cols - ref_cols))
            read["reward_gap"] = max(read["reward_gap"], _amax(t_rew[t] - s["reward"]))
            post = rec["pre"][t + 1]
            read["state_gap"] = max(read["state_gap"], _amax(post["data.qpos"].to(device) - s["qpos"]),
                                    _amax(post["data.qvel"].to(device) - s["qvel"]))
        lp, lr = rec["losses"], ref["losses"]
        read["loss_gap"] = max(read["loss_gap"], max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr)))
        if rec["adam1"] is None or rec["params_n"] is None:
            # the optimizer never stepped
            read["grad_gap"] = read["change_gap"] = math.inf
            continue
        g_prog = [(a.to(device) - ref_ppo.BETA1 * b.to(device)) / (1 - ref_ppo.BETA1)
                  for a, b in zip(rec["adam1"], rec["adam_m"])]
        read["grad_gap"] = max(read["grad_gap"], _leaf_gap(g_prog, ref["grad1"], [True] * len(g_prog)))
        keep = _moved(ref["grad1"])
        d_prog = [a.to(device) - b for a, b in zip(rec["params_n"], ref["params0"])]
        d_ref = [a - b for a, b in zip(ref["params_n"], ref["params0"])]
        read["change_gap"] = max(read["change_gap"], _leaf_gap(d_prog, d_ref, keep))
    failed = sum(1 for k, v in read.items() if limits.get(k) is not None and v > limits[k])
    return read, failed
