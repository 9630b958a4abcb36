"""Trajectory replay CLI (counterpart of
maniskill_tpu/trajectory/replay_trajectory.py).

Replays recorded trajectories through an env, by stored actions or by
restoring stored env states, optionally converting the control mode
(pd_joint_pos recordings -> pd_joint_delta_pos / pd_ee_delta_pos /
pd_ee_delta_pose through FK of the commanded targets), retrying up to
``--max-retry`` times, batching episodes over ``--num-envs`` parallel envs
(open loop, without env states or conversion), and re-recording with
another ``--obs-mode`` (``--save-traj``): state demos become rgb datasets,
rendered through the camera's kernel on the card. Runs on the card unless
``--device cpu`` is given.

With ``--use-env-states`` each step takes the recorded action and then
restores the recorded state of the step's end, as upstream ManiSkill does,
and success is read from the last restored state. (The JAX package restores
state t+1 and then steps with action t, which ends one step past the
recording: its replay reports failure on recorded successes.)

Usage:
    python -m maniskill_tpu_torch.trajectory.replay_trajectory \\
        --traj-path demos/PickCube-v1/mp_PickCube-v1.h5 --num-envs 24 [--obs-mode rgb --save-traj]
    python -m maniskill_tpu_torch.trajectory.replay_trajectory --traj-path out/traj.h5 \\
        --use-env-states | --control-mode pd_ee_delta_pose [--max-retry 3] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..utils import h5
from .dataset import _load_h5_group


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--traj-path", required=True)
    p.add_argument("--obs-mode", default=None)
    p.add_argument("--control-mode", default=None, help=(
        "target control mode; recordings made with pd_joint_pos can be "
        "converted to pd_joint_delta_pos / pd_ee_delta_pos / pd_ee_delta_pose"
    ))
    p.add_argument("--use-env-states", action="store_true")
    p.add_argument("--use-first-env-state", action="store_true", help=(
        "start each episode from its recorded first state (upstream's flag): the port's RNG draws "
        "other initial states than the JAX package's for the same seed, so a JAX-recorded file "
        "replays only this way"))
    p.add_argument("--save-traj", action="store_true")
    p.add_argument("--save-video", action="store_true")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--num-episodes", type=int, default=None)
    p.add_argument("--max-retry", type=int, default=0,
                   help="re-attempt an unsuccessful episode up to N times")
    p.add_argument("--num-envs", type=int, default=1,
                   help=">1 batches episodes across parallel envs (open-loop replay only)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _to_device(d, device, index=None):
    """A nested dict of (T, ...) arrays -> tensors on ``device`` (the row
    ``index`` of each, with a leading env axis of 1, when given)."""
    if isinstance(d, dict):
        return {k: _to_device(v, device, index) for k, v in d.items()}
    a = torch.as_tensor(d, device=device)
    return a if index is None else a[index][None]


def _max_err(want, got) -> torch.Tensor:
    """max |want - got| over every leaf, as a device scalar."""
    if isinstance(want, dict):
        errs = [_max_err(want[k], got[k]) for k in want]
        return torch.stack(errs).max() if errs else torch.zeros(())
    return (want.to(torch.float32) - got.to(torch.float32)).abs().max()


class _ActionConverter:
    """Converts pd_joint_pos actions to another control mode on the fly.

    The source action is the commanded absolute arm target; the converted
    action reproduces it under the new controller:
      - pd_joint_delta_pos: delta = target - current qpos, divided by the
        controller's delta bound and clipped to [-1, 1];
      - pd_ee_delta_pos(e): the end link's pose from FK of the target
        (``Kinematics._fk``, batched on the device), minus the current TCP
        pose, scaled and clipped; the orientation delta as an axis-angle
        (pd_ee_delta_pose only).
    The gripper's part passes through."""

    def __init__(self, env, source_mode: str, target_mode: str):
        self.base = env.unwrapped
        self.agent = self.base.agent
        self.target_mode = target_mode
        if source_mode != "pd_joint_pos":
            raise ValueError(f"can only convert from pd_joint_pos recordings, got {source_mode}")
        self.sub = getattr(self.agent.controller, "controllers", {})
        self.arm = self.sub.get("arm")

    def __call__(self, action) -> torch.Tensor:
        from ..utils.geometry import rotation_conversions as rc

        action = torch.as_tensor(action, dtype=torch.float32, device=self.base.device)
        if action.ndim == 1:
            action = action[None]
        n_arm = len(self.arm.joints) if self.arm is not None else action.shape[-1]
        q_target, grip = action[..., :n_arm], action[..., n_arm:]

        if self.target_mode == "pd_joint_delta_pos":
            cur = self.agent.robot.qpos[..., :n_arm]
            lo, hi = self.arm.config.lower, self.arm.config.upper
            out = torch.clamp((q_target - cur) / max(abs(lo), abs(hi)), -1, 1)
        elif self.target_mode in ("pd_ee_delta_pos", "pd_ee_delta_pose"):
            kin = self.arm.kinematics
            xpos, xquat = kin._fk(q_target)
            tgt_p, tgt_q = xpos[:, kin.end_body], xquat[:, kin.end_body]
            cur = self.agent.tcp_pose
            out = torch.clamp((tgt_p - cur.p) / abs(self.arm.config.pos_lower), -1, 1)
            if self.target_mode == "pd_ee_delta_pose":
                dq = rc.quaternion_multiply(tgt_q, rc.quaternion_conjugate(cur.q))
                aa = rc.quaternion_to_axis_angle(dq)
                out = torch.cat([out, torch.clamp(aa / abs(self.arm.config.rot_lower), -1, 1)], -1)
        else:
            raise ValueError(f"unsupported target control mode {self.target_mode}")
        return torch.cat([out, grip], -1)


def _episode_seed(ep) -> int:
    s = ep.get("episode_seed")
    return int(s[0] if isinstance(s, list) else (s or 0))


def _first_states(trajs, n: int, device):
    """The recorded first states of ``trajs``, stacked on the env axis and
    padded to ``n`` envs with the last one."""
    rows = [_load_h5_group(t["env_states"]) for t in trajs]
    rows += [rows[-1]] * (n - len(rows))

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return torch.as_tensor(np.stack([it[0] for it in items]), device=device)

    return stack(rows)


def _replay_batched(env, h5_file, episodes, use_first_env_state: bool):
    """Episodes batched across the parallel envs: one reset with per-env
    seeds (and the recorded first states, given ``use_first_env_state``),
    then each step the envs' own actions (an episode shorter than
    the batch's longest repeats its last action; success is read at its own
    last step). The actions go to the device once per batch, and success is
    read back once per batch. Returns the per-episode success."""
    base = env.unwrapped
    B, dev = base.num_envs, base.device
    out = []
    for i0 in range(0, len(episodes), B):
        group = episodes[i0:i0 + B]
        trajs = [h5_file[f"traj_{ep['episode_id']}"] for ep in group]
        acts = [t["actions"][()] for t in trajs]
        T, D = max(len(a) for a in acts), acts[0].shape[-1]
        step_act = np.zeros((T, B, D), np.float32)
        for j, a in enumerate(acts):
            step_act[:, j] = a[np.minimum(np.arange(T), len(a) - 1)]
        step_act = torch.as_tensor(step_act, device=dev)
        last_t = torch.as_tensor([len(a) - 1 for a in acts] + [-1] * (B - len(acts)), device=dev)
        seeds = [_episode_seed(ep) for ep in group]
        seeds += [seeds[-1]] * (B - len(group))
        options = dict(reset_to_env_states=_first_states(trajs, B, dev)) if use_first_env_state else None
        env.reset(seed=seeds, options=options)
        done_success = torch.zeros(B, dtype=torch.bool, device=dev)
        for t in range(T):
            _, _, _, _, info = env.step(step_act[t])
            succ = info.get("success", torch.zeros(B, dtype=torch.bool, device=dev))
            done_success = torch.where(last_t == t, succ, done_success)
        done_success = done_success.cpu().numpy()
        for j, ep in enumerate(group):
            print(f"episode {ep['episode_id']}: success={bool(done_success[j])}")
            out.append(bool(done_success[j]))
    return out


def _replay_episode(env, traj, ep, args, convert):
    """One episode in a one-env batch, retried up to ``--max-retry`` times:
    (success, max |restored - recorded| over the env states or None)."""
    base = env.unwrapped
    dev = base.device
    actions = torch.as_tensor(traj["actions"][()], device=dev)
    env_states = None
    if args.use_env_states and "env_states" in traj:
        env_states = _to_device(_load_h5_group(traj["env_states"]), dev)
    success, state_err = False, None
    for _ in range(args.max_retry + 1):
        first = _to_device(_load_h5_group(traj["env_states"]), dev, 0) if args.use_first_env_state else None
        env.reset(seed=_episode_seed(ep) if ep.get("episode_seed") is not None else None,
                  options=None if first is None else dict(reset_to_env_states=first))
        info, err = {}, torch.zeros((), device=dev)
        for t in range(len(actions)):
            act = convert(actions[t]) if convert is not None else actions[t]
            _, _, _, _, info = env.step(act)
            if env_states is not None:
                want = _to_device(env_states, dev, t + 1)
                base.set_state_dict(want)
                err = torch.maximum(err, _max_err(want, base.get_state_dict()))
        if env_states is not None:
            info = base.get_info()  # the restored final state's
            state_err = float(err)
        success = bool(info.get("success", torch.zeros(1, dtype=torch.bool)).reshape(-1)[0])
        if success:
            break
    return success, state_err


def main(argv=None):
    """Replay; returns dict(success=[bool per episode], state_err=[float
    per episode] with --use-env-states, else None; env=the env, closed, for
    a caller that reads its last state)."""
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.wrappers.record import RecordEpisode

    args = parse_args(argv)
    h5_file = h5.File(args.traj_path, "r")
    with open(args.traj_path.replace(".h5", ".json")) as f:
        meta = json.load(f)

    env_info = meta["env_info"]
    env_kwargs = dict(env_info.get("env_kwargs", {}))
    source_mode = env_kwargs.get("control_mode")
    if args.obs_mode:
        env_kwargs["obs_mode"] = args.obs_mode
    converting = args.control_mode is not None and args.control_mode != source_mode
    if converting:
        env_kwargs["control_mode"] = args.control_mode
    env_kwargs["num_envs"] = args.num_envs
    env = make(env_info["env_id"], device=args.device, **env_kwargs)
    convert = _ActionConverter(env, source_mode, args.control_mode) if converting else None

    out_dir = args.output_dir or os.path.dirname(args.traj_path) or "."
    if args.save_traj or args.save_video:
        env = RecordEpisode(env, out_dir, save_trajectory=args.save_traj, save_video=args.save_video,
                            trajectory_name=os.path.basename(args.traj_path).replace(".h5", "") + ".replay")

    episodes = meta["episodes"]
    if args.num_episodes:
        episodes = episodes[:args.num_episodes]

    result = dict(success=[], state_err=None, env=env)
    if args.num_envs > 1 and not args.use_env_states and convert is None:
        result["success"] = _replay_batched(env, h5_file, episodes, args.use_first_env_state)
    else:
        if args.use_env_states:
            result["state_err"] = []
        for ep in episodes:
            success, err = _replay_episode(env, h5_file[f"traj_{ep['episode_id']}"], ep, args, convert)
            result["success"].append(success)
            line = f"episode {ep['episode_id']}: success={success}"
            if err is not None:
                result["state_err"].append(err)
                line += f", restored states within {err:.3g} of the recording"
            print(line)
    print(f"replayed {len(episodes)} episodes, success={sum(result['success'])}")
    env.close()
    h5_file.close()
    return result


if __name__ == "__main__":
    main()
