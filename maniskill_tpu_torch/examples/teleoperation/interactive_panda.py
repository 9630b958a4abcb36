"""Interactive teleoperation of the Panda from the terminal (counterpart of
maniskill_tpu/examples/teleoperation/interactive_panda.py).

Raw-tty keys drive ``pd_ee_target_delta_pos`` actions, one control step per
key, and each step prints the TCP position and the task's status; frames can
be saved. The browser viewer (``--browser``) is not ported yet. Runs on the
card unless ``--device cpu`` is given.

Keys: w/s = +-x, a/d = +-y, r/f = +-z, g = toggle gripper,
      x = reset, q = quit.

Usage:
    python -m maniskill_tpu_torch.examples.teleoperation.interactive_panda \\
        --env-id PickCube-v1 [--save-frames frames/]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from .drag_object import _KEY_DELTAS, _read_key, save_frame  # noqa: F401 (_read_key is the seam tests patch)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--env-id", default="PickCube-v1")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--speed", type=float, default=1.0, help="delta scale (x0.1 m)")
    p.add_argument("--save-frames", default=None)
    p.add_argument("--browser", type=int, default=None, metavar="PORT",
                   help="serve a browser viewer on this port (not ported yet)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Runs the loop until ``q``; returns each step's TCP position, reward
    and success (host arrays)."""
    args = parse_args(argv)
    if args.browser is not None:
        raise NotImplementedError("the browser viewer (viewer/server.py) is not ported yet; "
                                  "run without --browser for the terminal front end")
    from ... import envs  # noqa: F401 (registers the tasks)
    from ...utils.registration import make

    env = make(args.env_id, num_envs=1, obs_mode="state", control_mode="pd_ee_target_delta_pos",
               render_mode="rgb_array" if args.save_frames else None, device=args.device)
    base = env.unwrapped
    env.reset(seed=args.seed)
    if args.save_frames:
        os.makedirs(args.save_frames, exist_ok=True)

    gripper = 1.0
    tcps, rewards, successes = [], [], []
    print(__doc__.split("Keys:")[1].split("Usage:")[0])
    while True:
        key = _read_key()
        if key in ("q", "\x03"):
            break
        if key == "x":
            env.reset(seed=args.seed)
            continue
        if key == "g":
            gripper = -gripper
        delta = np.array(_KEY_DELTAS.get(key, (0, 0, 0)), np.float32) * args.speed
        action = np.concatenate([delta, [gripper]]).astype(np.float32)
        _, rew, term, _, info = env.step(action)
        tcp = base.agent.tcp.pose.p[0].cpu().numpy()
        succ = bool(info.get("success", term)[0])
        r = float(rew[0])
        tcps.append(tcp)
        rewards.append(r)
        successes.append(succ)
        t = len(tcps)
        print(f"step {t} tcp=[{tcp[0]:+.3f} {tcp[1]:+.3f} {tcp[2]:+.3f}] "
              f"grip={'open' if gripper > 0 else 'closed'} reward={r:.3f} success={succ}", flush=True)
        if args.save_frames:
            save_frame(args.save_frames, t, env.render()[0].cpu().numpy())
    env.close()
    return dict(tcp=np.asarray(tcps), reward=np.asarray(rewards), success=np.asarray(successes), env=env)


if __name__ == "__main__":
    main()
