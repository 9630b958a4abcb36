"""Interactive teleoperation of the Panda (counterpart of
maniskill_tpu/examples/teleoperation/interactive_panda.py).

Two front ends:
- terminal (default): raw-tty keys drive ``pd_ee_target_delta_pos`` actions,
  one control step per key, and each step prints the TCP position and the
  task's status; frames can be saved.
- ``--browser PORT``: serves the human render camera as a live MJPEG stream
  (``viewer/server.py``); keyboard, click-drag and wheel in the browser drive
  the end effector. ``--record-dir`` saves the episode as a trajectory.
Runs on the card unless ``--device cpu`` is given.

Keys: w/s = +-x, a/d = +-y, r/f = +-z, g = toggle gripper,
      x = reset, q = quit.

Usage:
    python -m maniskill_tpu_torch.examples.teleoperation.interactive_panda \\
        --env-id PickCube-v1 [--save-frames frames/]
    python -m maniskill_tpu_torch.examples.teleoperation.interactive_panda \\
        --env-id PickCube-v1 --browser 8400 [--record-dir demos/teleop]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .drag_object import _KEY_DELTAS, _read_key, save_frame  # noqa: F401 (_read_key is the seam tests patch)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--env-id", default="PickCube-v1")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--speed", type=float, default=1.0, help="delta scale (x0.1 m)")
    p.add_argument("--save-frames", default=None)
    p.add_argument("--browser", type=int, default=None, metavar="PORT",
                   help="serve a browser viewer on this port instead of the tty (0: a free port)")
    p.add_argument("--record-dir", default=None,
                   help="browser mode: save teleoperated episodes as demo trajectories")
    p.add_argument("--max-steps", type=int, default=0, help="browser mode: stop after N steps (0 = run forever)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def browser_action(events, gripper: float):
    """Browser events -> (delta (3,), gripper, moved, reset, quit), the
    reference's mapping: keys step one axis, a drag moves in the camera plane
    (browser x ~ world -y, browser y ~ world -x), the wheel moves z."""
    delta = np.zeros(3, np.float32)
    moved = reset = quit_ = False
    for ev in events:
        if ev.get("type") == "key":
            k = ev.get("key", "")
            if k == "q":
                quit_ = True
            elif k == "x":
                reset = moved = True
            elif k == "g":
                gripper = -gripper
                moved = True
            else:
                delta += np.array(_KEY_DELTAS.get(k, (0, 0, 0)), np.float32)
                moved = moved or k in _KEY_DELTAS
        elif ev.get("type") == "drag":
            delta += np.array([-ev.get("dy", 0.0) * 2.0, -ev.get("dx", 0.0) * 2.0, 0.0], np.float32)
            moved = True
        elif ev.get("type") == "wheel":
            delta += np.array([0, 0, -0.3 * ev.get("dz", 0)], np.float32)
            moved = True
    return delta, gripper, moved, reset, quit_


def browser_main(args, on_start=None):
    """The browser-viewer loop: stream frames out, drain input events, step.
    ``on_start(viewer)`` runs once the viewer serves its first frame.
    Returns the TCP position after the reset (``tcp0``), each step's TCP
    position, reward and success (host arrays), the env and the viewer
    (closed)."""
    from ... import envs  # noqa: F401 (registers the tasks)
    from ...utils.registration import make
    from ...viewer import BrowserViewer

    env = make(args.env_id, num_envs=1, obs_mode="state", control_mode="pd_ee_target_delta_pos",
               render_mode="rgb_array", device=args.device)
    if args.record_dir:
        from ...wrappers.record import RecordEpisode

        env = RecordEpisode(env, args.record_dir, save_trajectory=True, save_video=False)
    base = env.unwrapped
    env.reset(seed=args.seed)
    tcp0 = base.agent.tcp.pose.p[0].cpu().numpy()
    viewer = BrowserViewer(port=args.browser)
    print(f"viewer: http://localhost:{viewer.port}  (q in browser quits)", flush=True)

    gripper, running = 1.0, True
    tcps, rewards, successes = [], [], []
    viewer.push_frame(env.render()[0])
    if on_start is not None:
        on_start(viewer)
    try:
        while running:
            delta, gripper, moved, reset, quit_ = browser_action(viewer.poll_events(), gripper)
            running = not quit_
            if reset:
                env.reset(seed=args.seed)
            if not moved:
                time.sleep(0.02)
                continue
            action = np.concatenate([np.clip(delta, -1, 1) * args.speed, [gripper]]).astype(np.float32)
            _, rew, term, _, info = env.step(action)
            viewer.push_frame(env.render()[0])
            tcp = base.agent.tcp.pose.p[0].cpu().numpy()
            succ = bool(info.get("success", term)[0])
            r = float(rew[0])
            tcps.append(tcp)
            rewards.append(r)
            successes.append(succ)
            viewer.set_status(dict(step=len(tcps), tcp=[round(float(v), 3) for v in tcp],
                                   gripper="open" if gripper > 0 else "closed", reward=round(r, 3), success=succ))
            if args.max_steps and len(tcps) >= args.max_steps:
                running = False
    finally:
        env.close()
        viewer.close()
    return dict(tcp0=tcp0, tcp=np.asarray(tcps), reward=np.asarray(rewards), success=np.asarray(successes),
                env=env, viewer=viewer)


def main(argv=None, on_start=None):
    """Runs the loop until ``q``; returns each step's TCP position, reward
    and success (host arrays). ``on_start`` is the browser loop's hook."""
    args = parse_args(argv)
    if args.browser is not None:
        return browser_main(args, on_start)
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
