"""Convert RecordEpisode trajectories to the LeRobot v2 dataset layout
(counterpart of maniskill_tpu/trajectory/convert_to_lerobot.py), reading the
file through ``utils/h5.py``.

Output layout:
    out/
      data/chunk-000/episode_000000.parquet   (one row per frame)
      meta/info.json                          (features, fps, counts)
      meta/episodes.jsonl                     (per-episode index)
      meta/stats.json                         (per-feature mean/std/min/max)
      meta/tasks.jsonl

Only flat state observations are converted, as in the JAX package. Writing
parquet needs pandas and pyarrow, imported by ``main`` alone: without them
it raises an ImportError that names them.

Usage:
    python -m maniskill_tpu_torch.trajectory.convert_to_lerobot \\
        --traj-path out/traj.h5 --output-dir out/lerobot [--fps 30]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..utils import h5


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--traj-path", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--chunks-size", type=int, default=1000)
    p.add_argument("--robot-type", default="panda")
    return p.parse_args(argv)


def _episodes_from_h5(f):
    """Yield (obs (T+1, D), actions (T, A), rewards or None) per episode,
    a batched (T, B, ...) layout split into B episodes."""
    for key in sorted(f.keys(), key=lambda s: int(s.split("_")[1])):
        g = f[key]
        acts = np.asarray(g["actions"][()], np.float32)
        obs = np.asarray(g["obs"][()], np.float32)
        rew = np.asarray(g["rewards"][()], np.float32) if "rewards" in g else None
        if acts.ndim == 3:
            for b in range(acts.shape[1]):
                yield obs[:, b], acts[:, b], (rew[:, b] if rew is not None else None)
        else:
            yield obs, acts, rew


def _stats(x: np.ndarray) -> dict:
    return dict(mean=x.mean(0).tolist(), std=x.std(0).tolist(), min=x.min(0).tolist(), max=x.max(0).tolist())


def main(argv=None):
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError("convert_to_lerobot writes parquet through pandas and pyarrow; install both") from e

    args = parse_args(argv)
    meta_path = args.traj_path.replace(".h5", ".json")
    env_meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            env_meta = json.load(f)

    out = args.output_dir
    os.makedirs(f"{out}/data/chunk-000", exist_ok=True)
    os.makedirs(f"{out}/meta", exist_ok=True)

    with h5.File(args.traj_path, "r") as f:
        episodes = list(_episodes_from_h5(f))
    ep_lengths = []
    all_state, all_action = [], []
    for ep_idx, (obs, acts, rew) in enumerate(episodes):
        T = len(acts)
        chunk = ep_idx // args.chunks_size
        os.makedirs(f"{out}/data/chunk-{chunk:03d}", exist_ok=True)
        frame = {
            "observation.state": list(obs[:T]),
            "action": list(acts),
            "timestamp": (np.arange(T) / args.fps).astype(np.float32),
            "frame_index": np.arange(T, dtype=np.int64),
            "episode_index": np.full(T, ep_idx, np.int64),
            "index": np.arange(T, dtype=np.int64) + int(np.sum(ep_lengths, dtype=np.int64)),
            "task_index": np.zeros(T, np.int64),
        }
        if rew is not None:
            frame["next.reward"] = rew
        pd.DataFrame(frame).to_parquet(f"{out}/data/chunk-{chunk:03d}/episode_{ep_idx:06d}.parquet")
        ep_lengths.append(T)
        all_state.append(obs[:T])
        all_action.append(acts)

    S = np.concatenate(all_state, 0)
    A = np.concatenate(all_action, 0)
    env_id = env_meta.get("env_info", {}).get("env_id", "unknown")
    with open(f"{out}/meta/stats.json", "w") as f:
        json.dump({"observation.state": _stats(S), "action": _stats(A)}, f)
    with open(f"{out}/meta/episodes.jsonl", "w") as f:
        for i, L in enumerate(ep_lengths):
            f.write(json.dumps(dict(episode_index=i, tasks=[env_id], length=int(L))) + "\n")
    info = dict(
        codebase_version="v2.0",
        robot_type=args.robot_type,
        total_episodes=len(ep_lengths),
        total_frames=int(np.sum(ep_lengths)),
        total_tasks=1,
        total_chunks=(len(ep_lengths) + args.chunks_size - 1) // args.chunks_size,
        chunks_size=args.chunks_size,
        fps=args.fps,
        data_path="data/chunk-{episode_chunk:03d}/episode_{episode_index:06d}.parquet",
        features={
            "observation.state": dict(dtype="float32", shape=[int(S.shape[1])], names=None),
            "action": dict(dtype="float32", shape=[int(A.shape[1])], names=None),
            "timestamp": dict(dtype="float32", shape=[1], names=None),
            "frame_index": dict(dtype="int64", shape=[1], names=None),
            "episode_index": dict(dtype="int64", shape=[1], names=None),
            "index": dict(dtype="int64", shape=[1], names=None),
            "task_index": dict(dtype="int64", shape=[1], names=None),
        },
    )
    with open(f"{out}/meta/info.json", "w") as f:
        json.dump(info, f, indent=2)
    with open(f"{out}/meta/tasks.jsonl", "w") as f:
        f.write(json.dumps(dict(task_index=0, task=env_id)) + "\n")
    print(f"wrote {len(ep_lengths)} episodes / {int(np.sum(ep_lengths))} frames to {out}")


if __name__ == "__main__":
    main()
