"""Merge trajectory files (counterpart of
maniskill_tpu/trajectory/merge_trajectory.py): combines RecordEpisode
.h5/.json pairs into one, renumbering the episodes in order.

Usage:
    python -m maniskill_tpu_torch.trajectory.merge_trajectory -i a.h5 b.h5 -o merged.h5
"""
from __future__ import annotations

import argparse
import json

from ..utils import h5


def merge_trajectories(output_path: str, traj_paths, recompute_id: bool = True):
    merged = dict(env_info=None, episodes=[])
    new_id = 0
    with h5.File(output_path, "w") as out_h5:
        for path in traj_paths:
            with h5.File(path, "r") as src, open(path.replace(".h5", ".json")) as f:
                meta = json.load(f)
                if merged["env_info"] is None:
                    merged["env_info"] = meta.get("env_info")
                for ep in meta["episodes"]:
                    old = f"traj_{ep['episode_id']}"
                    if old not in src:
                        continue
                    tid = new_id if recompute_id else ep["episode_id"]
                    h5.copy(src[old], out_h5, f"traj_{tid}")
                    merged["episodes"].append(dict(ep, episode_id=tid))
                    new_id += 1
    with open(output_path.replace(".h5", ".json"), "w") as f:
        json.dump(merged, f, indent=2, default=str)
    print(f"merged {new_id} episodes into {output_path}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-i", "--inputs", nargs="+", required=True)
    p.add_argument("-o", "--output", required=True)
    args = p.parse_args(argv)
    merge_trajectories(args.output, args.inputs)


if __name__ == "__main__":
    main()
