"""ManiSkillTrajectoryDataset (counterpart of
maniskill_tpu/trajectory/dataset.py): the transitions of every episode of a
RecordEpisode .h5 file, read through ``utils/h5.py``."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..utils import h5


def _load_h5_group(g) -> Dict:
    return {k: _load_h5_group(v) if isinstance(v, h5.Group) else v[()] for k, v in g.items()}


def _index_nested(d, i):
    if isinstance(d, dict):
        return {k: _index_nested(v, i) for k, v in d.items()}
    return d[i]


class ManiSkillTrajectoryDataset:
    """Flat transition dataset over all episodes of a trajectory h5 file.

    Items are dicts of numpy arrays: action, terminated, truncated, and
    reward, obs and next_obs where the file holds them. A plain Python
    sequence; wrap it in a ``torch.utils.data.Dataset`` or stack it as
    needed."""

    def __init__(self, dataset_file: str, load_count: Optional[int] = None, success_only: bool = False):
        self.dataset_file = dataset_file
        self.h5 = h5.File(dataset_file, "r")
        json_path = dataset_file.replace(".h5", ".json")
        self.meta = None
        if os.path.exists(json_path):
            with open(json_path) as f:
                self.meta = json.load(f)

        self.episode_keys = sorted([k for k in self.h5.keys() if k.startswith("traj_")],
                                   key=lambda s: int(s.split("_")[1]))
        if load_count is not None:
            self.episode_keys = self.episode_keys[:load_count]

        self.actions: List[np.ndarray] = []
        self.obs: List = []
        self.rewards: List[np.ndarray] = []
        self.terminated: List[np.ndarray] = []
        self.truncated: List[np.ndarray] = []
        self._index: List = []
        for ek in self.episode_keys:
            g = self.h5[ek]
            acts = g["actions"][()]
            ep = len(self.actions)
            self.actions.append(acts)
            self.terminated.append(g["terminated"][()])
            self.truncated.append(g["truncated"][()])
            if "rewards" in g:
                self.rewards.append(g["rewards"][()])
            if "obs" in g:
                self.obs.append(g["obs"][()] if isinstance(g["obs"], h5.Dataset) else _load_h5_group(g["obs"]))
            self._index += [(ep, t) for t in range(len(acts))]

    def __len__(self):
        return len(self._index)

    def __getitem__(self, i):
        ep, t = self._index[i]
        out = dict(action=self.actions[ep][t], terminated=self.terminated[ep][t], truncated=self.truncated[ep][t])
        if self.rewards:
            out["reward"] = self.rewards[ep][t]
        if self.obs:
            out["obs"] = _index_nested(self.obs[ep], t)
            out["next_obs"] = _index_nested(self.obs[ep], t + 1)
        return out

    def close(self):
        self.h5.close()
