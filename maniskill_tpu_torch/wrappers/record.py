"""RecordEpisode (counterpart of maniskill_tpu/wrappers/record.py): records
trajectories to .h5 (nested obs, actions, terminated/truncated, env_states,
optional rewards) with JSON metadata, and saves videos.

The file's schema is the JAX package's: one group ``traj_{i}`` per
**episode** (episodes are split per env, also under partial resets), with
``actions`` (T, D), ``terminated``/``truncated`` (T,) bool, scalar bool
``success``/``fail``, ``rewards`` (T,) when recorded, ``env_states`` (the
nested state dict, T+1 rows) and ``obs`` (T+1 rows, a dataset or a nested
group); the JSON holds ``env_info`` and one ``episodes`` entry per group
(episode_id, episode_seed, control_mode, elapsed_steps, success, fail).
The .h5 is written by ``utils/h5.py``, so h5py reads it and h5py is not
needed.

Every snapshot (state dict, obs, action, reward, flags) stays a tensor on
the env's device until a flush, which packs the flushed steps into one
byte buffer on the device and copies it to the host once: a recorded step
adds no stream sync and no host-to-device copy to the env's step.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils import h5
from ..utils.visualization import images_to_video, tile_images
from .base import Wrapper


def _tree_map(fn, item):
    if isinstance(item, dict):
        return {k: _tree_map(fn, v) for k, v in item.items()}
    return fn(item)


def _leaves(item, prefix=()):
    if isinstance(item, dict):
        for k, v in item.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, item


def _snapshot(x) -> torch.Tensor:
    """A copy of a batched record that later in-place writes cannot reach:
    tensors stay on their device, anything else becomes a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return torch.from_numpy(np.array(x))


def _dict_to_group(group, data, key: str):
    if isinstance(data, dict):
        sub = group.require_group(key)
        for k, v in data.items():
            _dict_to_group(sub, v, k)
    else:
        group.create_dataset(key, data=data)


class RecordEpisode(Wrapper):
    def __init__(
        self,
        env,
        output_dir: str,
        save_trajectory: bool = True,
        trajectory_name: Optional[str] = None,
        save_video: bool = True,
        info_on_video: bool = False,
        save_on_reset: bool = True,
        max_steps_per_video: Optional[int] = None,
        video_fps: int = 30,
        source_type: Optional[str] = None,
        source_desc: Optional[str] = None,
        record_reward: bool = True,
    ):
        super().__init__(env)
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.save_trajectory = save_trajectory
        self.save_video = save_video
        self.save_on_reset = save_on_reset
        self.max_steps_per_video = max_steps_per_video
        self.video_fps = video_fps
        self.record_reward = record_reward
        self._video_id = 0

        base = env.unwrapped
        self.num_envs = base.num_envs
        self._false = torch.zeros(self.num_envs, dtype=torch.bool, device=base.device)

        if trajectory_name is None:
            trajectory_name = time.strftime("%Y%m%d_%H%M%S")
        self._h5_path = self.output_dir / f"{trajectory_name}.h5"
        self._json_path = self.output_dir / f"{trajectory_name}.json"
        self._h5_file = None
        self._json_data = dict(
            env_info=dict(
                env_id=getattr(base, "uid", type(base).__name__),
                max_episode_steps=getattr(env, "max_episode_steps", None),
                env_kwargs=dict(
                    num_envs=self.num_envs,
                    obs_mode=base.obs_mode,
                    control_mode=base.control_mode,
                    reward_mode=base.reward_mode,
                ),
            ),
            episodes=[],
        )
        self._episode_id = -1
        self._clear_buffer()
        self._video_frames: List = []
        self.flush_stats = dict(flushes=0, d2h_bytes=0, d2h_seconds=0.0, write_seconds=0.0)

    # ------------------------------------------------------------------
    def _clear_buffer(self):
        # Per-step lists of batched (B, ...) snapshots. obs/states hold T+1
        # entries (the leading reset snapshot plus one per step); the others
        # hold T. ``_t0`` is the global index of the first retained step
        # (leading entries are dropped once no live episode needs them);
        # ``_ep_start[i]`` is the global step where env i's episode began.
        self._actions: List = []
        self._rewards: List = []
        self._terminated: List = []
        self._truncated: List = []
        self._success: List = []
        self._fail: List = []
        self._states: List = []
        self._obs: List = []
        self._t0 = 0
        self._ep_start = np.zeros(self.num_envs, np.int64)
        self._ep_seeds = torch.zeros(self.num_envs, dtype=torch.int64, device=self._false.device)

    @property
    def _t(self) -> int:
        """Global count of recorded steps since the last full clear."""
        return self._t0 + len(self._actions)

    def _record_snapshot(self, obs, mask=None):
        """Append the obs/state snapshot, or (a partial reset, ``mask`` on the
        device) patch the latest one with the reset envs' values."""
        base = self.env.unwrapped
        state = _tree_map(_snapshot, base.get_state_dict())
        obs = _tree_map(_snapshot, obs)
        if mask is None or not self._states:
            self._states.append(state)
            self._obs.append(obs)
            return

        def patch(old, new):
            m = mask.to(new.device).reshape((-1,) + (1,) * (new.ndim - 1))
            return torch.where(m, new, old)

        self._states[-1] = _tree_map_pair(patch, self._states[-1], state)
        self._obs[-1] = _tree_map_pair(patch, self._obs[-1], obs)

    # ------------------------------------------------------------------
    def reset(self, *, seed=None, options=None):
        options = options or {}
        env_idx = options.get("env_idx", None)
        base = self.env.unwrapped
        if isinstance(env_idx, torch.Tensor) and env_idx.dtype == torch.bool:
            env_idx = env_idx.nonzero()[:, 0].cpu().numpy()
        if self.save_trajectory and self._actions:
            flush_idx = np.arange(self.num_envs) if env_idx is None else np.asarray(env_idx).reshape(-1)
            self.flush_trajectory(env_idx=flush_idx)
        if self.save_video and env_idx is None and self._video_frames:
            self.flush_video()

        obs, info = self.env.reset(seed=seed, options=options)

        if env_idx is None:
            self._clear_buffer()
        if self.save_trajectory:
            mask = None if env_idx is None else base.env_idx_mask(env_idx)
            self._record_snapshot(obs, mask)
            seeds = getattr(base, "_episode_seeds", None)
            if seeds is not None:
                self._ep_seeds = seeds.clone() if mask is None else torch.where(mask, seeds, self._ep_seeds)
            targets = range(self.num_envs) if env_idx is None else np.asarray(env_idx).reshape(-1)
            for i in targets:
                self._ep_start[i] = self._t
        if self.save_video and env_idx is None:
            self._video_frames.append(self._render_frame())
        return obs, info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        if self.save_trajectory:
            act = _snapshot(action)
            if act.ndim < 2:  # unbatched action: broadcast over envs (B, D)
                act = act.reshape(1, -1).expand(self.num_envs, -1).contiguous()
            self._actions.append(act)
            self._rewards.append(_snapshot(reward))
            self._terminated.append(_snapshot(terminated))
            self._truncated.append(_snapshot(truncated))
            self._success.append(_snapshot(info.get("success", self._false)))
            self._fail.append(_snapshot(info.get("fail", self._false)))
            self._record_snapshot(obs)
        if self.save_video:
            self._video_frames.append(self._render_frame())
            if self.max_steps_per_video is not None and len(self._video_frames) >= self.max_steps_per_video:
                self.flush_video()
        return obs, reward, terminated, truncated, info

    def _render_frame(self):
        img = self.env.render()
        if img is not None and img.ndim == 4:  # (B, H, W, 3) -> one tiled frame
            img = tile_images(img)
        return img

    # ------------------------------------------------------------------
    def _to_host(self, fields: Dict[str, List], envs: Optional[List[int]]) -> Dict[str, np.ndarray]:
        """Stack each field's per-step (B, ...) snapshots on the host as (n,
        len(envs), ...) arrays (every env for None). The device snapshots go
        through one byte buffer and one device-to-host copy."""
        dev_parts, host, layout = [], {}, []
        idx = None if envs is None else torch.as_tensor(envs, device=self._false.device)
        for name, steps in fields.items():
            for path, first in _leaves(steps[0]):
                seq = [_get(s, path) for s in steps]
                if first.device.type == "cpu":
                    arr = torch.stack(seq)
                    host[(name, path)] = (arr if envs is None else arr[:, envs]).numpy()
                    continue
                if idx is not None:
                    seq = [x[idx] for x in seq]
                sel = seq[0]
                layout.append(((name, path), (len(seq),) + tuple(sel.shape), sel.dtype))
                dev_parts += [x.contiguous().reshape(-1).view(torch.uint8) for x in seq]
        if dev_parts:
            t0 = time.perf_counter()
            buf = torch.cat(dev_parts).cpu().numpy()
            self.flush_stats["d2h_seconds"] += time.perf_counter() - t0
            self.flush_stats["d2h_bytes"] += buf.nbytes
            off = 0
            for key, shape, dtype in layout:
                np_dtype = torch.empty((), dtype=dtype).numpy().dtype
                n = int(np.prod(shape)) * np_dtype.itemsize
                host[key] = buf[off:off + n].view(np_dtype).reshape(shape)
                off += n
        out: Dict = {}
        for (name, path), arr in host.items():
            node = out.setdefault(name, {}) if path else out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1] if path else name] = arr
        return out

    def flush_trajectory(self, env_idx=None, save: bool = True):
        """Write finished episodes for the given envs (all envs if None)."""
        if not self.save_trajectory or not self._actions:
            return
        env_idx = np.arange(self.num_envs) if env_idx is None else np.asarray(env_idx).reshape(-1)
        t_end = self._t
        envs = [int(i) for i in env_idx if t_end > int(self._ep_start[int(i)])]
        if self._h5_file is None and save:
            self._h5_file = h5.File(self._h5_path, "w")
        if envs:
            t_lo = int(min(self._ep_start[i] for i in envs))
            lo, hi = t_lo - self._t0, t_end - self._t0
            fields = dict(actions=self._actions[lo:hi], terminated=self._terminated[lo:hi],
                          truncated=self._truncated[lo:hi], success=self._success[hi - 1:hi],
                          fail=self._fail[hi - 1:hi], seeds=[self._ep_seeds],
                          env_states=self._states[lo:hi + 1], obs=self._obs[lo:hi + 1])
            if self.record_reward:
                fields["rewards"] = self._rewards[lo:hi]
            data = self._to_host(fields, None if envs == list(range(self.num_envs)) else envs)
            t0 = time.perf_counter()
            for j, i in enumerate(envs):
                self._write_episode(data, j, int(self._ep_start[i]) - t_lo, t_end - t_lo, save)
                self._ep_start[i] = t_end
            self.flush_stats["write_seconds"] += time.perf_counter() - t0
        if save and self._h5_file is not None:
            t0 = time.perf_counter()
            with open(self._json_path, "w") as f:
                json.dump(self._json_data, f, indent=2, default=str)
            self._h5_file.flush()
            self.flush_stats["write_seconds"] += time.perf_counter() - t0
        self.flush_stats["flushes"] += 1
        self._trim_buffer()

    def _write_episode(self, data: Dict, j: int, lo: int, hi: int, save: bool):
        """Episode of the j-th flushed env: rows lo..hi of the host arrays."""
        self._episode_id += 1
        success = bool(data["success"][0, j])
        fail = bool(data["fail"][0, j])
        if save:
            traj = self._h5_file.create_group(f"traj_{self._episode_id}")
            traj.create_dataset("actions", data=data["actions"][lo:hi, j])
            traj.create_dataset("terminated", data=data["terminated"][lo:hi, j])
            traj.create_dataset("truncated", data=data["truncated"][lo:hi, j])
            traj.create_dataset("success", data=success)
            traj.create_dataset("fail", data=fail)
            if "rewards" in data:
                traj.create_dataset("rewards", data=data["rewards"][lo:hi, j])
            # env_states/obs include the leading reset snapshot: T+1 rows
            _dict_to_group(traj, _tree_map(lambda a: a[lo:hi + 1, j], data["env_states"]), "env_states")
            _dict_to_group(traj, _tree_map(lambda a: a[lo:hi + 1, j], data.get("obs", {})), "obs")
        self._json_data["episodes"].append(dict(
            episode_id=self._episode_id,
            episode_seed=int(data["seeds"][0, j]),
            control_mode=str(self.env.unwrapped.control_mode),
            elapsed_steps=hi - lo,
            success=success,
            fail=fail,
        ))

    def _trim_buffer(self):
        """Drop leading steps no live episode can reach anymore."""
        keep_from = int(min(self._ep_start)) if self.num_envs else self._t
        drop = keep_from - self._t0
        if drop <= 0:
            return
        for name in ("_actions", "_rewards", "_terminated", "_truncated", "_success", "_fail", "_states", "_obs"):
            setattr(self, name, getattr(self, name)[drop:])
        self._t0 = keep_from

    def flush_video(self, save: bool = True, name: Optional[str] = None):
        frames = [f for f in self._video_frames if f is not None]
        if frames and save:
            images_to_video(frames, str(self.output_dir), video_name=name or f"{self._video_id}",
                            fps=self.video_fps)
            self._video_id += 1
        self._video_frames = []

    def close(self):
        if self.save_on_reset:
            self.flush_trajectory()
            if self.save_video:
                self.flush_video()
        if self._h5_file is not None:
            self._h5_file.close()
            self._h5_file = None
        return super().close()


def _tree_map_pair(fn, a, b):
    if isinstance(a, dict):
        return {k: _tree_map_pair(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _get(item, path):
    for k in path:
        item = item[k]
    return item
