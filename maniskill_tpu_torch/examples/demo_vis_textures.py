"""Texture-visualization demo CLI (counterpart of
maniskill_tpu/examples/demo_vis_textures.py): renders every image-like
texture of the obs mode (rgb, depth, normal, albedo, segmentation in any
"+"-combination) and saves them tiled (a PNG where Pillow is installed, else
.npy). Runs on the card unless ``--device cpu`` is given.

Usage:
    python -m maniskill_tpu_torch.examples.demo_vis_textures -e PushCube-v1 \
        -o rgb+depth+normal --out textures.png
"""
from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--env-id", default="PushCube-v1")
    p.add_argument("-o", "--obs-mode", default="rgb+depth")
    p.add_argument("--shader", default="minimal")
    p.add_argument("--num-envs", type=int, default=1)
    p.add_argument("--cam-width", type=int, default=None)
    p.add_argument("--cam-height", type=int, default=None)
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--out", default="textures.png")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def to_rgb8(name: str, img: np.ndarray) -> np.ndarray:
    """Any texture as an (H, W, 3) uint8 visualization."""
    if img.dtype == np.uint8 and img.shape[-1] == 3:
        return img
    img = np.asarray(img, np.float32)
    if img.shape[-1] == 1:  # depth (mm) or segmentation ids
        lo, hi = img.min(), img.max()
        gray = (img[..., 0] - lo) / max(hi - lo, 1e-6)
        return np.stack([gray * 255] * 3, axis=-1).astype(np.uint8)
    if "normal" in name:  # [-1, 1] -> rgb
        return ((img * 0.5 + 0.5) * 255).clip(0, 255).astype(np.uint8)
    return (img * 255).clip(0, 255).astype(np.uint8)[..., :3]


def main(argv=None):
    """Returns the tile names, the tiled image, the path written and the env."""
    args = parse_args(argv)
    from .. import envs  # noqa: F401 (registers the tasks)
    from ..utils import common
    from ..utils.registration import make
    from ..utils.visualization import save_image, tile_images

    sensor_configs = dict(shader_pack=args.shader)
    if args.cam_width:
        sensor_configs["width"] = args.cam_width
    if args.cam_height:
        sensor_configs["height"] = args.cam_height
    env = make(args.env_id, num_envs=args.num_envs, obs_mode=args.obs_mode, sensor_configs=sensor_configs,
               device=args.device)
    obs, _ = env.reset(seed=args.seed)
    obs = common.to_numpy(obs)
    tiles, names = [], []
    for cam, textures in sorted(obs.get("sensor_data", {}).items()):
        for name, img in sorted(textures.items()):
            tiles.append(to_rgb8(name, np.asarray(img[0])))
            names.append(f"{cam}/{name}")
    env.close()
    print("textures:", ", ".join(names))
    tiled = tile_images(np.stack(tiles))
    path = save_image(args.out, tiled)
    print(f"saved {path} ({tiled.shape})")
    return dict(names=names, tiled=tiled, path=path, env=env)


if __name__ == "__main__":
    main()
