"""Segmentation visualization CLI (counterpart of
maniskill_tpu/examples/demo_vis_segmentation.py): saves the first camera's
rgb beside its colour-mapped segmentation (a PNG where Pillow is installed,
else .npy) and prints the id-to-object legend. Runs on the card unless
``--device cpu`` is given."""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    """Returns the legend (id -> name), the rgb, the segmentation, the path
    written and the env."""
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--env-id", default="PushCube-v1")
    p.add_argument("-o", "--out", default="seg.png")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .. import envs  # noqa: F401 (registers the tasks)
    from ..utils.registration import make
    from ..utils.visualization import save_image

    env = make(args.env_id, num_envs=1, obs_mode="rgb+segmentation", device=args.device)
    obs, _ = env.reset(seed=0)
    base = env.unwrapped
    legend = {}
    print("segmentation id map:")
    for name, actor in base.scene.actors.items():
        legend[actor.per_scene_id] = f"actor {name}"
        print(f"  {actor.per_scene_id}: actor {name}")
    for aname, art in base.scene.articulations.items():
        for link in art.links:
            legend[link.per_scene_id] = f"link {aname}/{link.name}"
            print(f"  {link.per_scene_id}: link {aname}/{link.name}")

    cam = next(iter(obs["sensor_data"]))
    seg = obs["sensor_data"][cam]["segmentation"][0, ..., 0].cpu().numpy()
    rgb = obs["sensor_data"][cam]["rgb"][0].cpu().numpy()
    n = max(int(seg.max()), 1)
    palette = np.random.RandomState(0).randint(0, 255, size=(n + 1, 3), dtype=np.uint8)
    palette[0] = 0
    path = save_image(args.out, np.concatenate([rgb, palette[seg]], axis=1))
    print("wrote", path)
    env.close()
    return dict(legend=legend, rgb=rgb, seg=seg, path=path, env=env)


if __name__ == "__main__":
    main()
