"""Image and video helpers (counterpart of
maniskill_tpu/utils/visualization.py).

``images_to_video`` stores the frames as ``<name>.npz`` (key ``frames``,
(T, H, W, C) uint8). The JAX package encodes an mp4 with imageio and means
to fall back to the ``.npz`` where no video backend exists, but imports
imageio outside that fallback, so it raises where imageio is missing; the
port imports no video encoder (the card's machine has none) and always
writes the ``.npz``.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch


def tile_images(images, nrows: Optional[int] = None):
    """Tile (B, H, W, C) images (numpy or torch) into one grid, row-major,
    ``floor(sqrt(B))`` rows by default."""
    b, h, w, c = images.shape
    if nrows is None:
        nrows = int(np.floor(np.sqrt(b)))
    ncols = int(np.ceil(b / nrows))
    if isinstance(images, torch.Tensor):
        out = torch.zeros((nrows * h, ncols * w, c), dtype=images.dtype, device=images.device)
    else:
        images = np.asarray(images)
        out = np.zeros((nrows * h, ncols * w, c), images.dtype)
    for i in range(b):
        r, cc = divmod(i, ncols)
        out[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = images[i]
    return out


def images_to_video(images: List, output_dir: str, video_name: str, fps: int = 30, quality: Optional[float] = 5,
                    verbose: bool = False) -> str:
    """Write the frames to ``output_dir/video_name.npz`` (``frames``: (T, H,
    W, C) uint8, ``fps``); returns its path."""
    os.makedirs(output_dir, exist_ok=True)
    frames = [im.detach().cpu().numpy() if isinstance(im, torch.Tensor) else np.asarray(im) for im in images]
    path = os.path.join(output_dir, f"{video_name}.npz")
    np.savez_compressed(path, frames=np.stack(frames).astype(np.uint8), fps=fps)
    if verbose:
        print(f"wrote {len(frames)} frames to {path}")
    return path


def put_info_on_image(image, info: dict, extras=None, overlay=True):
    return image  # text overlay needs font rendering; the reference's is a no-op too


def save_image(path: str, image) -> str:
    """An (H, W, 3) uint8 image as a PNG at ``path`` where Pillow is
    installed, else as the array in a ``.npy`` beside it (same stem); returns
    the path written."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    image = np.asarray(image)
    try:
        from PIL import Image
    except ImportError:
        path = os.path.splitext(path)[0] + ".npy"
        np.save(path, image)
        return path
    Image.fromarray(image).save(path, format="PNG")
    return path
