"""Video grid saving, GIF + MP4, and per-frame PNG dumps (a copy of
motioneditor_tpu/utils/video.py's ``save_videos_grid`` and
``save_videos_as_images`` for the port), on channel-last numpy video
tensors [B, F, H, W, 3] in [0, 1]. ``imageio`` and PIL are imported when a
file is written.
"""

from __future__ import annotations

import math
import os
import os.path as osp
import warnings

import numpy as np


def _make_grid(frames: np.ndarray, n_rows: int = 4) -> np.ndarray:
    """[B, H, W, 3] -> one grid image, torchvision.make_grid-style (pad=2)."""
    b, h, w, c = frames.shape
    ncol = min(n_rows, b)
    nrow = math.ceil(b / ncol)
    pad = 2
    grid = np.zeros(
        (nrow * (h + pad) + pad, ncol * (w + pad) + pad, c), frames.dtype
    )
    for i in range(b):
        r, cidx = divmod(i, ncol)
        y = r * (h + pad) + pad
        x = cidx * (w + pad) + pad
        grid[y : y + h, x : x + w] = frames[i]
    return grid


def save_videos_grid(
    videos: np.ndarray, path: str, rescale: bool = False, n_rows: int = 4, fps: int = 8
) -> None:
    """videos: [B, F, H, W, 3]; writes a GIF at ``path`` and an MP4 sibling
    (util.py:34-54)."""
    import imageio

    videos = np.asarray(videos)
    if rescale:
        videos = (videos + 1.0) / 2.0
    frames = []
    for f in range(videos.shape[1]):
        grid = _make_grid(videos[:, f], n_rows=n_rows)
        frames.append((np.clip(grid, 0, 1) * 255).astype(np.uint8))
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    imageio.mimsave(path, frames, fps=fps)
    mp4 = path.replace(".gif", ".mp4") if path.endswith(".gif") else path + ".mp4"
    try:
        with imageio.get_writer(mp4, fps=fps) as w:
            for fr in frames:
                w.append_data(fr)
    except Exception as e:  # mp4 codec optional; GIF is the canonical artifact
        warnings.warn(f"MP4 writer failed for {mp4} ({e!r}); GIF was written")


def save_videos_as_images(videos: np.ndarray, path: str, rescale: bool = False) -> None:
    """videos: [B, F, H, W, 3]; writes frame f of row b as
    ``path/vis_images/batch_{b}/frame_{f}.png`` (util.py:15-31)."""
    from PIL import Image

    videos = np.asarray(videos)
    if rescale:
        videos = (videos + 1.0) / 2.0
    base = osp.join(path, "vis_images")
    for b in range(videos.shape[0]):
        d = osp.join(base, f"batch_{b}")
        os.makedirs(d, exist_ok=True)
        for f in range(videos.shape[1]):
            img = (np.clip(videos[b, f], 0, 1) * 255).astype(np.uint8)
            Image.fromarray(img).save(osp.join(d, f"frame_{f}.png"))
