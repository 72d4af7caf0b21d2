"""VideoDataset, the host-side loader for the data/case-N layout (a copy of
motioneditor_tpu/data/dataset.py for the port). Frames are decoded and
resized through the host frame loader (data/native_loader.py) as JAX's
default path does; where it cannot be built, through PIL and
``F.interpolate``, which resize alike (bilinear, align_corners=False, no
antialias; masks nearest). ``decoder`` records which ran for the last
item: "native" or "pil". PIL is imported only on that path. Produces
channel-last numpy arrays:

  pixel_values      [F, H, W, 3] in [-1, 1]   (bilinear resize)
  source_conditions {cond: [F, H, W, 3] in [0, 1]}
  target_conditions {cond: [F, H, W, 3] in [0, 1]}
  source_masks      [F, H, W] in {0, 1}       (nearest resize)
  sample_indices    [F] int

Directory layout: video_dir/images, video_dir/source_condition/<cond>,
video_dir/target_condition/<cond>, video_dir/<source_mask_dir>, with a
cached frame_list.txt.
"""

from __future__ import annotations

import os.path as osp
import random
from glob import glob
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from motioneditor_tpu_torch.data import native_loader as nl


def _bilinear_resize(img: np.ndarray, size) -> np.ndarray:
    """Bilinear resize of an [H, W, C] float image with align_corners=False
    and no antialias (the reference's F.interpolate and the frame loader's
    resize; PIL's BILINEAR antialiases when it shrinks), fp32 on the CPU."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).numpy()


def _nearest_resize(img: np.ndarray, size) -> np.ndarray:
    """Nearest resize selecting source row floor(y * H / h), in integers as
    the frame loader does."""
    h, w = size
    rows = np.arange(h) * img.shape[0] // h
    cols = np.arange(w) * img.shape[1] // w
    return img[rows][:, cols]


def _read_image(path: str, mode: str = "RGB") -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert(mode), np.float32)


class VideoDataset:
    """One-video dataset (``len`` 1)."""

    def __init__(
        self,
        video_dir: str,
        prompt: str,
        width: int = 512,
        height: int = 512,
        n_sample_frames: int = 8,
        sample_start_idx: int = 0,
        sample_frame_rate: int = 1,
        condition: Sequence[str] = ("openposefull",),
        video_suffix: str = ".png",
        condition_suffix: str = ".png",
        random_sample: bool = False,
        source_mask_dir: Optional[str] = None,
        **_: object,
    ):
        self.video_dir = video_dir
        self.video_path = osp.join(video_dir, "images")
        if isinstance(condition, str):
            condition = [condition]
        self.condition = list(condition)
        self.source_condition_path = {
            c: osp.join(video_dir, "source_condition", c) for c in self.condition
        }
        self.target_condition_path = {
            c: osp.join(video_dir, "target_condition", c) for c in self.condition
        }
        self.video_suffix = video_suffix
        self.condition_suffix = condition_suffix
        self.random_sample = random_sample
        self.source_mask_dir = osp.join(video_dir, source_mask_dir) if source_mask_dir else None

        frame_list_path = osp.join(video_dir, "frame_list.txt")
        if not osp.isfile(frame_list_path):
            all_frames = sorted(glob(osp.join(self.video_path, "*")))
            self.frame_list = [osp.basename(p).split(".")[0] for p in all_frames]
            try:
                with open(frame_list_path, "w") as f:
                    f.write("\n".join(self.frame_list) + "\n")
            except OSError:
                pass  # read-only dataset dir
        else:
            with open(frame_list_path) as f:
                self.frame_list = f.read().splitlines()

        self.video_length = len(self.frame_list)
        self.prompt = prompt
        self.width = width
        self.height = height
        self.n_sample_frames = n_sample_frames
        self.sample_start_idx = sample_start_idx
        self.sample_frame_rate = sample_frame_rate
        self.decoder: Optional[str] = None  # "native" or "pil", set by __getitem__

    def __len__(self) -> int:
        return 1

    def __getitem__(self, index: int) -> Dict[str, object]:
        video_indices = list(range(self.sample_start_idx, self.video_length,
                                   self.sample_frame_rate))
        start = (random.randint(0, len(video_indices) - self.n_sample_frames)
                 if self.random_sample else 0)
        sample_index = video_indices[start:start + self.n_sample_frames]
        names = [self.frame_list[fi] for fi in sample_index]
        size = (self.height, self.width)
        decoders = set()

        def load(paths, mode=nl.MODE_RGB_BILINEAR):
            arr = nl.load_frames(paths, *size, mode=mode) if nl.available() else None
            decoders.add("pil" if arr is None else "native")
            if arr is not None:
                return arr
            if mode == nl.MODE_GRAY_NEAREST:
                return np.stack([_nearest_resize(_read_image(p, "L"), size)[..., None]
                                 for p in paths])
            return np.stack([_bilinear_resize(_read_image(p), size) for p in paths])

        frames = load([osp.join(self.video_path, n + self.video_suffix) for n in names])
        if self.source_mask_dir:
            masks = load([osp.join(self.source_mask_dir, n + ".png") for n in names],
                         nl.MODE_GRAY_NEAREST)[..., 0] / 255.0
        else:
            masks = np.ones((len(names),) + size, np.float32)

        def load_conditions(dirs):
            return {c: load([osp.join(dirs[c], n + self.condition_suffix) for n in names])
                    / 255.0 for c in self.condition}

        source_conditions = load_conditions(self.source_condition_path)
        target_conditions = load_conditions(self.target_condition_path)
        self.decoder = "pil" if "pil" in decoders else "native"
        return {
            "pixel_values": frames / 127.5 - 1.0,
            "source_conditions": source_conditions,
            "target_conditions": target_conditions,
            "source_masks": masks,
            "sample_indices": np.asarray(sample_index, np.int64),
            "prompt": self.prompt,
        }
