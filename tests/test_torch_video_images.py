"""``save_videos_as_images`` of the port (utils/video.py) against JAX's
(motioneditor_tpu/utils/video.py, the reference's util.py:15-31): the same
seeded video, with and without ``rescale``, writes the same file names
with the same PNG pixels."""

import os

import numpy as np
import pytest
from PIL import Image

from motioneditor_tpu.utils.video import save_videos_as_images as jax_save
from motioneditor_tpu_torch.utils.video import save_videos_as_images


def _pngs(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            out[os.path.relpath(path, root)] = np.asarray(Image.open(path))
    return out


@pytest.mark.parametrize("rescale", [False, True])
def test_save_videos_as_images_matches_jax(tmp_path, rescale):
    rng = np.random.default_rng(81)
    video = rng.uniform(-1.0 if rescale else -0.1, 1.1, (2, 3, 8, 6, 3)).astype(np.float32)
    jax_save(video, str(tmp_path / "jax"), rescale=rescale)
    save_videos_as_images(video, str(tmp_path / "port"), rescale=rescale)
    ref, got = _pngs(tmp_path / "jax"), _pngs(tmp_path / "port")
    assert sorted(got) == sorted(ref) and len(got) == 6
    assert "vis_images/batch_1/frame_2.png" in got
    for name, img in ref.items():
        assert img.shape == (8, 6, 3) and np.array_equal(got[name], img), name
