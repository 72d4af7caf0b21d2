"""The port's VideoDataset against the JAX package's where the frames are
resized (ROADMAP C9): seeded noise PNGs of three sizes, none of them the
target size, read at two target sizes.

JAX's default path decodes and resizes through its native frame loader
(bilinear, align_corners=False, no antialias, as the reference's
F.interpolate; masks nearest). The port must give the same arrays: within
1e-5 on pixel_values ([-1, 1]) and on the conditions ([0, 1]), masks equal.
Before the fix the port resized with PIL's antialiasing bilinear and was
~0.98 off on pixel_values when shrinking 360x640 frames.
"""

import os

import numpy as np
import pytest

from motioneditor_tpu.data import native_loader as jax_native_loader
from motioneditor_tpu.data.dataset import VideoDataset as JaxVideoDataset

from motioneditor_tpu_torch.data.dataset import VideoDataset

FRAMES = 2
SOURCE_SIZES = ((72, 120), (48, 40), (360, 640))  # (H, W) of the PNGs on disk
TARGET_SIZES = ((64, 64), (64, 96))


def write_clip(root, size, seed: int) -> str:
    """A data/case-N layout of seeded noise frames, conditions and binary
    masks at ``size``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = size
    dirs = {"images": "images", "src": "source_condition/openposefull",
            "tgt": "target_condition/openposefull", "mask": "man.mask"}
    for d in dirs.values():
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(FRAMES):
        name = f"{i:05d}.png"
        for key in ("images", "src", "tgt"):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                os.path.join(root, dirs[key], name))
        mask = (rng.random((h, w)) > 0.5).astype(np.uint8) * 255
        Image.fromarray(mask, "L").save(os.path.join(root, dirs["mask"], name))
    return str(root)


@pytest.mark.parametrize("target", TARGET_SIZES, ids=lambda s: f"to{s[0]}x{s[1]}")
@pytest.mark.parametrize("source", SOURCE_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dataset_resize_matches_jax(tmp_path, source, target):
    if not jax_native_loader.available():
        pytest.skip("the JAX package's native frame loader (native/libframeloader.so) "
                    "does not load here, so JAX's default resize cannot run")
    clip = write_clip(tmp_path, source, seed=source[0] * 1000 + source[1])
    kw = dict(video_dir=clip, prompt="p", height=target[0], width=target[1],
              n_sample_frames=FRAMES, source_mask_dir="man.mask")
    got, ref = VideoDataset(**kw)[0], JaxVideoDataset(**kw)[0]
    assert got["pixel_values"].shape == (FRAMES, *target, 3)
    np.testing.assert_allclose(got["pixel_values"], ref["pixel_values"], atol=1e-5, rtol=0)
    for key in ("source_conditions", "target_conditions"):
        np.testing.assert_allclose(got[key]["openposefull"], ref[key]["openposefull"],
                                   atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["source_masks"], ref["source_masks"])
    np.testing.assert_array_equal(got["sample_indices"], ref["sample_indices"])
