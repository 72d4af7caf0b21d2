"""The port's host frame loader (data/native_loader.py, built from
csrc/frame_loader.cc) against the JAX package's checked-in library, and the
port's VideoDataset with and without it.

The library tests skip only where it cannot be built here: no host C++
compiler, or no png.h / jpeglib.h (``native_loader.missing()``).
"""

import os

import numpy as np
import pytest

from motioneditor_tpu.data import native_loader as jax_nl

from motioneditor_tpu_torch.data import dataset as port_dataset
from motioneditor_tpu_torch.data import native_loader as nl
from motioneditor_tpu_torch.data.dataset import VideoDataset

from test_torch_dataset_resize import write_clip

SIZES = ((72, 120), (48, 40), (360, 640))
TARGET = (64, 96)


@pytest.fixture(scope="module")
def port_library():
    reason = nl.missing()
    if reason:
        pytest.skip(f"the frame loader cannot be built here: {reason}")
    assert nl.available(), nl.build_error()
    if not jax_nl.available():
        pytest.skip("the JAX package's native/libframeloader.so does not load here")


def write_frames(root, size, seed: int, jpeg: bool = False):
    from PIL import Image

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(3):
        path = os.path.join(root, f"{i}.{'jpg' if jpeg else 'png'}")
        rgb = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
        Image.fromarray(rgb).save(path, quality=90) if jpeg else Image.fromarray(rgb).save(path)
        paths.append(path)
    gray = os.path.join(root, "mask.png")
    Image.fromarray((rng.random(size) > 0.5).astype(np.uint8) * 255, "L").save(gray)
    return paths + [gray]


@pytest.mark.parametrize("mode", [nl.MODE_RGB_BILINEAR, nl.MODE_GRAY_NEAREST],
                         ids=["rgb_bilinear", "gray_nearest"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_library_matches_jax_bitwise(port_library, tmp_path, size, mode):
    paths = write_frames(tmp_path, size, seed=size[0] + 7 * size[1])
    for target in (TARGET, (512, 512)):
        got = nl.load_frames(paths, *target, mode=mode)
        ref = jax_nl.load_frames(paths, *target, mode=mode)
        assert got is not None and ref is not None
        assert got.shape == (len(paths), *target, 1 if mode == nl.MODE_GRAY_NEAREST else 3)
        np.testing.assert_array_equal(got, ref)


def test_library_decodes_jpeg_as_jax(port_library, tmp_path):
    paths = write_frames(tmp_path, (72, 120), seed=5, jpeg=True)[:-1]
    got = nl.load_frames(paths, *TARGET)
    np.testing.assert_array_equal(got, jax_nl.load_frames(paths, *TARGET))


def test_library_refuses_a_missing_frame(port_library, tmp_path):
    paths = write_frames(tmp_path, (48, 40), seed=6)
    assert nl.load_frames(paths + [str(tmp_path / "absent.png")], *TARGET) is None


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dataset_with_and_without_the_library(port_library, tmp_path, monkeypatch, size):
    """The PIL + F.interpolate path gives the library's values within 1e-5
    (pixel_values in [-1, 1], conditions in [0, 1]; masks equal), and the
    dataset records which decoder ran."""
    kw = dict(video_dir=write_clip(tmp_path, size, seed=size[1]), prompt="p", height=TARGET[0],
              width=TARGET[1], n_sample_frames=2, source_mask_dir="man.mask")
    ds = VideoDataset(**kw)
    native = ds[0]
    assert ds.decoder == "native"
    monkeypatch.setattr(port_dataset.nl, "available", lambda: False)
    plain = ds[0]
    assert ds.decoder == "pil"
    np.testing.assert_allclose(plain["pixel_values"], native["pixel_values"], atol=1e-5, rtol=0)
    for key in ("source_conditions", "target_conditions"):
        np.testing.assert_allclose(plain[key]["openposefull"], native[key]["openposefull"],
                                   atol=1e-5, rtol=0)
    np.testing.assert_array_equal(plain["source_masks"], native["source_masks"])
    assert plain["pixel_values"].dtype == native["pixel_values"].dtype == np.float32
