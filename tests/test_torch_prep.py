"""The port's data-preparation CLIs (prep/alignment.py, prep/skeletons.py)
against the JAX package's, on the CPU.

- ``pil_bilinear_resize`` equals PIL's ``Image.resize(..., BILINEAR)``
  exactly (the alignment's resizes, with no PIL on the GPU host).
- ``align_pose_frame`` and ``align_sequence`` (and the alignment CLI)
  equal JAX's exactly, on synthetic masks and poses, with the pose at the
  canvas size and not.
- The skeletons CLI on generated PNGs with a random ``body_pose_model.pth``
  (and with a random DPT-Hybrid for ``--condition depth``) writes the same
  PNGs as JAX's CLI (a random body network finds no person, so those PNGs
  hold no skeleton: tests/test_torch_openpose.py draws one through a
  stand-in network); it refuses to run without a GPU unless ``--device cpu``
  is given, and without a model file it asks for controlnet_aux.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from motioneditor_tpu.models import midas as JM
from motioneditor_tpu.models import openpose as JO
from motioneditor_tpu.prep import alignment as JA
from motioneditor_tpu.prep import skeletons as JS

from motioneditor_tpu_torch.models.from_jax import dpt_state_dict, openpose_body_state_dict
from motioneditor_tpu_torch.prep import alignment as TA
from motioneditor_tpu_torch.prep import skeletons as TS

from torch_port_helpers import random_params, setup_torch


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


@pytest.mark.parametrize("seed", range(6))
def test_pil_bilinear_resize_equals_pil(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        nh, nw = (int(v) for v in rng.integers(1, 120, 2))
        shape = (h, w, 3) if seed % 2 else (h, w)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        ref = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
        np.testing.assert_array_equal(TA.pil_bilinear_resize(img, (nw, nh)), ref)


def _case(rng, hw=(64, 64), pose_hw=None):
    """Source and target masks with one box each and a target pose image."""
    h, w = hw

    def box_mask():
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        y1, x1 = y0 + rng.integers(4, h // 2), x0 + rng.integers(4, w // 2)
        m = np.zeros(hw, np.float32)
        m[y0:y1, x0:x1] = 1.0
        return m

    pose = rng.integers(0, 256, (pose_hw or hw) + (3,), dtype=np.uint8)
    return box_mask(), box_mask(), pose


@pytest.mark.parametrize("seed", range(8))
def test_align_pose_frame_equals_jax(seed):
    rng = np.random.default_rng(100 + seed)
    pose_hw = (48, 80) if seed % 2 else None  # a pose frame of another size is resized first
    sm, tm, pose = _case(rng, pose_hw=pose_hw)
    got = TA.align_pose_frame(sm, tm, pose, canvas_hw=(64, 64))
    ref = JA.align_pose_frame(sm, tm, pose, canvas_hw=(64, 64))
    assert got.shape == (64, 64, 3) and got.any()
    np.testing.assert_array_equal(got, ref)


def _write_alignment_dirs(root, n=3, size=512):
    rng = np.random.default_rng(7)
    dirs = {k: root / k for k in ("sm", "tm", "sp", "tp")}
    for d in dirs.values():
        d.mkdir(parents=True)
    for i in range(n):
        sm, tm, pose = _case(rng, (size, size))
        name = f"frame_{i}.png"
        Image.fromarray((sm * 255).astype(np.uint8)).save(dirs["sm"] / name)
        Image.fromarray((tm * 255).astype(np.uint8)).save(dirs["tm"] / name)
        Image.fromarray(pose).save(dirs["sp"] / name)
        Image.fromarray(pose).save(dirs["tp"] / name)
    return {k: str(v) for k, v in dirs.items()}


def test_align_sequence_and_cli_equal_jax(tmp_path):
    d = _write_alignment_dirs(tmp_path)
    TA.align_sequence(d["sm"], d["tm"], d["sp"], d["tp"], str(tmp_path / "port"), num_frames=3)
    JA.align_sequence(d["sm"], d["tm"], d["sp"], d["tp"], str(tmp_path / "jax"), num_frames=3)
    TA.main(["--source_mask_path", d["sm"], "--target_mask_path", d["tm"], "--source_pose_path",
             d["sp"], "--target_pose_path", d["tp"], "--save_path", str(tmp_path / "cli"),
             "--num_frames", "3"])
    for i in range(3):
        ref = np.asarray(Image.open(tmp_path / "jax" / f"frame_{i}.png"))
        assert ref.any()
        for out in ("port", "cli"):
            np.testing.assert_array_equal(
                np.asarray(Image.open(tmp_path / out / f"frame_{i}.png")), ref)
    # the array form (no PIL) gives the same frames
    def read(k, i, mode):
        return np.asarray(Image.open(os.path.join(d[k], f"frame_{i}.png")).convert(mode))

    frames = TA.align_frames([read("sm", i, "L") / np.float32(255.0) for i in range(3)],
                             [read("tm", i, "L") / np.float32(255.0) for i in range(3)],
                             [read("tp", i, "RGB") for i in range(3)])
    for i in range(3):
        np.testing.assert_array_equal(
            frames[i], np.asarray(Image.open(tmp_path / "jax" / f"frame_{i}.png")))


def _frames(root, n=2, size=64):
    root.mkdir()
    rng = np.random.default_rng(9)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            root / f"{i:05d}.png")
    return str(root)


def _run_both(monkeypatch, tmp_path, args):
    TS.main(args + ["--save_dir", str(tmp_path / "port"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["skeletons.py"] + args
                        + ["--save_dir", str(tmp_path / "jax")])
    JS.main()


def _assert_same_pngs(tmp_path, condition, n):
    for i in range(n):
        name = f"{condition}/{i:05d}.png"
        got = np.asarray(Image.open(tmp_path / "port" / name))
        ref = np.asarray(Image.open(tmp_path / "jax" / name))
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_skeletons_cli_body_equals_jax(tmp_path, monkeypatch):
    tree = random_params(lambda: JO.init_body_params(jax.random.PRNGKey(0)), seed=15)
    stripped = {k.split(".", 1)[1]: v for k, v in openpose_body_state_dict(tree).items()}
    torch.save(stripped, tmp_path / "body_pose_model.pth")
    data = _frames(tmp_path / "frames")
    _run_both(monkeypatch, tmp_path, ["--data", data, "--body_model",
                                      str(tmp_path / "body_pose_model.pth")])
    _assert_same_pngs(tmp_path, "openposefull", 2)


def test_skeletons_cli_depth_equals_jax(tmp_path, monkeypatch):
    """``--condition depth`` on 64 x 64 frames; each gray level at most 1
    from JAX's (estimate_depth's limit, tests/test_torch_midas.py)."""
    tree = random_params(lambda: JM.init_dpt_params(jax.random.PRNGKey(0)), seed=11)
    torch.save(dpt_state_dict(tree), tmp_path / "dpt.pt")
    data = _frames(tmp_path / "frames")
    _run_both(monkeypatch, tmp_path, ["--data", data, "--condition", "depth", "--depth_model",
                                      str(tmp_path / "dpt.pt")])
    for i in range(2):
        got = np.asarray(Image.open(tmp_path / "port" / "depth" / f"{i:05d}.png")).astype(int)
        ref = np.asarray(Image.open(tmp_path / "jax" / "depth" / f"{i:05d}.png")).astype(int)
        assert got.shape == ref.shape == (64, 64, 3) and ref.max() > ref.min()
        assert np.abs(got - ref).max() <= 1


def test_skeletons_cli_refusals(tmp_path, monkeypatch):
    data = _frames(tmp_path / "frames", n=1)
    torch.save({}, tmp_path / "empty.pth")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        TS.main(["--data", data, "--save_dir", str(tmp_path / "o"), "--body_model",
                 str(tmp_path / "empty.pth")])
    with pytest.raises(SystemExit, match="controlnet_aux"):
        TS.main(["--data", data, "--save_dir", str(tmp_path / "o")])
    with pytest.raises(SystemExit, match="openpose condition"):
        TS.main(["--data", data, "--save_dir", str(tmp_path / "o"), "--condition", "depth",
                 "--body_model", str(tmp_path / "empty.pth")])
