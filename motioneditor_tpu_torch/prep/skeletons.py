"""Skeleton and depth extraction CLI (port of motioneditor_tpu/prep/skeletons.py;
the reference's data_preparation/video_skeletons.py):

    python -m motioneditor_tpu_torch.prep.skeletons --data <frames dir> \\
        --save_dir <dir> [--condition openposefull] \\
        [--body_model body_pose_model.pth [--hand_model hand_pose_model.pth] \\
         [--face_model facenet.pth]] [--depth_model dpt_hybrid-midas-501f0c75.pt] \\
        [--device cuda|cpu]

writes ``<save_dir>/<condition>/<frame>.png`` for every frame. The
reference calls ``cond_model(image, hand_and_face=False)`` (:78): its
``openposefull`` conditions are body-only skeletons.

Backends:
  - ``--body_model``: this package's OpenPose networks
    (models/openpose.py) on the device, decoding and drawing on the host;
    ``--hand_model`` / ``--face_model`` add the hand and face overlays.
  - ``--depth_model``: this package's MiDaS DPT-Hybrid (models/midas.py)
    for ``--condition depth``.
  - otherwise controlnet_aux's OpenposeDetector / MidasDetector, imported
    only then.

The networks run on the GPU unless ``--device cpu`` asks for the CPU;
without a CUDA device and without that flag it raises. Frames are read and
written through PIL; the detectors take and return arrays.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from glob import glob

import numpy as np


def build_detector(kind: str):
    """controlnet_aux's detector for ``kind`` (arrays or PIL images in)."""
    try:
        if kind in ("openpose", "openposefull"):
            from controlnet_aux import OpenposeDetector

            det = OpenposeDetector.from_pretrained("lllyasviel/Annotators")
            # the reference's openposefull path is hand_and_face=False
            # (video_skeletons.py:78): body only, like plain openpose
            return lambda img: det(img, hand_and_face=False)
        if kind == "depth":
            from controlnet_aux import MidasDetector

            return MidasDetector.from_pretrained("lllyasviel/Annotators")
    except ImportError as e:
        raise SystemExit(
            f"skeleton extraction needs controlnet_aux ({e}); either pass "
            "--body_model <body_pose_model.pth> to use this package's "
            "OpenPose networks, or produce condition PNGs with any OpenPose "
            "implementation — the pipeline only needs the rendered images."
        )
    raise SystemExit(f"unknown condition type {kind}")


def build_native_detector(body_model: str, hand_model: str = None, face_model: str = None,
                          device="cuda"):
    """uint8 RGB [H, W, 3] -> skeleton image, through this package's
    OpenPose networks on ``device`` (the card unless the caller asks for the
    CPU; resolved before any file is read)."""
    from motioneditor_tpu_torch.inference import resolve_device

    device = resolve_device(device)
    from motioneditor_tpu_torch.models.openpose import (
        load_body_params,
        load_face_params,
        load_hand_params,
        render_skeleton_full,
    )

    body = load_body_params(body_model, device)
    hand = load_hand_params(hand_model, device) if hand_model else None
    face = load_face_params(face_model, device) if face_model else None
    return lambda img: render_skeleton_full(body, np.asarray(img, np.uint8), hand_model=hand,
                                            face_model=face)


def build_native_depth_detector(depth_model: str, device="cuda"):
    """uint8 RGB [H, W, 3] -> depth image, through this package's MiDaS on
    ``device`` (the card unless the caller asks for the CPU; resolved before
    any file is read)."""
    from motioneditor_tpu_torch.inference import resolve_device

    device = resolve_device(device)
    from motioneditor_tpu_torch.models.midas import estimate_depth, load_dpt_params

    model = load_dpt_params(depth_model, device)
    return lambda img: estimate_depth(model, np.asarray(img, np.uint8))


def main(argv=None):
    from PIL import Image

    from motioneditor_tpu_torch.inference import resolve_device

    p = argparse.ArgumentParser("Video skeletons")
    p.add_argument("--data", type=str, required=True, help="frames dir")
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--condition", type=str, default="openposefull")
    p.add_argument("--body_model", type=str, default=None,
                   help="pytorch-openpose body_pose_model.pth: this package's OpenPose")
    p.add_argument("--hand_model", type=str, default=None,
                   help="hand_pose_model.pth: overlay hand keypoints (the reference runs "
                   "body-only; see the module docstring)")
    p.add_argument("--face_model", type=str, default=None,
                   help="facenet.pth: overlay face landmarks")
    p.add_argument("--depth_model", type=str, default=None,
                   help="dpt_hybrid-midas-501f0c75.pt: this package's MiDaS")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.body_model:
        if args.condition not in ("openpose", "openposefull"):
            raise SystemExit("--body_model implies an openpose condition")
        det = build_native_detector(args.body_model, args.hand_model, args.face_model,
                                    resolve_device(args.device))
    elif args.depth_model:
        if args.condition != "depth":
            raise SystemExit("--depth_model implies --condition depth")
        det = build_native_depth_detector(args.depth_model, resolve_device(args.device))
    else:
        det = build_detector(args.condition)
    out_dir = osp.join(args.save_dir, args.condition)
    os.makedirs(out_dir, exist_ok=True)
    for path in sorted(glob(osp.join(args.data, "*"))):
        name = osp.splitext(osp.basename(path))[0]
        skel = det(np.asarray(Image.open(path).convert("RGB"), np.uint8))
        if isinstance(skel, np.ndarray):
            skel = Image.fromarray(skel)
        skel.save(osp.join(out_dir, name + ".png"))
        print(f"wrote {name}.png")


if __name__ == "__main__":
    main()
