"""Skeleton alignment: the target pose scaled and moved to the source
person's place on the screen (port of motioneditor_tpu/prep/alignment.py;
the reference's data_preparation/alignment.py:51-161).

For each frame:

  1. the person's box in the source and in the target mask
  2. the target pose's box cropped and resized to the source box's height,
     at the target's aspect ratio (shrunk by 0.85 when it would overflow
     both sides, :113-119)
  3. pasted bottom-aligned at the source box on a blank canvas
  4. moved so that the pasted box's bottom centre lands on the target's
     (:155-160)

The resizes are PIL's bilinear resample (``pil_bilinear_resize``, a numpy
copy of its fixed-point arithmetic), so aligning frames needs no PIL; only
``align_sequence``'s PNG files do.

    python -m motioneditor_tpu_torch.prep.alignment --source_mask_path ... \\
        --target_mask_path ... --source_pose_path ... --target_pose_path ... \\
        --save_path ... [--num_frames 24]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Sequence, Tuple

import numpy as np

_PRECISION_BITS = 32 - 8 - 2  # PIL's Resample.c, 8 bits per channel


def find_person_boundaries(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) of the pixels >= 0.5 (alignment.py:37-48);
    the whole frame when there are none."""
    ys, xs = np.nonzero(mask >= 0.5)
    if len(xs) == 0:
        return 0, mask.shape[1] - 1, 0, mask.shape[0] - 1
    return int(xs.min()), int(xs.max()), int(ys.min()), int(ys.max())


def _bilinear_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] int64 fixed-point weights of PIL's bilinear
    resample along one axis (Resample.c precompute_coeffs and
    normalize_coeffs_8bpc): the triangle filter widened by the scale when
    reducing, taps from trunc(center - support + 0.5) to trunc(center +
    support + 0.5), normalized in double, rounded to 22 fraction bits."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    coeffs = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        x = np.arange(xmin, xmax)
        w = np.maximum(1.0 - np.abs((x - center + 0.5) / filterscale), 0.0)
        ww = w.sum()
        if ww != 0.0:
            w = w / ww
        coeffs[xx, xmin:xmax] = np.floor(0.5 + w * (1 << _PRECISION_BITS)).astype(np.int64)
    return coeffs


def _resample_axis(img: np.ndarray, coeffs: np.ndarray, axis: int) -> np.ndarray:
    acc = np.tensordot(np.moveaxis(img.astype(np.int64), axis, 0), coeffs, axes=([0], [1]))
    acc = np.moveaxis(acc, -1, 0) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_bilinear_resize(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """``np.asarray(Image.fromarray(img).resize(size_wh, Image.BILINEAR))`` for
    a uint8 [H, W] or [H, W, C] image, without PIL: the horizontal pass
    first, each pass rounded to uint8, an axis whose size stays untouched."""
    w, h = size_wh
    img = np.asarray(img, np.uint8)
    if img.shape[1] != w:
        img = _resample_axis(img, _bilinear_coeffs(img.shape[1], w), 1)
    if img.shape[0] != h:
        img = _resample_axis(img, _bilinear_coeffs(img.shape[0], h), 0)
    return img


def align_pose_frame(source_mask: np.ndarray, target_mask: np.ndarray,
                     target_pose: np.ndarray,
                     canvas_hw: Tuple[int, int] = (512, 512)) -> np.ndarray:
    """One target pose frame aligned to the source person's position."""
    h_c, w_c = canvas_hw
    if target_pose.shape[:2] != canvas_hw:
        target_pose = pil_bilinear_resize(target_pose, (w_c, h_c))

    s_left, s_right, s_top, s_bottom = find_person_boundaries(source_mask)
    t_left, t_right, t_top, t_bottom = find_person_boundaries(target_mask)
    target_point = ((t_left + t_right) / 2.0, float(t_bottom))

    x1, y1 = s_left, s_top
    w1, h1 = s_right - s_left, s_bottom - s_top
    x2, y2 = t_left, t_top
    w2, h2 = t_right - t_left, t_bottom - t_top
    w1, h1, w2, h2 = max(w1, 1), max(h1, 1), max(w2, 1), max(h2, 1)

    roi = target_pose[y2:y2 + h2, x2:x2 + w2]
    ratio = w2 / float(h2)
    w_new = round(ratio * h1)
    if x1 - (w_new - w1) < 0 and x1 + w_new > w_c:
        w_new = round(w_new * 0.85)
    w_new = max(w_new, 1)
    roi_resized = pil_bilinear_resize(roi, (w_new, h1))

    aligned = np.zeros_like(target_pose)
    if w_new > w1 and x1 - (w_new - w1) > 0:
        x_paste = x1 - (w_new - w1)
    else:
        x_paste = x1
    x_hi = min(x_paste + w_new, w_c)
    aligned[y1:y1 + h1, x_paste:x_hi] = roi_resized[:, :x_hi - x_paste]
    aligned_point = ((x_paste + x_paste + w_new) / 2.0, float(h1 + y1))

    dx = int(round(target_point[0] - aligned_point[0]))
    dy = int(round(target_point[1] - aligned_point[1]))

    out = np.zeros_like(aligned)
    src_y = slice(max(0, -dy), min(h_c, h_c - dy))
    src_x = slice(max(0, -dx), min(w_c, w_c - dx))
    dst_y = slice(max(0, dy), max(0, dy) + (src_y.stop - src_y.start))
    dst_x = slice(max(0, dx), max(0, dx) + (src_x.stop - src_x.start))
    out[dst_y, dst_x] = aligned[src_y, src_x]
    return out


def align_frames(source_masks: Sequence[np.ndarray], target_masks: Sequence[np.ndarray],
                 target_poses: Sequence[np.ndarray],
                 canvas_hw: Tuple[int, int] = (512, 512)) -> np.ndarray:
    """``align_pose_frame`` over a clip: masks [F, H, W] in [0, 1], poses
    [F, h, w, 3] uint8 -> [F, H_c, W_c, 3]."""
    return np.stack([align_pose_frame(sm, tm, tp, canvas_hw)
                     for sm, tm, tp in zip(source_masks, target_masks, target_poses)])


def align_sequence(source_mask_dir: str, target_mask_dir: str, source_pose_dir: str,
                   target_pose_dir: str, save_dir: str, num_frames: int = 24,
                   frame_pattern: str = "frame_{}.png") -> None:
    """The CLI's work on PNG directories (read and written through PIL)."""
    from PIL import Image

    def read(d, name, mode):
        return np.asarray(Image.open(osp.join(d, name)).convert(mode))

    os.makedirs(save_dir, exist_ok=True)
    for i in range(num_frames):
        name = frame_pattern.format(i)
        sm = read(source_mask_dir, name, "L").astype(np.float32) / 255.0
        tm = read(target_mask_dir, name, "L").astype(np.float32) / 255.0
        out = align_pose_frame(sm, tm, read(target_pose_dir, name, "RGB"))
        Image.fromarray(out.astype(np.uint8)).save(osp.join(save_dir, name))


def main(argv=None):
    p = argparse.ArgumentParser("Alignment", add_help=True)
    p.add_argument("--source_mask_path", type=str, required=True)
    p.add_argument("--target_mask_path", type=str, required=True)
    p.add_argument("--source_pose_path", type=str, required=True)
    p.add_argument("--target_pose_path", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--num_frames", type=int, default=24)
    args = p.parse_args(argv)
    align_sequence(args.source_mask_path, args.target_mask_path, args.source_pose_path,
                   args.target_pose_path, args.save_path, num_frames=args.num_frames)


if __name__ == "__main__":
    main()
