"""Protagonist mask extraction CLI (port of motioneditor_tpu/prep/masks.py;
the reference's data_preparation/video_masks.py):

    python -m motioneditor_tpu_torch.prep.masks --data <frames dir> \\
        --save_dir <dir> --text_prompt person --dino_backend native \\
        --dino_ckpt groundingdino_swint_ogc.pth \\
        --bert_vocab bert-base-uncased-vocab.txt --sam_path sam_vit_h_4b8939.pth \\
        [--box_threshold 0.3] [--device cuda|cpu]

writes ``<save_dir>/<frame>.png`` for every frame: the reference runs
GroundedSAM, GroundingDINO's text-grounded boxes (:63-96), then SAM's
box-prompted mask of the best box by score (:234-253).

Backends:
  - ``--dino_backend native``: this package's GroundingDINO
    (models/grounding_dino.py) and, for an official ``sam_vit_*.pth``,
    this package's SAM (models/sam.py), on the device; the captions through
    this package's WordPiece tokenizer (prep/tokenizer.py). An HF SAM
    directory is accepted too, through ``transformers``.
  - ``--dino_backend transformers`` (the default, as in JAX): HF
    GroundingDINO and SAM directories through ``transformers``.

Every backend's networks run on the GPU unless ``--device cpu`` asks for
the CPU; without a CUDA device and without that flag it raises. Frames are
read, resized and written through PIL, imported where they are.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from glob import glob

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def extract_masks_transformers(frames_dir: str, text_prompt: str, save_dir: str,
                               dino_path: str, sam_path: str, box_threshold: float = 0.3,
                               text_threshold: float = 0.25, device="cpu"):
    """The HF-transformers backend: both models and their inputs on
    ``device``."""
    from PIL import Image
    from transformers import (
        AutoModelForZeroShotObjectDetection,
        AutoProcessor,
        SamModel,
        SamProcessor,
    )

    dino_proc = AutoProcessor.from_pretrained(dino_path)
    dino = AutoModelForZeroShotObjectDetection.from_pretrained(dino_path).to(device)
    sam_proc = SamProcessor.from_pretrained(sam_path)
    sam = SamModel.from_pretrained(sam_path).to(device)

    os.makedirs(save_dir, exist_ok=True)
    for path in sorted(glob(osp.join(frames_dir, "*"))):
        name = osp.splitext(osp.basename(path))[0]
        image = Image.open(path).convert("RGB")
        inputs = dino_proc(images=image, text=text_prompt, return_tensors="pt").to(device)
        with torch.no_grad():
            out = dino(**inputs)
        res = dino_proc.post_process_grounded_object_detection(
            out, inputs.input_ids, box_threshold=box_threshold,
            text_threshold=text_threshold, target_sizes=[image.size[::-1]],
        )[0]
        if len(res["scores"]) == 0:
            mask = np.zeros(image.size[::-1], np.uint8)
        else:
            box = res["boxes"][int(res["scores"].argmax())].tolist()
            mask = _hf_sam_mask(sam_proc, sam, image, box)
        Image.fromarray(mask).save(osp.join(save_dir, name + ".png"))
        print(f"wrote {name}.png")


def _hf_sam_mask(sam_proc, sam, image, box) -> np.ndarray:
    s_in = sam_proc(image, input_boxes=[[box]], return_tensors="pt")
    with torch.no_grad():
        s_out = sam(**{k: v.to(sam.device) for k, v in s_in.items()})
    masks = sam_proc.image_processor.post_process_masks(
        s_out.pred_masks.cpu(), s_in["original_sizes"], s_in["reshaped_input_sizes"])[0]
    return (masks[0, 0].numpy() * 255).astype(np.uint8)


def dino_inputs(image, caption: str, tokenizer, size: int = 800):
    """The network's inputs for one PIL image and caption, on the host:
    (image [1, size, size, 3] normalized, input_ids [1, N] int32,
    self-attention mask [1, N, N], position ids [1, N]). The caption is
    lower-cased and ends with '.'; the image is resized to size x size with
    PIL's bilinear filter, so every frame has one shape (boxes are
    normalized cx cy w h either way)."""
    from PIL import Image

    from motioneditor_tpu_torch.models.grounding_dino import build_text_masks

    caption = caption.lower().strip()
    if not caption.endswith("."):
        caption += "."
    ids = np.asarray(tokenizer(caption)["input_ids"], np.int32)[None]
    special = [tokenizer.vocab.get(t) for t in ("[CLS]", "[SEP]", ".", "?")]
    attn, pos = build_text_masks(ids, [s for s in special if s is not None])
    im = np.asarray(image.resize((size, size), Image.BILINEAR), np.float32) / 255.0
    return ((im - IMAGENET_MEAN) / IMAGENET_STD)[None], ids, attn, pos


def dino_network(model, im, ids, attn, pos):
    """GroundingDINO on the inputs of ``dino_inputs``, on the model's device."""
    from motioneditor_tpu_torch.models.grounding_dino import grounding_dino_apply

    dev = next(model.parameters()).device
    ids_t = torch.as_tensor(ids, device=dev)
    with torch.no_grad():
        return grounding_dino_apply(model, torch.as_tensor(im, device=dev), ids_t,
                                    torch.as_tensor(attn, device=dev),
                                    torch.as_tensor(pos, device=dev),
                                    torch.ones_like(ids_t, dtype=torch.bool))


def decode_boxes(out, w0: int, h0: int, box_threshold: float = 0.3):
    """(boxes xyxy in original pixels, scores) of the queries whose best
    token's sigmoid exceeds ``box_threshold`` (video_masks.py:63-96)."""
    logits = torch.sigmoid(out["pred_logits"][0]).cpu().numpy()  # [nq, max_text_len]
    boxes = out["pred_boxes"][0].cpu().numpy()  # [nq, 4] cx cy w h, normalized
    scores = np.nan_to_num(logits, neginf=0.0).max(axis=1)
    keep = scores > box_threshold
    boxes, scores = boxes[keep], scores[keep]
    cx, cy, bw, bh = boxes.T
    xyxy = np.stack([(cx - bw / 2) * w0, (cy - bh / 2) * h0,
                     (cx + bw / 2) * w0, (cy + bh / 2) * h0], axis=1)
    return xyxy, scores


def native_dino_boxes(image, caption: str, model, tokenizer, box_threshold: float = 0.3,
                      size: int = 800):
    """This package's GroundingDINO on one PIL image and caption: (boxes
    xyxy in original pixels, scores); the caller takes the best by score."""
    w0, h0 = image.size
    out = dino_network(model, *dino_inputs(image, caption, tokenizer, size))
    return decode_boxes(out, w0, h0, box_threshold)


def extract_masks_native(frames_dir: str, text_prompt: str, save_dir: str, dino_ckpt: str,
                         bert_vocab: str, sam_path: str, box_threshold: float = 0.3,
                         device="cpu"):
    """The native backend: this package's GroundingDINO boxes and, for an
    official ``sam_vit_*.pth``, this package's SAM masks, their configs
    picked by the files' names; an HF SAM directory runs through
    ``transformers``. Every network runs on ``device``."""
    from PIL import Image

    from motioneditor_tpu_torch.models.gdino_weights import load_groundingdino_checkpoint
    from motioneditor_tpu_torch.prep.tokenizer import WordPieceTokenizer

    model = load_groundingdino_checkpoint(dino_ckpt, device=device)
    tokenizer = WordPieceTokenizer(bert_vocab)
    native_sam = osp.isfile(sam_path) and sam_path.endswith(".pth")
    if native_sam:
        from motioneditor_tpu_torch.models.sam import load_sam_checkpoint, sam_predict_box

        sam = load_sam_checkpoint(sam_path, device=device)
    else:
        from transformers import SamModel, SamProcessor

        sam_proc = SamProcessor.from_pretrained(sam_path)
        sam = SamModel.from_pretrained(sam_path).to(device)

    os.makedirs(save_dir, exist_ok=True)
    for path in sorted(glob(osp.join(frames_dir, "*"))):
        name = osp.splitext(osp.basename(path))[0]
        image = Image.open(path).convert("RGB")
        xyxy, scores = native_dino_boxes(image, text_prompt, model, tokenizer, box_threshold)
        if len(scores) == 0:
            mask = np.zeros(image.size[::-1], np.uint8)
        elif native_sam:
            box = xyxy[int(scores.argmax())]
            mask = (sam_predict_box(sam, np.asarray(image), box) * 255).astype(np.uint8)
        else:
            mask = _hf_sam_mask(sam_proc, sam, image, xyxy[int(scores.argmax())].tolist())
        Image.fromarray(mask).save(osp.join(save_dir, name + ".png"))
        print(f"wrote {name}.png")


def main(argv=None):
    from motioneditor_tpu_torch.inference import resolve_device

    p = argparse.ArgumentParser("Video masks (GroundedSAM equivalent)")
    p.add_argument("--data", type=str, required=True, help="frames dir")
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--text_prompt", type=str, required=True, help='e.g. "person"')
    p.add_argument("--dino_path", type=str, default="checkpoints/grounding-dino-base")
    p.add_argument("--sam_path", type=str, default="checkpoints/sam-vit-huge")
    p.add_argument("--box_threshold", type=float, default=0.3)
    p.add_argument("--text_threshold", type=float, default=0.25)
    p.add_argument("--dino_backend", choices=("native", "transformers"), default="transformers",
                   help="native = this package's GroundingDINO (models/grounding_dino.py)")
    p.add_argument("--dino_ckpt", type=str, default="checkpoints/groundingdino_swint_ogc.pth",
                   help="official .pth checkpoint (native backend)")
    p.add_argument("--bert_vocab", type=str,
                   default="checkpoints/bert-base-uncased-vocab.txt",
                   help="local BERT vocab.txt for the native backend's tokenizer")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu: where the networks run")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.dino_backend == "native":
        sam_ok = osp.isdir(args.sam_path) or (
            osp.isfile(args.sam_path) and args.sam_path.endswith(".pth"))
        missing = [x for x in (args.dino_ckpt, args.bert_vocab) if not osp.isfile(x)]
        missing += [] if sam_ok else [args.sam_path]
        if missing:
            raise SystemExit(
                "native mask extraction needs the official GroundingDINO .pth, a BERT "
                "vocab.txt, and a SAM checkpoint (official sam_vit_*.pth for the native "
                f"SAM, or an HF dir) (missing: {missing}).")
        extract_masks_native(args.data, args.text_prompt, args.save_dir, args.dino_ckpt,
                             args.bert_vocab, args.sam_path, args.box_threshold,
                             device)
        return

    if not (osp.isdir(args.dino_path) and osp.isdir(args.sam_path)):
        raise SystemExit(
            "mask extraction needs local GroundingDINO + SAM checkpoints "
            f"(looked in {args.dino_path}, {args.sam_path}). Point --dino_path/"
            "--sam_path at HF-format checkpoints, use --dino_backend native "
            "with the official .pth, or provide per-frame masks directly as "
            "<video_dir>/man.mask/<frame>.png.")
    extract_masks_transformers(args.data, args.text_prompt, args.save_dir, args.dino_path,
                               args.sam_path, args.box_threshold, args.text_threshold, device)


if __name__ == "__main__":
    main()
