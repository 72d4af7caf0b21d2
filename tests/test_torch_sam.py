"""The port's SAM (models/sam.py) against the JAX package's, fp32 on the
CPU, on the same numpy-seeded weights (carried by models/from_jax) and
inputs, at the JAX tests' tiny config (tests/test_sam.py TINY: 64 px, a
4 x 4 embedding grid, one windowed and one global block).

- Single modules within 1e-5 * max(1, max |JAX|): the windowed ViT block
  (a 4 x 4 grid in 2 x 2 windows, and a 5 x 3 map padded to whole
  windows), the global block, ``sam_embed_boxes``, ``_conv_transpose_2x2``.
- ``sam_encode_image`` and ``sam_decode_masks`` end to end within 1e-4 *
  max |JAX|, with ``multimask`` False and True.
- ``sam_predict_box`` on 48 x 40 and 30 x 44 images (so the last resize
  shrinks): the boolean masks equal but where JAX's logit lies within
  1e-4 of 0; those pixels are counted and printed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.models import sam as JM

from motioneditor_tpu_torch.models import sam as TM
from motioneditor_tpu_torch.models.from_jax import sam_state_dict

from test_sam import TINY
from torch_port_helpers import random_params, setup_torch, tensor, to_jax

MODULE_TOL = 1e-5  # of max(1, max |JAX|)
E2E_TOL = 1e-4  # of max |JAX|
LOGIT_BAND = 1e-4  # |JAX logit| within which a mask pixel may differ


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


def assert_close(got, ref, tol=MODULE_TOL, floor=1.0):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(floor, float(np.abs(ref).max())), err


@pytest.fixture(scope="module")
def sam():
    """(JAX tree, port module) of TINY on the same seeded weights (the
    relative positions and position embedding random too)."""
    setup_torch()
    tree = random_params(lambda: JM.init_sam(jax.random.PRNGKey(0), TINY), seed=31)
    model = TM.Sam(TM.SAMConfig(**dataclasses.asdict(TINY))).eval()
    model.load_state_dict(sam_state_dict(tree))
    return to_jax(tree), model


@pytest.mark.parametrize("block,hw", [(0, (4, 4)), (0, (5, 3)), (1, (4, 4))])
def test_vit_block_matches_jax(sam, block, hw):
    """Block 0 is windowed (window 2), block 1 global."""
    tree, model = sam
    x = np.random.default_rng(32).standard_normal((2,) + hw + (32,)).astype(np.float32)
    window = 0 if block in TINY.global_attn else TINY.window
    assert model.image_encoder.blocks[block].window == window
    ref = jax.jit(lambda p, a: JM._vit_block(p, a, TINY, window))(tree["blocks"][block],
                                                                   jnp.asarray(x))
    with torch.no_grad():
        got = TM._vit_block(model.image_encoder.blocks[block], tensor(x), TINY.num_heads)
    assert_close(got, ref)


def test_embed_boxes_matches_jax(sam):
    tree, model = sam
    boxes = np.array([[8.0, 8.0, 48.0, 48.0], [0.0, 3.5, 32.0, 64.0]], np.float32)
    ref = JM.sam_embed_boxes(tree, jnp.asarray(boxes), TINY)
    got = TM.sam_embed_boxes(model, tensor(boxes))
    assert_close(got, ref)
    assert_close(TM.sam_dense_pe(model), JM.sam_dense_pe(tree, TINY))


def test_conv_transpose_2x2_matches_jax(sam):
    tree, model = sam
    x = np.random.default_rng(33).standard_normal((2, 3, 5, 32)).astype(np.float32)
    ref = JM._conv_transpose_2x2(tree["up_conv1"], jnp.asarray(x))
    got = TM._conv_transpose_2x2(model.mask_decoder.output_upscaling[0], tensor(x))
    assert_close(got, ref)
    # and torch's own ConvTranspose2d
    with torch.no_grad():
        conv = model.mask_decoder.output_upscaling[0](tensor(x).permute(0, 3, 1, 2))
    assert_close(got, conv.permute(0, 2, 3, 1).numpy())


@pytest.fixture(scope="module")
def encoded(sam):
    tree, model = sam
    img = np.random.default_rng(34).standard_normal((1, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(lambda p, a: JM.sam_encode_image(p, a, TINY))(tree, jnp.asarray(img))
    with torch.no_grad():
        got = TM.sam_encode_image(model, tensor(img))
    return np.asarray(ref), got


def test_encode_image_matches_jax(encoded):
    ref, got = encoded
    assert ref.shape == (1, 4, 4, 32)
    assert_close(got, ref, E2E_TOL, floor=0.0)


@pytest.mark.parametrize("multimask", [False, True])
def test_decode_masks_matches_jax(sam, encoded, multimask):
    tree, model = sam
    emb, _ = encoded
    boxes = np.array([[8.0, 8.0, 48.0, 48.0], [0.0, 0.0, 32.0, 64.0]], np.float32)
    ref_masks, ref_iou = jax.jit(lambda p, e, b: JM.sam_decode_masks(p, e, b, TINY, multimask))(
        tree, jnp.asarray(emb), jnp.asarray(boxes))
    with torch.no_grad():
        masks, iou = TM.sam_decode_masks(model, tensor(emb), tensor(boxes), multimask)
    n = 3 if multimask else 1
    assert masks.shape == (2, n, 16, 16) and iou.shape == (2, n)
    assert_close(masks, ref_masks, E2E_TOL, floor=0.0)
    assert_close(iou, ref_iou, E2E_TOL, floor=0.0)


@pytest.mark.parametrize("hw,box", [((48, 40), (4.0, 6.0, 30.0, 40.0)),
                                    ((30, 44), (10.0, 2.0, 40.0, 28.0))])
def test_predict_box_matches_jax(sam, hw, box):
    tree, model = sam
    img = np.random.default_rng(35).integers(0, 256, hw + (3,), dtype=np.uint8)
    ref = JM.sam_predict_box(tree, img, box, TINY)
    got = TM.sam_predict_box(model, img, box)
    assert got.shape == ref.shape == hw and got.dtype == ref.dtype == bool
    assert 0 < ref.sum() < ref.size  # the mask is neither empty nor full
    # JAX's logits at the original size, to find the pixels near 0
    x, (nh, nw) = JM.sam_preprocess(img, TINY)
    scale = TINY.img_size / max(hw)
    emb = JM.sam_encode_image(tree, x, TINY)
    box_in = jnp.asarray(np.asarray(box, np.float32) * scale)[None]
    masks, _ = JM.sam_decode_masks(tree, emb, box_in, TINY)
    m = jax.image.resize(masks[0, 0], (TINY.img_size, TINY.img_size), "bilinear")[:nh, :nw]
    logits = np.asarray(jax.image.resize(m, hw, "bilinear"))
    np.testing.assert_array_equal(logits > 0, ref)
    near = np.abs(logits) <= LOGIT_BAND
    print(f"sam_predict_box {hw}: {int(near.sum())} pixels within {LOGIT_BAND} of 0 "
          f"(max |logit| {np.abs(logits).max():.3g}), {int((got != ref).sum())} differ")
    np.testing.assert_array_equal(got[~near], ref[~near])
    port_logits = TM.sam_mask_logits(model, img, box)["logits"].numpy()
    assert_close(torch.from_numpy(port_logits), logits, E2E_TOL, floor=0.0)
