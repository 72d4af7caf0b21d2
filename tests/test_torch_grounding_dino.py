"""The port's GroundingDINO (models/grounding_dino.py, models/swin.py,
ops/ms_deform_attn.py) against the JAX package's, fp32 on the CPU, on the
same numpy-seeded weights (carried by models/from_jax) and inputs, at the
JAX tests' tiny configs (tests/test_grounding_dino.py TINY_SWIN,
TINY_GDINO).

- Single modules within 1e-5 * max(1, max |JAX|): ``ms_deform_attn`` at
  three levels with sampling points outside the maps, Swin's window
  attention with and without the shift mask, ``swin_apply`` at a size that
  pads to whole windows (shifted blocks included), ``build_text_masks``
  (exactly), ``bert_apply``, ``_fusion_apply`` with a padded token, one
  encoder and one decoder layer.
- ``grounding_dino_apply`` end to end within 1e-4 * max |JAX| on the finite
  logits and the boxes, with the same -inf pattern and the same top-k
  query indices (JAX's ``lax.top_k`` read from inside its trace), and
  equal to ``grounding_dino_encode``, ``top_k_indices`` and
  ``grounding_dino_decode`` composed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.models import grounding_dino as JG
from motioneditor_tpu.models import swin as JS
from motioneditor_tpu.ops import ms_deform_attn as JD

from motioneditor_tpu_torch.models import grounding_dino as TG
from motioneditor_tpu_torch.models import swin as TS
from motioneditor_tpu_torch.models.from_jax import grounding_dino_state_dict, module_state_dict
from motioneditor_tpu_torch.ops import ms_deform_attn as TD

from test_grounding_dino import TINY_GDINO, TINY_SWIN
from torch_port_helpers import random_params, setup_torch, tensor, to_jax

MODULE_TOL = 1e-5  # of max(1, max |JAX|)
E2E_TOL = 1e-4  # of max |JAX|


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


def swin_config(jcfg) -> TS.SwinConfig:
    return TS.SwinConfig(**dataclasses.asdict(jcfg))


def gdino_config(jcfg) -> TG.GroundingDINOConfig:
    d = dataclasses.asdict(jcfg)
    d["swin"] = swin_config(jcfg.swin)
    d["bert"] = TG.BertConfig(**d["bert"])
    return TG.GroundingDINOConfig(**d)


def assert_module_close(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= MODULE_TOL * max(1.0, float(np.abs(ref).max())), err


@pytest.fixture(scope="module")
def gdino():
    """(JAX tree, port module) of TINY_GDINO on the same seeded weights."""
    setup_torch()
    tree = random_params(lambda: JG.init_grounding_dino(jax.random.PRNGKey(0), TINY_GDINO),
                         seed=21)
    model = TG.GroundingDINO(gdino_config(TINY_GDINO)).eval()
    model.load_state_dict(grounding_dino_state_dict(tree))
    return to_jax(tree), model


@pytest.mark.parametrize("seed", range(3))
def test_ms_deform_attn_matches_jax(seed):
    rng = np.random.default_rng(seed)
    shapes = ((5, 7), (3, 4), (2, 2))
    b, nq, heads, dim, points = 2, 6, 2, 4, 3
    value = rng.standard_normal((b, sum(h * w for h, w in shapes), heads, dim)).astype(np.float32)
    # a quarter of the points lie outside [0, 1]: zero padding
    loc = rng.uniform(-0.3, 1.3, (b, nq, heads, len(shapes), points, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (b, nq, heads, len(shapes), points)).astype(np.float32)
    assert ((loc < 0) | (loc > 1)).any()
    ref = JD.ms_deform_attn(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(w))
    got = TD.ms_deform_attn(tensor(value), shapes, tensor(loc), tensor(w))
    assert_module_close(got, ref)


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_window_attention_matches_jax(shift):
    tree = random_params(lambda: JS.init_swin(jax.random.PRNGKey(0), TINY_SWIN), seed=22)
    model = TS.SwinTransformer(swin_config(TINY_SWIN))
    model.load_state_dict(module_state_dict("swin", tree))
    window, heads, dim = 4, TINY_SWIN.num_heads[1], TINY_SWIN.stage_dim(1)
    jp = to_jax(tree["stages"][1]["blocks"][0]["attn"])
    mask = JS._shift_mask(8, 8, window, shift) if shift else None
    x = np.random.default_rng(23).standard_normal((2 * 4, window * window, dim)).astype(np.float32)
    ref = JS._window_attention(jp, jnp.asarray(x), heads, window, mask)
    got = TS.window_attention(model.layers[1].blocks[0].attn, tensor(x),
                              TS._shift_mask(8, 8, window, shift) if shift else None)
    assert_module_close(got, ref)


def test_swin_apply_pads_to_windows_and_matches_jax():
    """Two blocks a stage, so odd blocks shift; 88 x 72 px is a 22 x 18
    token map that pads to 24 x 20 windows of 4, then 11 x 9, 6 x 5, 3 x 3."""
    jcfg = JS.SwinConfig(embed_dim=8, depths=(2, 2, 2, 1), num_heads=(1, 2, 2, 4), window_size=4)
    tree = random_params(lambda: JS.init_swin(jax.random.PRNGKey(0), jcfg), seed=24)
    model = TS.SwinTransformer(swin_config(jcfg))
    model.load_state_dict(module_state_dict("swin", tree))
    img = np.random.default_rng(25).standard_normal((1, 88, 72, 3)).astype(np.float32)
    refs = jax.jit(lambda t, x: JS.swin_apply(t, x, jcfg))(to_jax(tree), jnp.asarray(img))
    with torch.no_grad():
        gots = TS.swin_apply(model, tensor(img))
    assert [tuple(g.shape) for g in gots] == [(1, 11, 9, 16), (1, 6, 5, 32), (1, 3, 3, 64)]
    for got, ref in zip(gots, refs):
        assert_module_close(got, ref)


def test_build_text_masks_equals_jax():
    rng = np.random.default_rng(26)
    cases = [np.array([[101, 7, 8, 120, 9, 120, 102]]),
             np.array([[101, 120, 120, 5, 102, 0, 0]]),  # consecutive specials, padding
             rng.integers(0, 130, (3, 12))]
    for ids in cases:
        for got, ref in zip(TG.build_text_masks(ids, [101, 102, 120]),
                            JG.build_text_masks(ids, [101, 102, 120])):
            np.testing.assert_array_equal(got, ref)
            assert got.dtype == ref.dtype


def _text():
    """Two phrases ("7 8 ." and "9 .") between [CLS] and [SEP]."""
    ids = np.array([[101, 7, 8, 120, 9, 120, 102]])
    attn, pos = JG.build_text_masks(ids, [101, 102, 120])
    return ids, attn, pos


def test_bert_apply_matches_jax(gdino):
    tree, model = gdino
    ids, attn, pos = _text()
    ref = JG.bert_apply(tree["bert"], jnp.asarray(ids), jnp.asarray(attn), jnp.asarray(pos),
                        TINY_GDINO.bert)
    with torch.no_grad():
        got = TG.bert_apply(model.bert, torch.from_numpy(ids), torch.from_numpy(attn),
                            torch.from_numpy(pos))
    assert_module_close(got, ref)


def test_fusion_matches_jax(gdino):
    tree, model = gdino
    rng = np.random.default_rng(27)
    v = rng.standard_normal((1, 30, 32)).astype(np.float32)
    lt = rng.standard_normal((1, 7, 32)).astype(np.float32)
    mask = np.array([[True] * 5 + [False] * 2])  # two padded tokens
    refs = JG._fusion_apply(tree["fusion_layers"][1], jnp.asarray(v), jnp.asarray(lt),
                            jnp.asarray(mask), TINY_GDINO)
    with torch.no_grad():
        gots = TG._fusion_apply(model.transformer.encoder.fusion_layers[1], tensor(v),
                                tensor(lt), torch.from_numpy(mask))
    for got, ref in zip(gots, refs):
        assert_module_close(got, ref)


SHAPES = ((8, 8), (4, 4), (2, 2), (1, 1))  # TINY_GDINO's levels at 64 px


def test_encoder_layer_matches_jax(gdino):
    tree, model = gdino
    rng = np.random.default_rng(28)
    n = sum(h * w for h, w in SHAPES)
    src = rng.standard_normal((1, n, 32)).astype(np.float32)
    pos = rng.standard_normal((1, n, 32)).astype(np.float32)
    # the layer's offsets and attention weights are random here, so points
    # leave the maps
    ref_pts = np.asarray(JG._encoder_reference_points(SHAPES))[None]
    np.testing.assert_array_equal(TG._encoder_reference_points(SHAPES)[None], ref_pts)
    ref = jax.jit(lambda *a: JG._enc_layer_apply(*a, SHAPES, TINY_GDINO))(
        tree["enc_layers"][0], jnp.asarray(src), jnp.asarray(pos), jnp.asarray(ref_pts))
    with torch.no_grad():
        got = TG._enc_layer_apply(model.transformer.encoder.layers[0], tensor(src),
                                  tensor(pos), tensor(ref_pts), SHAPES, model.config)
    assert_module_close(got, ref)


def test_decoder_layer_matches_jax(gdino):
    tree, model = gdino
    rng = np.random.default_rng(29)
    n = sum(h * w for h, w in SHAPES)
    tgt, query_pos = (rng.standard_normal((1, 12, 32)).astype(np.float32) for _ in range(2))
    refs = rng.uniform(0.05, 0.95, (1, 12, 4)).astype(np.float32)
    memory = rng.standard_normal((1, n, 32)).astype(np.float32)
    text = rng.standard_normal((1, 7, 32)).astype(np.float32)
    mask = np.array([[True] * 6 + [False]])
    ref = jax.jit(lambda *a: JG._dec_layer_apply(*a, SHAPES, TINY_GDINO))(
        tree["dec_layers"][1], *(jnp.asarray(a) for a in (tgt, query_pos, refs, memory, text,
                                                          mask)))
    with torch.no_grad():
        got = TG._dec_layer_apply(model.transformer.decoder.layers[1], tensor(tgt),
                                  tensor(query_pos), tensor(refs), tensor(memory), tensor(text),
                                  torch.from_numpy(mask), SHAPES, model.config)
    assert_module_close(got, ref)


def jax_apply_with_topk(tree, img, ids, attn, pos, token_mask, cfg):
    """JAX's grounding_dino_apply, jitted, and the indices its
    ``lax.top_k`` picks, captured inside the same trace."""
    captured = {}
    top_k = jax.lax.top_k

    def spy(x, k):
        out = top_k(x, k)
        captured["idx"] = out[1]
        return out

    def run(params, *args):
        jax.lax.top_k = spy
        try:
            out = JG.grounding_dino_apply(params, *args, cfg)
        finally:
            jax.lax.top_k = top_k
        return out, captured["idx"]

    out, idx = jax.jit(run)(tree, *(jnp.asarray(a) for a in (img, ids, attn, pos, token_mask)))
    return {k: np.asarray(v) for k, v in out.items()}, np.asarray(idx)


@pytest.mark.parametrize("padded", [False, True])
def test_grounding_dino_apply_matches_jax(gdino, padded):
    tree, model = gdino
    img = np.random.default_rng(30).standard_normal((1, 64, 64, 3)).astype(np.float32)
    ids, attn, pos = _text()
    token_mask = np.ones((1, 7), bool)
    if padded:  # the last token masked out of the text
        token_mask[0, -1] = False
    ref, ref_idx = jax_apply_with_topk(tree, img, ids, attn, pos, token_mask, TINY_GDINO)
    inputs = (tensor(img), *(torch.from_numpy(a) for a in (ids, attn, pos, token_mask)))
    with torch.no_grad():
        out = TG.grounding_dino_apply(model, *inputs)
        enc = TG.grounding_dino_encode(model, *inputs)
        topk_idx = TG.top_k_indices(enc["scores"], model.config.num_queries)
        composed = TG.grounding_dino_decode(model, enc, topk_idx, inputs[-1])
    np.testing.assert_array_equal(topk_idx.numpy(), ref_idx)
    assert set(out) == set(composed) == {"pred_logits", "pred_boxes"}
    for k, v in out.items():  # the forward is encode, top-k, decode
        assert torch.equal(composed[k], v), k
    logits, ref_logits = out["pred_logits"].numpy(), ref["pred_logits"]
    assert logits.shape == ref_logits.shape == (1, 12, 16)
    finite = np.isfinite(ref_logits)
    np.testing.assert_array_equal(np.isfinite(logits), finite)
    np.testing.assert_array_equal(np.isneginf(logits), ~finite)
    assert finite.sum() == 12 * (6 if padded else 7)
    scale = float(np.abs(ref_logits[finite]).max())
    assert float(np.abs(logits[finite] - ref_logits[finite]).max()) <= E2E_TOL * scale
    boxes, ref_boxes = out["pred_boxes"].numpy(), ref["pred_boxes"]
    assert boxes.shape == ref_boxes.shape == (1, 12, 4)
    assert float(np.abs(boxes - ref_boxes).max()) <= E2E_TOL * float(np.abs(ref_boxes).max())


def test_top_k_indices_break_ties_like_lax():
    scores = torch.tensor([[1.0, 3.0, float("-inf"), 3.0, 1.0, float("-inf"), 2.0]])
    got = TG.top_k_indices(scores, 6)
    ref = jax.lax.top_k(jnp.asarray(scores.numpy()), 6)[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.tolist() == [[1, 3, 6, 0, 4, 2]]
