"""The port's prompt-to-prompt control (control/seq_aligner.py,
control/p2p.py) and its attention hooks (ops/attention.py) against the JAX
package, fp32 on the CPU.

Tolerances: the aligner's word indices, mappers and alpha schedules are
exact; the controllers' editors atol 1e-6; LocalBlend's latents atol 1e-6
and its mask exact; the attention sites with an editor atol 2e-5 (that of
tests/test_torch_attention.py).

LocalBlend thresholds a max-normalized map (``sel > 0.3``); a value that
sits at the threshold flips with the summation order of either package.
The maps of the LocalBlend tests are drawn from the first seed whose
normalized values all lie more than 1e-3 from the threshold (checked on
the JAX side), so the masks can be held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from motioneditor_tpu.control import p2p as JP
from motioneditor_tpu.control import seq_aligner as JS
from motioneditor_tpu.ops import attention as JA

from motioneditor_tpu_torch.control import p2p as TP
from motioneditor_tpu_torch.control import seq_aligner as TS
from motioneditor_tpu_torch.models.clip_text import StubTokenizer
from motioneditor_tpu_torch.models.from_jax import module_state_dict
from motioneditor_tpu_torch.ops import attention as TA

from test_p2p import WordTokenizer
from torch_port_helpers import assert_close, normal, random_params, setup_torch, to_jax


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


class SplitTokenizer(WordTokenizer):
    """One token per word of up to 5 letters, two tokens (halves) for a
    longer word: exercises the replacement mapper's many-to-one branch."""

    def encode(self, text):
        ids = [0]
        for w in text.lower().split(" "):
            for part in ((w,) if len(w) <= 5 else (w[: len(w) // 2], w[len(w) // 2:])):
                self.vocab.setdefault(part, len(self.vocab) + 10)
                ids.append(self.vocab[part])
        ids.append(1)
        return ids


TOKENIZERS = {"word": WordTokenizer, "split": SplitTokenizer, "stub": StubTokenizer}
SAME_LENGTH = [("a girl is dancing", "a man is dancing"),
               ("a girl is dancing", "a astronaut is dancing"),
               ("a cat sits on the mat", "a lion sits on the rocks")]
REFINE = [("a girl is dancing", "a girl is dancing outside"),
          ("a girl is dancing", "a young girl is slowly dancing"),
          ("a cat sits", "a fluffy cat sits quietly on a mat")]


@pytest.mark.parametrize("tok", sorted(TOKENIZERS))
@pytest.mark.parametrize("pair", SAME_LENGTH + REFINE)
def test_word_inds_and_mappers_are_exact(tok, pair):
    tokenizer = TOKENIZERS[tok]()
    for prompt in pair:
        for place in prompt.split(" ") + [0, 1, len(prompt.split(" ")) - 1, "absent"]:
            np.testing.assert_array_equal(TS.get_word_inds(prompt, place, tokenizer),
                                          JS.get_word_inds(prompt, place, tokenizer))
    got, ref = TS.get_refinement_mapper(pair, tokenizer), JS.get_refinement_mapper(pair, tokenizer)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    if len(pair[0].split(" ")) == len(pair[1].split(" ")):
        np.testing.assert_array_equal(TS.get_replacement_mapper(pair, tokenizer),
                                      JS.get_replacement_mapper(pair, tokenizer))


def test_replacement_mapper_splits_a_word_into_fractions():
    m = TS.get_replacement_mapper(["a girl is dancing", "a astronaut is dancing"],
                                  SplitTokenizer())[0]
    np.testing.assert_array_equal(m[2, 2:4], [0.5, 0.5])  # girl -> astro + naut
    with pytest.raises(ValueError, match="same length"):
        TS.get_replacement_mapper(["a girl", "a man is"], WordTokenizer())


def test_global_align_is_exact():
    rng = np.random.default_rng(0)
    for _ in range(5):
        x, y = (list(rng.integers(0, 6, rng.integers(1, 9))) for _ in range(2))
        score_t, score_j = TS.ScoreParams(0, 1, -1), JS.ScoreParams(0, 1, -1)
        for a, b in zip(TS.global_align(x, y, score_t), JS.global_align(x, y, score_j)):
            np.testing.assert_array_equal(a, b)
        _, tb = TS.global_align(x, y, score_t)
        for a, b in zip(TS.get_aligned_sequences(x, y, tb), JS.get_aligned_sequences(x, y, tb)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("steps", [
    0.8, 0.5, {"default_": (0.2, 0.9), "man": (0.0, 0.3)}, {"man": 0.4},
    {"default_": 1.0, "dancing": (0.5, 1.0), "absent": 0.3}])
def test_time_words_alpha_is_exact(steps):
    tokenizer = WordTokenizer()
    prompts = ["a girl is dancing", "a man is dancing"]
    got = TP.get_time_words_attention_alpha(prompts, 10, dict(steps) if isinstance(
        steps, dict) else steps, tokenizer)
    ref = JP.get_time_words_attention_alpha(prompts, 10, dict(steps) if isinstance(
        steps, dict) else steps, tokenizer)
    assert got.shape == (11, 1, 1, 1, 77) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def _controllers(tokenizer, num_steps=10):
    """Replace, refine and reweight controllers of both packages."""
    specs = {
        "replace": (["a girl is dancing", "a man is dancing"], {}),
        "refine": (["a girl is dancing", "a young girl is dancing outside"],
                   dict(cross_replace_steps={"default_": 0.6, "young": (0.2, 0.5)})),
        "reweight": (["a girl is dancing", "a girl is dancing"],
                     dict(equalizer_words=["girl", "dancing"], equalizer_values=[2.0, 0.5])),
    }
    out = {}
    for kind, (prompts, kw) in specs.items():
        t = TP.make_controller(prompts, tokenizer, num_steps, **{
            k: dict(v) if isinstance(v, dict) else v for k, v in kw.items()})
        j = JP.make_controller(prompts, tokenizer, num_steps, **kw)
        assert t.kind == j.kind == kind
        for name in ("cross_alpha", "mapper", "refine_alphas", "equalizer"):
            a, b = getattr(t, name), getattr(j, name)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        assert t.self_replace_until == j.self_replace_until == 4
        out[kind] = (t, j)
    return out


def _probs(rng, shape):
    return rng.dirichlet(np.ones(shape[-1]), size=shape[:-1]).astype(np.float32)


@pytest.mark.parametrize("kind", ["replace", "refine", "reweight"])
def test_cross_editor_matches_jax(kind):
    """Inside and outside the word windows, at Q = 256 and Q > 256 (the
    cross editor acts at every size)."""
    t, j = _controllers(WordTokenizer())[kind]
    rng = np.random.default_rng(1)
    for q in (256, 320):
        probs = _probs(rng, (4, 2, 2, q, 77))
        for step in (0, 3, 5, 9):
            got = t.prob_editor(step)(torch.from_numpy(probs), True)
            ref = j.prob_editor(step)(jnp.asarray(probs), True)
            assert_close(got, ref, atol=1e-6)
            np.testing.assert_array_equal(got[:3].numpy(), probs[:3])
            base, edit = torch.from_numpy(probs[2]), torch.from_numpy(probs[3])
            assert_close(t.edit_cross_probs(base, edit, step),
                         j.edit_cross_probs(jnp.asarray(probs[2]), jnp.asarray(probs[3]), step),
                         atol=1e-6)


@pytest.mark.parametrize("kind", ["replace", "refine", "reweight"])
def test_self_editor_matches_jax(kind):
    """Replacement inside [0, self_replace_until) at Q <= 256, never at
    Q > 256."""
    t, j = _controllers(WordTokenizer())[kind]
    rng = np.random.default_rng(2)
    for q, kv in ((256, 256), (64, 128), (320, 320)):
        probs = rng.random((4, 2, 2, q, kv), dtype=np.float32)
        for step in (0, 3, 4, 9):
            got = t.prob_editor(step)(torch.from_numpy(probs), False)
            ref = j.prob_editor(step)(jnp.asarray(probs), False)
            assert_close(got, ref, atol=1e-6)
            if q <= 256 and step < 4:
                np.testing.assert_array_equal(got[3].numpy(), probs[2])
            else:
                np.testing.assert_array_equal(got.numpy(), probs)


def test_editor_refuses_other_batches():
    t, _ = _controllers(WordTokenizer())["replace"]
    with pytest.raises(ValueError, match="4 branch rows"):
        t.prob_editor(0)(torch.zeros((2, 1, 1, 4, 77)), True)


def _jax_normalized_sel(blend, maps, h, w):
    """JAX LocalBlend's max-normalized selection map [B, F, h, w]."""
    b, f = blend.alpha_layers.shape[0], maps[0].shape[0] // blend.alpha_layers.shape[0]
    m = jnp.stack([jnp.asarray(x) for x in maps], axis=1)
    m = m.reshape(b, f, m.shape[1], 16, 16, m.shape[-1])
    sel = (m * jnp.asarray(blend.alpha_layers)[:, None, None, None, None, :]).sum(-1).mean(2)
    sel = jax.lax.reduce_window(sel, -jnp.inf, jax.lax.max, (1, 1, 3, 3), (1, 1, 1, 1), "SAME")
    sel = jax.image.resize(sel, (b, f, h, w), method="bilinear")
    return np.asarray(sel / jnp.maximum(sel.max(axis=(2, 3), keepdims=True), 1e-8))


def _peaked_probs(rng, shape):
    """Rows of a softmax whose mass on a word varies widely over the
    pixels, so a thresholded map has both sides."""
    x = rng.random(shape, dtype=np.float32) ** 8
    return x / x.sum(-1, keepdims=True)


def _two_level_probs(rng, shape):
    """Rows whose mass on token 2 is 0.6 or 0.03 over 4x4 blocks of the
    16x16 grid (none on token 4): the normalized map holds 1 and 0.05, so
    every upsampled value is 0.05 + 0.95 k / (4 s^2) at an integer k for an
    upsampling factor s in {1, 2, 3, 4} (k / 64 at s = 4), none of them
    within 2e-3 of 0.3 (the sparse draw where random maps at 64x64 latents
    always land some pixel in that band)."""
    x = rng.random(shape, dtype=np.float32)
    x[..., 2] = 0.0
    x[..., 4] = 0.0
    x = x / x.sum(-1, keepdims=True)
    blocks = rng.random(shape[:1] + (4, 4)) < 0.5
    v = np.where(np.kron(blocks, np.ones((4, 4))) > 0, 0.6, 0.03).reshape(shape[0], 256)
    x = x * (1.0 - v[..., None]).astype(np.float32)
    x[..., 2] = v
    return x.astype(np.float32)


DRAWS = {"peaked": _peaked_probs, "two_level": _two_level_probs}


def _blend_case(h, w, draw, f=2, sites=3):
    """A LocalBlend and maps [(2 F), 256, 77] drawn from the first seed
    whose normalized values all lie more than 1e-3 from the threshold."""
    tokenizer = WordTokenizer()
    blend_t = TP.make_local_blend(["a girl is dancing", "a man is dancing"],
                                  [["girl"], ["man", "dancing"]], tokenizer)
    blend_j = JP.make_local_blend(["a girl is dancing", "a man is dancing"],
                                  [["girl"], ["man", "dancing"]], tokenizer)
    np.testing.assert_array_equal(blend_t.alpha_layers, blend_j.alpha_layers)
    assert blend_t.alpha_layers[1].sum() == 2
    for seed in range(100):
        rng = np.random.default_rng(seed)
        maps = [DRAWS[draw](rng, (2 * f, 256, 77)) for _ in range(sites)]
        sel = _jax_normalized_sel(blend_j, maps, h, w)
        if np.abs(sel - blend_t.threshold).min() > 1e-3 and 0.05 < (sel > 0.3).mean() < 0.95:
            return blend_t, blend_j, maps
    raise AssertionError("no seed draws maps clear of the threshold")


@pytest.mark.parametrize("draw, hw", [("peaked", (16, 16)), ("peaked", (32, 32)),
                                      ("two_level", (64, 64)), ("two_level", (64, 48))])
def test_local_blend_matches_jax(draw, hw):
    h, w = hw
    blend_t, blend_j, maps = _blend_case(h, w, draw)
    rng = np.random.default_rng(3)
    lat = normal(rng, (2, 2, h, w, 4))
    got = blend_t(torch.from_numpy(lat), [torch.from_numpy(m) for m in maps])
    ref = blend_j(jnp.asarray(lat), [jnp.asarray(m) for m in maps])
    assert_close(got, ref, atol=1e-6)
    # the mask, exactly: source 0, edit 1
    lat01 = np.concatenate([np.zeros_like(lat[:1]), np.ones_like(lat[:1])])
    got = blend_t(torch.from_numpy(lat01), [torch.from_numpy(m) for m in maps])
    ref = blend_j(jnp.asarray(lat01), [jnp.asarray(m) for m in maps])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert set(np.unique(got[1].numpy())) == {0.0, 1.0}
    np.testing.assert_array_equal(got[0].numpy(), lat01[0])


@pytest.mark.parametrize("size", [(16, 16), (20, 24), (64, 64), (17, 33)])
def test_bilinear_upsampling_equals_jax_at_the_edges(size):
    """LocalBlend's resize: F.interpolate(bilinear, align_corners=False)
    equals jax.image.resize(bilinear) when upsampling, the first and last
    rows and columns included."""
    x = np.random.default_rng(4).random((2, 3, 16, 16), dtype=np.float32)
    got = F.interpolate(torch.from_numpy(x), size=size, mode="bilinear",
                        align_corners=False).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3) + size, method="bilinear"))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    for edge in (got[..., 0, :] - ref[..., 0, :], got[..., -1, :] - ref[..., -1, :],
                 got[..., :, 0] - ref[..., :, 0], got[..., :, -1] - ref[..., :, -1]):
        assert np.abs(edge).max() <= 1e-6


def test_max_pool_pads_with_minus_infinity_as_jax():
    """The smoothing pool: max_pool2d(3, 1, padding=1) is reduce_window over
    -inf "SAME" padding, also on negative maps, where a zero pad would win."""
    x = -np.random.default_rng(5).random((2, 3, 16, 16), dtype=np.float32)
    got = F.max_pool2d(torch.from_numpy(x), 3, stride=1, padding=1).numpy()
    ref = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 1, 3, 3),
                                (1, 1, 1, 1), "SAME")
    np.testing.assert_array_equal(got, np.asarray(ref))


def _attention(c, heads, cross_dim=None, seed=0):
    from motioneditor_tpu.ops.attention import init_attention

    tree = random_params(lambda: init_attention(jax.random.PRNGKey(0), c, cross_dim=cross_dim,
                                                heads=heads), seed=seed)
    module = TA.Attention(c, cross_dim=cross_dim, heads=heads)
    module.load_state_dict(module_state_dict("attention", tree))
    return tree, module


@pytest.mark.parametrize("kind", ["replace", "refine", "reweight"])
@pytest.mark.parametrize("n", [64, 256, 1024])
def test_spatial_self_attention_with_editor(kind, n):
    """The editor's explicit-probs path at n <= 256 (inside its window);
    at n = 1024 the site routes as without an editor."""
    t, j = _controllers(WordTokenizer())[kind]
    tree, module = _attention(32, 4, seed=6)
    x = normal(np.random.default_rng(6), (4, 2, n, 32))
    for step in (1, 7):
        with torch.no_grad():
            got = TA.spatial_self_attention(module, torch.from_numpy(x), "normal", 4,
                                            prob_editor=t.prob_editor(step))
        ref = JA.spatial_self_attention(to_jax(tree), jnp.asarray(x), "normal", 4,
                                        use_flash=False, prob_editor=j.prob_editor(step))
        assert_close(got, ref, atol=2e-5)
    with torch.no_grad():
        plain = TA.spatial_self_attention(module, torch.from_numpy(x), "normal", 4)
        edited = TA.spatial_self_attention(module, torch.from_numpy(x), "normal", 4,
                                           prob_editor=t.prob_editor(1))
    assert torch.equal(edited[:3], plain[:3])
    assert torch.equal(edited[3], plain[3]) == (n > 256)


@pytest.mark.parametrize("kind", ["replace", "refine", "reweight"])
def test_cross_attention_with_editor_and_maps(kind):
    """The edited output and the maps, collected before the edit."""
    t, j = _controllers(WordTokenizer())[kind]
    tree, module = _attention(32, 4, cross_dim=16, seed=7)
    rng = np.random.default_rng(7)
    x, enc = normal(rng, (4, 2, 256, 32)), normal(rng, (4, 77, 16))
    for step in (2, 9):
        maps_t, maps_j = [], []
        with torch.no_grad():
            got = TA.cross_attention(module, torch.from_numpy(x), torch.from_numpy(enc), 4,
                                     collect_maps_into=maps_t, prob_editor=t.prob_editor(step))
        ref = JA.cross_attention(to_jax(tree), jnp.asarray(x), jnp.asarray(enc), 4,
                                 collect_maps_into=maps_j, prob_editor=j.prob_editor(step))
        assert_close(got, ref, atol=2e-5)
        assert len(maps_t) == len(maps_j) == 1
        assert_close(maps_t[0], maps_j[0], atol=1e-6)
        plain_maps = []
        with torch.no_grad():
            TA.cross_attention(module, torch.from_numpy(x), torch.from_numpy(enc), 4,
                               collect_maps_into=plain_maps)
        assert torch.equal(maps_t[0], plain_maps[0])
