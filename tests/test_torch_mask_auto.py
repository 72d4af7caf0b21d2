"""The port's auto-mask injection against the JAX package, fp32 on the CPU:
the mask aggregation, ``injected_spatial_attention_auto`` with and without
cross-attention maps, a tiny injected UNet forward in auto mode (as
tests/test_mask_auto.py:83-102 drives JAX's) and a 2-step auto denoise
segment against ``_jit_denoise_segment``.

The auto mask binarizes min-max normalized maps at ``>= auto_thres``, so a
pixel within float noise of the threshold could flip between the two
packages. Every test here asserts that its normalized maps stay at least
1e-5 (some ten float32 ulps of a value near 1) away from the threshold
before it compares. Tolerances: the mask
exactly; the attention module atol 2e-5 (tests/test_torch_injection.py);
the UNet forward atol 3e-4, rtol 1e-4 and the segment atol 2e-3 (those of
tests/test_torch_slice.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.control import injection as JI
from motioneditor_tpu.models.controlnet import init_controlnet
from motioneditor_tpu.models.controlnet import (
    precompute_cond_embedding as jax_precompute_cond_embedding,
)
from motioneditor_tpu.models.unet import unet_apply as jax_unet_apply
from motioneditor_tpu.ops.attention import init_attention
from motioneditor_tpu.pipelines.editor import _jit_denoise_segment
from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule

from motioneditor_tpu_torch.control import injection as TI
from motioneditor_tpu_torch.models.controlnet import (
    ControlNetModel,
    controlnet_config,
    precompute_cond_embedding,
)
from motioneditor_tpu_torch.models.from_jax import controlnet_state_dict, module_state_dict
from motioneditor_tpu_torch.models.unet import UNetConfig, unet_apply
from motioneditor_tpu_torch.ops.attention import Attention
from motioneditor_tpu_torch.pipelines.editor import denoise_segment
from motioneditor_tpu_torch.schedulers import DiffusionSchedule

from torch_port_helpers import (
    JAX_TINY,
    TINY_KW,
    assert_close,
    normal,
    random_params,
    setup_torch,
    tiny_unet,
    to_jax,
)

TINY = UNetConfig(**TINY_KW)
F, HW = 2, 16
MARGIN = 1e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


def _normalized(maps, token_idx):
    """The normalized map images aggregate_cross_attn_mask thresholds."""
    img = torch.stack(list(maps), 1).mean(1)[..., list(token_idx)].sum(-1)
    lo = img.amin(-1, keepdim=True)
    hi = img.amax(-1, keepdim=True)
    return (img - lo) / torch.clamp(hi - lo, min=1e-8)


def _assert_clear(maps, token_idx, thres):
    gap = (_normalized(maps, token_idx) - thres).abs().min().item()
    assert gap > MARGIN, f"a normalized map value lies {gap} from the threshold"


def _coarse_maps(rng):
    """Random maps on a grid of eighths, so their normalized values are
    fractions with small denominators, far from the thresholds used here."""
    return (rng.integers(0, 8, (4 * F, 256, 77)) / 8).astype(np.float32)


@pytest.fixture
def clear_of_threshold(monkeypatch):
    """Wrap the port's aggregation so every call asserts the margin."""
    calls = []
    inner = TI.aggregate_cross_attn_mask

    def checked(cross_maps, token_idx, res, thres):
        _assert_clear(cross_maps, token_idx, thres)
        calls.append(res)
        return inner(cross_maps, token_idx, res, thres)

    monkeypatch.setattr(TI, "aggregate_cross_attn_mask", checked)
    return calls


@pytest.mark.parametrize("res", [16, 32])
def test_aggregate_cross_attn_mask(res):
    rng = np.random.default_rng(0)
    maps = [_coarse_maps(rng) for _ in range(3)]
    tmaps = [torch.from_numpy(m) for m in maps]
    _assert_clear(tmaps, (1, 3), 0.3137)
    out = TI.aggregate_cross_attn_mask(tmaps, (1, 3), res, 0.3137)
    ref = JI.aggregate_cross_attn_mask([jnp.asarray(m) for m in maps], (1, 3), res, 0.3137)
    assert out.shape == (F, res * res, 1)
    assert_close(out, ref, atol=0)
    assert 0 < out.mean() < 1


def _attention_module(seed, c=16, heads=2):
    tree = random_params(lambda: init_attention(jax.random.PRNGKey(0), c, heads=heads),
                         seed=seed)
    module = Attention(c, heads=heads)
    module.load_state_dict(module_state_dict("attention", tree))
    return tree, module


@pytest.mark.parametrize("with_maps", [True, False])
@pytest.mark.parametrize("n", [64, 1024])
def test_injected_spatial_attention_auto(with_maps, n):
    """With maps: fg/bg attention recomposed by the auto mask; without, the
    edit rows read the source K/V wholesale. n = 1024 reaches the K8
    wrapper (its plain version here)."""
    tree, module = _attention_module(1)
    rng = np.random.default_rng(2)
    x = normal(rng, (4, F, n, 16))
    mask = (rng.random((F, n, 1)) > 0.5).astype(np.float32)
    maps = [_coarse_maps(rng)] if with_maps else []
    tmaps = [torch.from_numpy(m) for m in maps]
    if with_maps:
        _assert_clear(tmaps, (1,), 0.4519)
    with torch.no_grad():
        out = TI.injected_spatial_attention_auto(module, torch.from_numpy(x), 2,
                                                 torch.from_numpy(mask), tmaps, (1,), 0.4519)
    ref = JI.injected_spatial_attention_auto(to_jax(tree), jnp.asarray(x), 2, jnp.asarray(mask),
                                             [jnp.asarray(m) for m in maps], (1,), 0.4519,
                                             use_flash=False)
    assert_close(out, ref, atol=2e-5)
    if not with_maps:  # the mutual mode's result
        with torch.no_grad():
            mutual = TI.injected_spatial_attention(module, torch.from_numpy(x), 2, None,
                                                   mask_fgbg=False)
        torch.testing.assert_close(out, mutual, atol=1e-5, rtol=0)


def _masks(rng, sizes=(16, 8, 4, 2)):
    return {(s, s): (rng.random((F, s * s, 1)) > 0.5).astype(np.float32) for s in sizes}


def _auto_spec(jax_side: bool):
    mod = JI if jax_side else TI
    return mod.InjectionSpec.from_start_layer(10, mask_mode="auto", auto_token_idx=(1, 2),
                                              auto_thres=0.3)


def test_unet_auto_forward_matches_jax(clear_of_threshold):
    """Maps collected at the 16x16 blocks (0, 1 and 10-12 at this size) feed
    the later injected blocks of the same forward."""
    tree, unet = tiny_unet(seed=5)
    rng = np.random.default_rng(6)
    x = normal(rng, (4, F, HW, HW, 4))
    enc = normal(rng, (4, 7, 16))
    masks = _masks(rng)
    t = 400

    @jax.jit
    def jax_forward(params, x, enc, masks):
        return jax_unet_apply(params, JAX_TINY, x, jnp.asarray(t), enc,
                              injection=_auto_spec(True), injection_masks=masks,
                              use_flash=False)

    ref = jax_forward(tree, jnp.asarray(x), jnp.asarray(enc),
                      {k: jnp.asarray(v) for k, v in masks.items()})
    with torch.no_grad():
        out = unet_apply(unet, TINY, torch.from_numpy(x), t, torch.from_numpy(enc),
                         injection=_auto_spec(False),
                         injection_masks={k: torch.from_numpy(v) for k, v in masks.items()})
    assert clear_of_threshold, "no injected block read the maps"
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert_close(out, ref, atol=3e-4, rtol=1e-4)


def test_auto_denoise_segment_matches_jax(clear_of_threshold):
    tree, unet = tiny_unet(seed=7)
    cn_jax_config = dataclasses.replace(JAX_TINY, video=False, use_sc_attn=False)
    cn_tree = random_params(lambda: init_controlnet(jax.random.PRNGKey(1), cn_jax_config),
                            seed=8)
    cn = ControlNetModel(controlnet_config(TINY)).eval()
    cn.load_state_dict(controlnet_state_dict(cn_tree))
    rng = np.random.default_rng(9)
    lat0 = normal(rng, (2, F, HW, HW, 4), 0.3)
    cond, uncond = (normal(rng, (2, 7, 16), 0.3) for _ in range(2))
    skel = rng.random((2, F, 8 * HW, 8 * HW, 3)).astype(np.float32)
    masks = _masks(rng)
    num_steps, guidance = 50, 7.5
    seg_ts = JaxSchedule().inference_timesteps(num_steps)[4:6]

    cn_params = to_jax(cn_tree)
    cond_emb_jax = jax_precompute_cond_embedding(cn_params, jnp.asarray(skel))
    seg_fn = _jit_denoise_segment(JAX_TINY, cn_jax_config, JaxSchedule(), num_steps,
                                  _auto_spec(True), guidance, 1.0, False, False)
    ref, _ = seg_fn(tree, cn_params, jnp.asarray(lat0), jnp.asarray(seg_ts), jnp.asarray(cond),
                    jnp.asarray(uncond), jnp.zeros((len(seg_ts), 1, 1, 1)), cond_emb_jax,
                    {k: jnp.asarray(v) for k, v in masks.items()}, jnp.zeros(()))
    with torch.no_grad():
        cond_emb = precompute_cond_embedding(cn, torch.from_numpy(skel))
    out = denoise_segment(
        unet, TINY, cn, controlnet_config(TINY), DiffusionSchedule(), num_steps,
        _auto_spec(False), guidance, 1.0, torch.from_numpy(lat0), seg_ts,
        torch.from_numpy(cond), torch.from_numpy(uncond), cond_emb,
        {k: torch.from_numpy(v) for k, v in masks.items()})
    assert len(clear_of_threshold) >= 2 * 6, "each step's injected blocks read the maps"
    assert out.shape == lat0.shape and torch.isfinite(out).all()
    assert_close(out, ref, atol=2e-3)


def test_spec_collects_maps_only_in_auto_mode():
    assert TI.InjectionSpec.from_start_layer(10, mask_mode="auto").collect_cross_maps
    assert not TI.InjectionSpec.from_start_layer(10).collect_cross_maps
    for mode in ("mask", "mutual", "auto"):
        t = TI.InjectionSpec.from_start_layer(10, mask_mode=mode)
        j = JI.InjectionSpec.from_start_layer(10, mask_mode=mode)
        assert (t.collect_cross_maps, t.mask_fgbg) == (j.collect_cross_maps, j.mask_fgbg)
