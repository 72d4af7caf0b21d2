"""Prompt-to-prompt control through the port's UNet and denoise segment
against the JAX package on the same converted weights, fp32 on the CPU:
the UNet forward with an editor and its 16x16 maps, and the mask-mode
segment with each controller and LocalBlend (tests/torch_p2p_helpers.py
holds the shared pieces, the tolerances and the threshold guard; the
auto-mask segment is in tests/test_torch_p2p_auto.py, ``__call__`` and
the entry point in tests/test_torch_p2p_call.py, _call_refine.py and
_inference.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.models.unet import unet_apply as jax_unet_apply
from motioneditor_tpu.pipelines import editor as JE

from motioneditor_tpu_torch.models.controlnet import controlnet_config
from motioneditor_tpu_torch.models.unet import UNetConfig, unet_apply
from motioneditor_tpu_torch.pipelines import editor as TE
from motioneditor_tpu_torch.schedulers import DiffusionSchedule

from test_p2p import WordTokenizer
from torch_p2p_helpers import (  # noqa: F401 (fixtures)
    F,
    HW,
    STEPS,
    check_segment,
    clear_of_threshold,
    controllers,
    models,
)
from torch_port_helpers import JAX_TINY, TINY_KW, assert_close, normal


def test_count_16x16_sites_matches_jax():
    for h, w in ((16, 16), (32, 32), (64, 64), (64, 32), (8, 8), (128, 128), (48, 48)):
        assert TE._count_16x16_sites(h, w) == JE._count_16x16_sites(h, w)
    assert TE._count_16x16_sites(64, 64) == 5 and TE._count_16x16_sites(8, 8) == 0


@pytest.mark.parametrize("normal_infer", [False, True])
def test_unet_forward_with_editor_matches_jax(models, normal_infer):
    """Inside the self window (step 1): with normal_infer the attn1 editor
    acts at the 16x16 level, without it only attn2's. The maps out, in
    forward order, collected before the edit."""
    unet_tree, unet = models[:2]
    t_ctl, j_ctl = controllers("replace", WordTokenizer())[:2]
    rng = np.random.default_rng(23)
    x = normal(rng, (4, F, HW, HW, 4))
    enc = normal(rng, (4, 77, 16))
    t = 500

    @jax.jit
    def jax_forward(params, x, enc):
        maps = []
        out = jax_unet_apply(params, JAX_TINY, x, jnp.asarray(t), enc, normal_infer=normal_infer,
                             use_flash=False, prob_editor=j_ctl.prob_editor(1),
                             _cross_maps_out=maps)
        return out, maps

    ref, ref_maps = jax_forward(unet_tree, jnp.asarray(x), jnp.asarray(enc))
    maps, plain_maps = [], []
    with torch.no_grad():
        out = unet_apply(unet, UNetConfig(**TINY_KW), torch.from_numpy(x), t,
                         torch.from_numpy(enc), normal_infer=normal_infer,
                         prob_editor=t_ctl.prob_editor(1), cross_maps_out=maps)
        plain = unet_apply(unet, UNetConfig(**TINY_KW), torch.from_numpy(x), t,
                           torch.from_numpy(enc), normal_infer=normal_infer,
                           cross_maps_out=plain_maps)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert_close(out, ref, atol=3e-4, rtol=1e-4)
    assert len(maps) == len(ref_maps) == TE._count_16x16_sites(HW, HW) == 5
    for got, want in zip(maps, ref_maps):
        assert got.shape == (4 * F, 256, 77)
        assert_close(got, want, atol=1e-5)
    # the editor changes only the conditional edit row
    assert torch.equal(out[:3], plain[:3]) and not torch.allclose(out[3], plain[3], atol=1e-3)
    # the first site's maps are collected before its attn2 edit: only an
    # attn1 edit before them (normal_infer) moves the edit row's
    assert torch.equal(maps[0][:3 * F], plain_maps[0][:3 * F])
    assert torch.equal(maps[0], plain_maps[0]) == (not normal_infer)


@pytest.mark.parametrize("kind", ["replace", "refine", "reweight"])
def test_segment_with_p2p_matches_jax(models, clear_of_threshold, kind):
    check_segment(models, clear_of_threshold, kind, "mask")


def test_segment_needs_the_map_sum_for_local_blend(models):
    _, unet, _, cn, _ = models
    blend = controllers("replace", WordTokenizer())[2]
    tiny = UNetConfig(**TINY_KW)
    with pytest.raises(ValueError, match="maps_sum"):
        TE.denoise_segment(unet, tiny, cn, controlnet_config(tiny), DiffusionSchedule(), STEPS,
                           None, 7.5, 1.0, torch.zeros((2, F, HW, HW, 4)), [1], None, None,
                           None, None, local_blend=blend)
