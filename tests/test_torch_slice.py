"""The port's injected denoise step against the JAX package, on the same
converted weights, at a tiny size on the CPU.

At 16x16 latents no attention site reaches the kernels' size gates, so both
packages take their plain paths here; the kernels are held against the JAX
Pallas kernels in tests/test_torch_video_flash.py and
tests/test_torch_temporal_flash.py. Tolerances are those of
tests/test_full_oracle.py (one injected UNet forward; the multi-step loop),
also for the segment that reads one null-text uncond embedding per step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.control.injection import InjectionSpec as JaxInjectionSpec
from motioneditor_tpu.models.controlnet import init_controlnet
from motioneditor_tpu.models.controlnet import (
    precompute_cond_embedding as jax_precompute_cond_embedding,
)
from motioneditor_tpu.models.unet import init_unet, unet_apply as jax_unet_apply
from motioneditor_tpu.pipelines.editor import _jit_denoise_segment
from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule

from motioneditor_tpu_torch.control.injection import InjectionSpec
from motioneditor_tpu_torch.models.controlnet import (
    ControlNetModel,
    controlnet_config,
    precompute_cond_embedding,
)
from motioneditor_tpu_torch.models.from_jax import controlnet_state_dict, unet_state_dict
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig, unet_apply
from motioneditor_tpu_torch.pipelines.editor import denoise_segment
from motioneditor_tpu_torch.schedulers import DiffusionSchedule

from torch_port_helpers import (
    JAX_TINY,
    TINY_KW,
    assert_close,
    normal,
    random_params,
    setup_torch,
    to_jax,
)

TINY = UNetConfig(**TINY_KW)
F, HW = 3, 16


@pytest.fixture(scope="module")
def weights():
    setup_torch()
    unet_tree = random_params(lambda: init_unet(jax.random.PRNGKey(0), JAX_TINY), seed=1)
    cn_jax_config = dataclasses.replace(JAX_TINY, video=False, use_sc_attn=False)
    cn_tree = random_params(lambda: init_controlnet(jax.random.PRNGKey(1), cn_jax_config),
                            seed=2)
    unet = UNet3DConditionModel(TINY).eval()
    unet.load_state_dict(unet_state_dict(unet_tree))
    cn = ControlNetModel(controlnet_config(TINY)).eval()
    cn.load_state_dict(controlnet_state_dict(cn_tree))
    return unet_tree, cn_tree, cn_jax_config, unet, cn


def _masks(rng):
    return {(s, s): (rng.random((F, s * s, 1)) > 0.5).astype(np.float32)
            for s in (16, 8, 4, 2)}


def test_injected_unet_forward_matches_jax(weights):
    unet_tree, _, _, unet, _ = weights
    rng = np.random.default_rng(3)
    x = normal(rng, (4, F, HW, HW, 4))
    enc = normal(rng, (4, 7, 16))
    sizes = [16, 16, 16, 8, 8, 8, 4, 4, 4, 2, 2, 2]
    chans = [32, 32, 32, 32, 64, 64, 64, 64, 64, 64, 64, 64]
    down = [normal(rng, (2, F, s, s, c), 0.1) for s, c in zip(sizes, chans)]
    mid2 = normal(rng, (2, F, 2, 2, 64), 0.1)
    mid4 = np.concatenate([0 * mid2[:1], mid2[:1], 0 * mid2[:1], mid2[1:]], axis=0)
    masks = _masks(rng)
    t = 321

    @jax.jit
    def jax_forward(params, x, enc, masks, down, mid):
        return jax_unet_apply(
            params, JAX_TINY, x, jnp.asarray(t), enc,
            injection=JaxInjectionSpec.from_start_layer(10), injection_masks=masks,
            down_block_additional_residuals=down, mid_block_additional_residual=mid,
        )

    ref = jax_forward(
        to_jax(unet_tree), jnp.asarray(x), jnp.asarray(enc),
        {k: jnp.asarray(v) for k, v in masks.items()}, [jnp.asarray(d) for d in down],
        jnp.asarray(mid4),
    )
    with torch.no_grad():
        out = unet_apply(
            unet, TINY, torch.from_numpy(x), t, torch.from_numpy(enc),
            injection=InjectionSpec.from_start_layer(10),
            injection_masks={k: torch.from_numpy(v) for k, v in masks.items()},
            down_block_additional_residuals=[torch.from_numpy(d) for d in down],
            mid_block_additional_residual=torch.from_numpy(mid4),
        )
    assert out.shape == (4, F, HW, HW, 4)
    assert_close(out, ref, atol=3e-4, rtol=1e-4)


@pytest.mark.parametrize("per_step_uncond", [False, True])
def test_denoise_segment_matches_jax(weights, per_step_uncond):
    """Two injected steps; with ``per_step_uncond`` step idx reads the
    null-text embedding seg_uncond[idx] [1, L, D] broadcast to cond's shape
    (editor.py:475-479) and the shared uncond goes unused."""
    unet_tree, cn_tree, cn_jax_config, unet, cn = weights
    rng = np.random.default_rng(4)
    lat0 = normal(rng, (2, F, HW, HW, 4), 0.3)
    cond = normal(rng, (2, 7, 16), 0.3)
    uncond = normal(rng, (2, 7, 16), 0.3)
    seg_uncond = normal(rng, (2, 1, 7, 16), 0.3)
    skel = rng.random((2, F, 8 * HW, 8 * HW, 3)).astype(np.float32)
    masks = _masks(rng)
    num_steps, guidance = 50, 7.5
    seg_ts = JaxSchedule().inference_timesteps(num_steps)[4:6]

    cn_params = to_jax(cn_tree)
    cond_emb_jax = jax_precompute_cond_embedding(cn_params, jnp.asarray(skel))
    seg_fn = _jit_denoise_segment(
        JAX_TINY, cn_jax_config, JaxSchedule(), num_steps,
        JaxInjectionSpec.from_start_layer(10), guidance, 1.0, True, per_step_uncond,
    )
    ref, _ = seg_fn(
        to_jax(unet_tree), cn_params, jnp.asarray(lat0),
        jnp.asarray(seg_ts), jnp.asarray(cond), jnp.asarray(uncond),
        jnp.asarray(seg_uncond) if per_step_uncond else jnp.zeros((len(seg_ts), 1, 1, 1)),
        cond_emb_jax, {k: jnp.asarray(v) for k, v in masks.items()}, jnp.zeros(()),
    )

    with torch.no_grad():
        cond_emb = precompute_cond_embedding(cn, torch.from_numpy(skel))
    assert_close(cond_emb, cond_emb_jax, atol=1e-4)
    out = denoise_segment(
        unet, TINY, cn, controlnet_config(TINY), DiffusionSchedule(), num_steps,
        InjectionSpec.from_start_layer(10), guidance, 1.0, torch.from_numpy(lat0),
        seg_ts, torch.from_numpy(cond), None if per_step_uncond else torch.from_numpy(uncond),
        cond_emb, {k: torch.from_numpy(v) for k, v in masks.items()},
        seg_uncond=torch.from_numpy(seg_uncond) if per_step_uncond else None,
    )
    assert out.shape == lat0.shape
    assert torch.isfinite(out).all()
    assert_close(out, ref, atol=2e-3)
