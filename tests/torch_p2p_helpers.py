"""Shared pieces of the prompt-to-prompt tests of the PyTorch port
(tests/test_torch_p2p_pipeline.py, _auto.py, _call.py, _call_refine.py and
_inference.py): the tiny models on converted weights, the controllers of
both packages, the generated clip, a denoise-segment comparison and the
LocalBlend threshold guard.

LocalBlend thresholds a max-normalized map: a pixel whose value lies within
float noise of the threshold could flip between the packages. The
``clear_of_threshold`` fixture wraps the port's ``LocalBlend.selection``
and asserts that every value it thresholds lies more than
``chip_smoke.P2P_MARGIN`` (1e-5) from the threshold, so the tests that use
it compare only outputs that no flip decided, and that the edit row's mask
has both sides. At random weights
the maps are nearly flat, so every value of the edit row clears the
config's 0.3 and the blend would keep every pixel: chip_smoke.py's
``clear_threshold`` (shared with its checks on the card) places the
threshold inside the range of the edit row's first map, at the first of a
few fractions of it whose run on the port clears that margin.

Tolerances: the UNet forward atol 3e-4, rtol 1e-4 and the segment atol
2e-3 (those of tests/test_torch_slice.py); the decoded videos atol 2e-3
(tests/test_torch_pipeline.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.control import p2p as JP
from motioneditor_tpu.control.injection import InjectionSpec as JaxInjectionSpec
from motioneditor_tpu.models import clip_text as JC
from motioneditor_tpu.models import vae as JV
from motioneditor_tpu.models.controlnet import init_controlnet
from motioneditor_tpu.models.controlnet import (
    precompute_cond_embedding as jax_precompute_cond_embedding,
)
from motioneditor_tpu.pipelines import editor as JE
from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule

from motioneditor_tpu_torch.control.injection import InjectionSpec
from motioneditor_tpu_torch.models import clip_text as TC
from motioneditor_tpu_torch.models import vae as TV
from motioneditor_tpu_torch.models.controlnet import (
    ControlNetModel,
    controlnet_config,
    precompute_cond_embedding,
)
from motioneditor_tpu_torch.models.from_jax import (
    clip_text_state_dict,
    controlnet_state_dict,
    vae_state_dict,
)
from motioneditor_tpu_torch.models.unet import UNetConfig
from motioneditor_tpu_torch.pipelines import editor as TE
from motioneditor_tpu_torch.schedulers import DiffusionSchedule

import chip_smoke as cs
from test_p2p import WordTokenizer
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

F, HW, SIZE = 2, 16, 128  # 16x16 latents: level 0 is a 256-token map site
STEPS = 6  # the segments' schedule: cross window [0, 4.8), self window [0, 2)
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
TEXT_KW = dict(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32)
PROMPTS = {"replace": ["a girl is dancing", "a man is dancing"],
           "refine": ["a girl is dancing", "a man is dancing outside"],
           "reweight": ["a girl is dancing", "a man is dancing"]}


def port_p2p():
    # imported where used: the C5 test runs against trees that predate the module
    from motioneditor_tpu_torch.control import p2p

    return p2p


def controllers(kind, tokenizer, num_steps=STEPS, words=("man",)):
    """(port controller, JAX controller, port LocalBlend, JAX LocalBlend)."""
    TP = port_p2p()
    kw = dict(self_replace_steps=0.4)
    if kind == "reweight":
        kw.update(equalizer_words=["man"], equalizer_values=[3.0])
    prompts = PROMPTS[kind]
    t = TP.make_controller(prompts, tokenizer, num_steps, **kw)
    j = JP.make_controller(prompts, tokenizer, num_steps, **kw)
    assert t.kind == j.kind == kind
    blends = (TP.make_local_blend(prompts, [list(words)] * 2, tokenizer),
              JP.make_local_blend(prompts, [list(words)] * 2, tokenizer))
    return (t, j) + blends


def recorded(blend, sel, record):
    """Append to ``record`` a LocalBlend call's least distance of a map
    value from the threshold, the edit row's range and its share above."""
    edit = sel[1]
    record.append(dict(gap=(sel - blend.threshold).abs().min().item(),
                       lo=edit.min().item(), hi=edit.max().item(),
                       share=(edit > blend.threshold).float().mean().item()))


@pytest.fixture
def clear_of_threshold(monkeypatch):
    """Wrap the port's LocalBlend.selection so every call asserts
    chip_smoke.P2P_MARGIN and an edit mask with both sides; returns the
    calls' records."""
    TP = port_p2p()
    calls = []
    inner = TP.LocalBlend.selection

    def checked(self, cross_maps, b, f, h, w):
        sel = inner(self, cross_maps, b, f, h, w)
        if type(self) is not TP.LocalBlend:  # clear_threshold's probes
            return sel
        recorded(self, sel, calls)
        assert calls[-1]["gap"] > cs.P2P_MARGIN, f"a LocalBlend map value lies {calls[-1]} " \
            "from the threshold"
        assert 0 < calls[-1]["share"] < 1, f"the edit mask is one-sided: {calls[-1]}"
        return sel

    monkeypatch.setattr(TP.LocalBlend, "selection", checked)
    return calls


@pytest.fixture(scope="module")
def models():
    """The tiny UNet and ControlNet: (JAX UNet tree, port UNet, JAX
    ControlNet tree, port ControlNet, JAX ControlNet config)."""
    setup_torch()
    unet_tree, unet = tiny_unet(seed=21)
    cn_jax_config = dataclasses.replace(JAX_TINY, video=False, use_sc_attn=False)
    cn_tree = random_params(lambda: init_controlnet(jax.random.PRNGKey(1), cn_jax_config),
                            seed=22)
    cn = ControlNetModel(controlnet_config(UNetConfig(**TINY_KW))).eval()
    cn.load_state_dict(controlnet_state_dict(cn_tree))
    return unet_tree, unet, to_jax(cn_tree), cn, cn_jax_config


@pytest.fixture(scope="module")
def pipelines(models):
    """The JAX and the port MotionEditorPipeline on the same weights."""
    unet_tree, unet, cn_params, cn, _ = models
    vae_tree = random_params(lambda: JV.init_vae(jax.random.PRNGKey(2), JV.VAEConfig(**VAE_KW)),
                             seed=25)
    text_tree = random_params(
        lambda: JC.init_clip_text(jax.random.PRNGKey(3), JC.CLIPTextConfig(**TEXT_KW)), seed=26)
    jpipe = JE.MotionEditorPipeline(
        unet_params=unet_tree, vae_params=to_jax(vae_tree), text_params=to_jax(text_tree),
        controlnet_params=cn_params, tokenizer=JC.StubTokenizer(), unet_config=JAX_TINY,
        vae_config=JV.VAEConfig(**VAE_KW), text_config=JC.CLIPTextConfig(**TEXT_KW),
        use_flash=False, null_text_dtype="float32")
    vae = TV.AutoencoderKL(TV.VAEConfig(**VAE_KW)).eval()
    vae.load_state_dict(vae_state_dict(vae_tree))
    text = TC.CLIPTextModel(TC.CLIPTextConfig(**TEXT_KW)).eval()
    text.load_state_dict(clip_text_state_dict(text_tree))
    pipe = TE.MotionEditorPipeline(unet=unet, vae=vae, text_encoder=text, controlnet=cn,
                                   tokenizer=TC.StubTokenizer(), unet_config=UNetConfig(**TINY_KW),
                                   vae_config=TV.VAEConfig(**VAE_KW),
                                   text_config=TC.CLIPTextConfig(**TEXT_KW), use_flash=False)
    return jpipe, pipe


def check_segment(models, calls, kind, mode):
    """Two injected steps (3 and 4 of a STEPS-step schedule: the cross
    window open, the self window closed) in ``mode`` with the ``kind``
    controller and LocalBlend, from a nonzero running map sum: the latents
    and the map sum against JAX's ``_jit_denoise_segment``. ``calls``: the
    ``clear_of_threshold`` fixture's list."""
    unet_tree, unet, cn_params, cn, cn_jax_config = models
    TP = port_p2p()
    t_ctl, j_ctl, t_lb, _ = controllers(kind, WordTokenizer())
    rng = np.random.default_rng(24)
    lat0 = normal(rng, (2, F, HW, HW, 4), 0.3)
    cond, uncond = (normal(rng, (2, 77, 16), 0.3) for _ in range(2))
    skel = rng.random((2, F, 8 * HW, 8 * HW, 3)).astype(np.float32)
    masks = {(s, s): (rng.random((F, s * s, 1)) > 0.5).astype(np.float32)
             for s in (16, 8, 4, 2)}
    maps0 = rng.random((5, 4 * F, 256, 77), dtype=np.float32) * 0.01
    seg_ts = JaxSchedule().inference_timesteps(STEPS)[3:5]
    spec_kw = dict(mask_mode="auto", auto_token_idx=(2,), auto_thres=0.5) if mode == "auto" \
        else {}

    with torch.no_grad():
        cond_emb = precompute_cond_embedding(cn, torch.from_numpy(skel))
    tiny = UNetConfig(**TINY_KW)

    def run_port(blend):
        maps_sum = torch.from_numpy(maps0.copy())
        out = TE.denoise_segment(
            unet, tiny, cn, controlnet_config(tiny), DiffusionSchedule(), STEPS,
            InjectionSpec.from_start_layer(10, **spec_kw), 7.5, 1.0, torch.from_numpy(lat0),
            seg_ts, torch.from_numpy(cond), torch.from_numpy(uncond), cond_emb,
            {k: torch.from_numpy(v) for k, v in masks.items()}, use_flash=False,
            p2p_controller=t_ctl, local_blend=blend, seg_lo=3, maps_sum=maps_sum)
        return out, maps_sum

    threshold = cs.clear_threshold(t_lb.alpha_layers, run_port)
    j_lb = JP.LocalBlend(alpha_layers=t_lb.alpha_layers, threshold=threshold)
    cond_emb_jax = jax_precompute_cond_embedding(cn_params, jnp.asarray(skel))
    seg_fn = JE._jit_denoise_segment(
        JAX_TINY, cn_jax_config, JaxSchedule(), STEPS,
        JaxInjectionSpec.from_start_layer(10, **spec_kw), 7.5, 1.0, False, False, j_ctl, j_lb, 3)
    ref, ref_maps = seg_fn(unet_tree, cn_params, jnp.asarray(lat0), jnp.asarray(seg_ts),
                           jnp.asarray(cond), jnp.asarray(uncond),
                           jnp.zeros((len(seg_ts), 1, 1, 1)), cond_emb_jax,
                           {k: jnp.asarray(v) for k, v in masks.items()}, jnp.asarray(maps0))
    out, maps_sum = run_port(TP.LocalBlend(alpha_layers=t_lb.alpha_layers, threshold=threshold))
    assert len(calls) == len(seg_ts)
    assert out.shape == lat0.shape and torch.isfinite(out).all()
    assert_close(out, ref, atol=2e-3)
    assert_close(maps_sum, ref_maps, atol=1e-4)


def check_call(pipelines, calls, kind, start_step):
    """``__call__`` from latents to the decoded video on a 4-step schedule
    from ``start_step`` (2: a vanilla and an injected segment, the step
    index carried across them), the controller and LocalBlend on both
    packages; and the controller must move the edit."""
    jpipe, pipe = pipelines
    TP = port_p2p()
    t_ctl, j_ctl, t_lb, _ = controllers(kind, pipe.tokenizer, num_steps=4)
    rng = np.random.default_rng(27)
    lat = normal(rng, (1, F, HW, HW, 4), 0.3)
    seed = np.concatenate([lat, lat])
    skel = rng.random((F, SIZE, SIZE, 3)).astype(np.float32)
    masks = (rng.random((F, SIZE, SIZE)) > 0.5).astype(np.float32)
    kw = dict(num_inference_steps=4, start_step=start_step)

    def run_port(blend, decode=False):
        return pipe(PROMPTS[kind], torch.from_numpy(seed), torch.from_numpy(skel),
                    source_masks=torch.from_numpy(masks), p2p_controller=t_ctl,
                    local_blend=blend, decode=decode, **kw)

    threshold = cs.clear_threshold(t_lb.alpha_layers, run_port)
    j_lb = JP.LocalBlend(alpha_layers=t_lb.alpha_layers, threshold=threshold)
    got = run_port(TP.LocalBlend(alpha_layers=t_lb.alpha_layers, threshold=threshold), True)
    ref = jpipe(PROMPTS[kind], jnp.asarray(seed), jnp.asarray(skel),
                source_masks=jnp.asarray(masks), p2p_controller=j_ctl, local_blend=j_lb, **kw)
    assert len(calls) == 4
    assert got.shape == (2, F, SIZE, SIZE, 3) and torch.isfinite(got).all()
    assert_close(got, ref, atol=2e-3)
    plain = pipe(PROMPTS[kind], torch.from_numpy(seed), torch.from_numpy(skel),
                 source_masks=torch.from_numpy(masks), **kw)
    assert (got[1] - plain[1]).abs().max() > 1e-2


def write_clip(root, seed: int = 28):
    """A data/case-N layout of F PNG frames, pose images and masks under
    ``root`` (a pathlib.Path)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    dirs = ("images", "source_condition/openposefull", "target_condition/openposefull",
            "man.mask")
    for d in dirs:
        (root / d).mkdir(parents=True)
    for i in range(F):
        for d in dirs[:3]:
            Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(
                root / d / f"{i:05d}.png")
        mask = np.zeros((SIZE, SIZE), np.uint8)
        mask[24 + 8 * i:96, 32:100] = 255
        Image.fromarray(mask).save(root / "man.mask" / f"{i:05d}.png")
    return str(root)
