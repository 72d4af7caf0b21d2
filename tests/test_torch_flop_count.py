"""The port's kernel flop counter (ops/flop_count.py) against the JAX
package's, as exact integers.

JAX counts at trace time: its side is ``kernel_flop_counter`` around
``jax.jit(fn).lower(...)`` on abstract shapes (lowering traces, nothing runs
in interpret mode; the tracing caches are cleared first so every hook
fires). The port counts on each call: its side is one call on CPU tensors,
which counts before taking the plain version, as the card's launch would.
Then a one-step tiny denoise segment at 32x32 latents (level 0 reaches the
N >= 1024 gate) and a tiny stage-1 step with gradient checkpointing (the
recompute in the backward must not count twice). Their UNet is the tiny one
at 64 channels on every level: at 32 the adapter's 8 temporal heads have
d = 4, which JAX's K3 takes and the port's (d % 8 == 0) leaves to its plain
path, so the two would route that site differently (no SD-1.5 site has
d % 8 != 0).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from motioneditor_tpu.control.injection import InjectionSpec as JaxInjectionSpec
from motioneditor_tpu.models import layers as jax_layers
from motioneditor_tpu.models.controlnet import init_controlnet
from motioneditor_tpu.models.controlnet import (
    precompute_cond_embedding as jax_precompute_cond_embedding,
)
from motioneditor_tpu.models.unet import UNetConfig as JaxUNetConfig
from motioneditor_tpu.models.unet import init_unet
from motioneditor_tpu.ops import flash_attention as JF
from motioneditor_tpu.ops import fused_norm as JN
from motioneditor_tpu.ops import gn_stats as JG
from motioneditor_tpu.ops import injection_flash as JI
from motioneditor_tpu.ops import temporal_flash as JT
from motioneditor_tpu.ops import video_flash as JV
from motioneditor_tpu.ops import video_flash_bwd as JB
from motioneditor_tpu.ops.flop_count import kernel_flop_counter as jax_counter
from motioneditor_tpu.pipelines.editor import _jit_denoise_segment
from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule
from motioneditor_tpu.training import common as JC
from motioneditor_tpu.training.stage1 import TRAINABLE_MODULES as JAX_MODULES
from motioneditor_tpu.training.stage1 import train_step_stage1 as jax_stage1

from motioneditor_tpu_torch.control.injection import InjectionSpec
from motioneditor_tpu_torch.models import layers as port_layers
from motioneditor_tpu_torch.models.controlnet import (
    ControlNetModel,
    controlnet_config,
    precompute_cond_embedding,
)
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from motioneditor_tpu_torch.ops import flash_attention as PF
from motioneditor_tpu_torch.ops import fused_norm as PN
from motioneditor_tpu_torch.ops import gn_stats as PG
from motioneditor_tpu_torch.ops import injection_flash as PI
from motioneditor_tpu_torch.ops import temporal_flash as PT
from motioneditor_tpu_torch.ops import video_flash as PV
from motioneditor_tpu_torch.ops import video_flash_bwd as PB
from motioneditor_tpu_torch.ops.flop_count import kernel_flop_counter
from motioneditor_tpu_torch.pipelines.editor import denoise_segment
from motioneditor_tpu_torch.schedulers import DiffusionSchedule
from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state
from motioneditor_tpu_torch.training.stage1 import TRAINABLE_MODULES, train_step_stage1

from torch_port_helpers import TINY_KW, setup_torch

B, F, N, C, HEADS = 1, 3, 256, 64, 2
SCALE = (C // HEADS) ** -0.5


def jax_flops(fn, *shapes) -> int:
    """JAX's kernel flops of ``fn`` traced on arrays of ``shapes`` (float32
    unless a shape is given as (shape, dtype)); nothing runs."""
    args = [jax.ShapeDtypeStruct(*s) if isinstance(s[0], tuple) else
            jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    jax.clear_caches()
    with jax_counter() as kc:
        jax.jit(fn).lower(*args)
    return kc.flops


def port_flops(fn, *shapes):
    """The port's kernel flops of one call of ``fn`` on seeded CPU tensors
    of ``shapes``, and their breakdown by entry."""
    gen = torch.Generator().manual_seed(0)
    args = [torch.rand(s, generator=gen) for s in shapes]
    with kernel_flop_counter() as kc:
        fn(*args)
    return kc.flops, dict(kc.by_entry)


def q4(n=N, c=C, f=F):
    return (B, f, n, c)


# (entry, JAX function, port function, shapes): one call of each counted entry
COUNTED = {
    **{f"video_flash_attention[{mode}]": (
        "video_flash_attention",
        lambda q, k, v, mode=mode: JV.video_flash_attention(q, k, v, mode, SCALE, HEADS),
        lambda q, k, v, mode=mode: PV.video_flash_attention(q, k, v, mode, SCALE, HEADS),
        (q4(), q4(), q4())) for mode in ("normal", "sparse_causal", "motion_frame", "dense")},
    "video_injection_attention": (
        "video_injection_attention",
        lambda q, ks, vs, kt, vt, m: JV.video_injection_attention(q, ks, vs, kt, vt, m, SCALE,
                                                                  HEADS),
        lambda q, ks, vs, kt, vt, m: PV.video_injection_attention(q, ks, vs, kt, vt, m, SCALE,
                                                                  HEADS),
        (q4(),) * 5 + ((F, N),)),
    "temporal_flash_attention": (
        "temporal_flash_attention",
        lambda q, k, v: JT.temporal_flash_attention(q, k, v, SCALE, HEADS),
        lambda q, k, v: PT.temporal_flash_attention(q, k, v, SCALE, HEADS),
        (q4(512), q4(512), q4(512))),
    "flash_attention": (
        "flash_attention",
        lambda q, k, v: JF.flash_attention(q, k, v, 32 ** -0.5),
        lambda q, k, v: PF.flash_attention(q, k, v, 32 ** -0.5),
        ((B, 2, HEADS, 256, 32), (B, 2, HEADS, 384, 32), (B, 2, HEADS, 384, 32))),
    "fused_injection_attention": (
        "fused_injection_attention",
        lambda q, ks, vs, m, kt, vt: JI.fused_injection_attention(q, ks, vs, m, kt, vt, 0.25),
        lambda q, ks, vs, m, kt, vt: PI.fused_injection_attention(q, ks, vs, m, kt, vt, 0.25),
        ((B, F, HEADS, 256, 16), (B, F, HEADS, 512, 16), (B, F, HEADS, 512, 16), (F, 512),
         (B, F, HEADS, 256, 16), (B, F, HEADS, 256, 16))),
    "channel_pair_stats": (
        "channel_pair_stats",
        JG.channel_pair_stats,
        PG.channel_pair_stats,
        ((2, 64, 32), (2, 64, 32))),
    **{f"video_flash_attention_kv[fk={fk}]": (
        "video_flash_attention_kv",
        lambda q, k, v: JV.video_flash_attention_kv(q, k, v, SCALE, HEADS),
        lambda q, k, v: PV.video_flash_attention_kv(q, k, v, SCALE, HEADS),
        (q4(), q4(512, f=fk), q4(512, f=fk))) for fk in (1, F)},
    "video_injection_attention_kv": (
        "video_injection_attention_kv",
        lambda q, ks, vs, kt, vt, m: JV.video_injection_attention_kv(q, ks, vs, kt, vt, m, SCALE,
                                                                     HEADS),
        lambda q, ks, vs, kt, vt, m: PV.video_injection_attention_kv(q, ks, vs, kt, vt, m, SCALE,
                                                                     HEADS),
        (q4(), q4(512), q4(512), q4(), q4(), (F, 512))),
}


@pytest.fixture
def knobs_on(monkeypatch):
    monkeypatch.setenv("MOTIONEDITOR_FUSED_GN", "1")
    monkeypatch.setenv("MOTIONEDITOR_FUSED_LN", "1")


@pytest.mark.parametrize("case", sorted(COUNTED))
def test_entry_counts_as_jax(case, knobs_on):
    entry, jax_fn, port_fn, shapes = COUNTED[case]
    ref = jax_flops(jax_fn, *shapes)
    got, by_entry = port_flops(port_fn, *shapes)
    assert ref > 0
    assert got == ref
    assert by_entry == {entry: ref}


def test_group_norm_counts_as_jax(knobs_on):
    """K10 through the GroupNorm that routes to it: its forward statistics
    (the gradient's reduction is the backward's, counted there)."""
    shape, groups = (1, 2, 4, 4, 32), 8
    ref = jax_flops(lambda x, s, b: jax_layers.group_norm({"scale": s, "bias": b}, x, groups),
                    shape, (32,), (32,))
    norm = nn.GroupNorm(groups, 32)
    got, by_entry = port_flops(lambda x: port_layers.group_norm(norm, x, groups), shape)
    assert ref == got == 3 * 2 * 16 * 32 and by_entry == {"channel_pair_stats": ref}


def test_add_layer_norm_counts_as_jax(knobs_on):
    shape = (1, 2, 64, 32)
    ref = jax_flops(lambda t, d, s, b: JN.add_layer_norm({"scale": s, "bias": b}, t, d),
                    shape, shape, (32,), (32,))
    got, by_entry = port_flops(lambda t, d: PN.add_layer_norm(nn.LayerNorm(32), t, d),
                               shape, shape)
    assert ref == got == 8 * 2 * 64 * 32 and by_entry == {"add_layer_norm": ref}


def test_knobs_off_count_nothing(monkeypatch):
    """With the knobs off (the default) neither package reaches K10 or K11."""
    monkeypatch.delenv("MOTIONEDITOR_FUSED_GN", raising=False)
    monkeypatch.delenv("MOTIONEDITOR_FUSED_LN", raising=False)
    norm = nn.GroupNorm(8, 32)
    assert port_flops(lambda x: port_layers.group_norm(norm, x, 8), (1, 2, 4, 4, 32))[0] == 0
    assert jax_flops(lambda x, s, b: jax_layers.group_norm({"scale": s, "bias": b}, x, 8),
                     (1, 2, 4, 4, 32), (32,), (32,)) == 0
    assert jax_flops(lambda t, d, s, b: JN.add_layer_norm({"scale": s, "bias": b}, t, d),
                     (1, 2, 64, 32), (1, 2, 64, 32), (32,), (32,)) == 0


LSE = ((B, F, N, 128), jnp.float32)
UNCOUNTED = {
    "video_flash_fwd_res": (
        lambda q, k, v: JB.video_flash_fwd_res(q, k, v, "motion_frame", SCALE, HEADS, 256, 256,
                                               True),
        lambda q, k, v: PB.video_flash_fwd_res(q, k, v, "motion_frame", SCALE, HEADS),
        (q4(),) * 3),
    "video_flash_bwd": (  # K5 + K6
        lambda q, k, v, o, lse, do: JB.video_flash_bwd(q, k, v, o, lse, do, "motion_frame",
                                                       SCALE, HEADS, 256, 256, True),
        lambda q, k, v, o, do: PB.video_flash_bwd(
            q, k, v, o, PB.video_flash_fwd_res(q, k, v, "motion_frame", SCALE, HEADS)[1], do,
            "motion_frame", SCALE, HEADS),
        (q4(),) * 4 + (LSE, q4())),
    "temporal_flash_attention_bwd": (
        lambda q, k, v, do: JT._temporal_4d_bwd(q, k, v, do, SCALE, HEADS, True, True),
        lambda q, k, v, do: PT.temporal_flash_attention_bwd(q, k, v, do, SCALE, HEADS),
        (q4(512),) * 4),
    "temporal_flash_attention_global": (
        lambda q, k, v: JT.temporal_flash_attention_global(q, k, v, SCALE, HEADS, True, 1),
        lambda q, k, v: PT.temporal_flash_attention_global(q, k, v, SCALE, HEADS, True, 1),
        (q4(512, f=2), q4(512), q4(512))),
}


@pytest.mark.parametrize("case", sorted(UNCOUNTED))
def test_uncounted_entries_count_zero(case):
    """K4-K7 and K14 count nothing in JAX, nor in the port."""
    jax_fn, port_fn, shapes = UNCOUNTED[case]
    assert jax_flops(jax_fn, *shapes) == 0
    port_shapes = [s for s in shapes if s is not LSE]
    assert port_flops(port_fn, *port_shapes) == (0, {})


SEG_F, HW = 2, 32  # 32x32 latents: level 0 has N = 1024 tokens, the flash gate
WIDE_KW = dict(TINY_KW, block_out_channels=(64, 64, 64, 64))
JAX_WIDE = JaxUNetConfig(**WIDE_KW)


def tiny_models():
    setup_torch()
    torch.manual_seed(0)
    config = UNetConfig(**WIDE_KW)
    return config, UNet3DConditionModel(config).eval(), ControlNetModel(
        controlnet_config(config)).eval()


def test_denoise_segment_counts_as_jax():
    """One injected step of the tiny segment: K1, K2 and K3 at level 0 and
    the temporal sites at N >= 512, as JAX's lowered segment (its scan body
    is traced once)."""
    cn_jax = dataclasses.replace(JAX_WIDE, video=False, use_sc_attn=False)
    lat, text = (2, SEG_F, HW, HW, 4), (2, 7, 16)
    skel = (2, SEG_F, 8 * HW, 8 * HW, 3)
    sizes = (HW, HW // 2, HW // 4, HW // 8)
    cn_shapes = jax.eval_shape(lambda: init_controlnet(jax.random.PRNGKey(1), cn_jax))
    shape = lambda t: jax.ShapeDtypeStruct(t.shape, t.dtype)  # noqa: E731
    seg = _jit_denoise_segment(JAX_WIDE, cn_jax, JaxSchedule(), 50,
                               JaxInjectionSpec.from_start_layer(10), 7.5, 1.0, True, False)
    f32 = lambda s: jax.ShapeDtypeStruct(s, jnp.float32)  # noqa: E731
    jax.clear_caches()
    with jax_counter() as kc:
        seg.lower(jax.eval_shape(lambda: init_unet(jax.random.PRNGKey(0), JAX_WIDE)),
                  cn_shapes, f32(lat), jax.ShapeDtypeStruct((1,), jnp.int32), f32(text),
                  f32(text), f32((2, 1, 1, 1)),
                  shape(jax.eval_shape(jax_precompute_cond_embedding, cn_shapes, f32(skel))),
                  {(s, s): f32((SEG_F, s * s, 1)) for s in sizes}, f32(()))
    assert kc.flops > 0

    config, unet, cn = tiny_models()
    rng = np.random.default_rng(0)
    t = lambda s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    schedule = DiffusionSchedule()
    with torch.no_grad():
        cond_emb = precompute_cond_embedding(cn, torch.rand(skel))
        masks = {(s, s): (t((SEG_F, s * s, 1)) > 0).float() for s in sizes}
        with kernel_flop_counter() as pc:
            out = denoise_segment(unet, config, cn, controlnet_config(config), schedule, 50,
                                  InjectionSpec.from_start_layer(10), 7.5, 1.0, t(lat),
                                  schedule.inference_timesteps(50)[4:5], t(text), t(text),
                                  cond_emb, masks)
    assert out.shape == lat and torch.isfinite(out).all()
    assert pc.flops == kc.flops
    assert set(pc.by_entry) == {"video_flash_attention", "video_injection_attention",
                                "temporal_flash_attention"}
    assert sum(pc.by_entry.values()) == pc.flops


def test_checkpointed_stage1_step_counts_as_jax():
    """A stage-1 step with gradient checkpointing: JAX traces each
    checkpointed block once; the port's recompute in the backward runs the
    forward's kernel entries again and must not count them."""
    lat, enc = (1, SEG_F, HW, HW, 4), (1, 7, 16)
    optimizer = JC.make_optimizer(learning_rate=1e-3)
    state = jax.eval_shape(lambda: JC.make_train_state(
        init_unet(jax.random.PRNGKey(0), JAX_WIDE), list(JAX_MODULES), optimizer))
    jax.clear_caches()
    with jax_counter() as kc:
        jax_stage1.lower(state, jax.ShapeDtypeStruct(lat, jnp.float32),
                         jax.ShapeDtypeStruct(enc, jnp.float32), jax.random.PRNGKey(0),
                         unet_config=JAX_WIDE, schedule=JaxSchedule(), optimizer=optimizer,
                         remat=True)
    assert kc.flops > 0

    config, unet, _ = tiny_models()
    train_state = make_train_state(unet, TRAINABLE_MODULES, make_optimizer(learning_rate=1e-3))
    gen = torch.Generator().manual_seed(0)
    with kernel_flop_counter() as pc:
        _, metrics = train_step_stage1(train_state, torch.randn(lat, generator=gen),
                                       torch.randn(enc, generator=gen), gen, config, remat=True)
    assert torch.isfinite(metrics["loss"])
    assert pc.flops == kc.flops
    assert set(pc.by_entry) == {"video_flash_attention", "temporal_flash_attention"}
