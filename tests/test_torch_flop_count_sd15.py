"""The kernel flops of one injected denoise step of SD-1.5 at full width,
8 frames of 64x64 latents, three ways, equal as integers: the closed form
chip_smoke.py asserts on the card (``denoise_step_kernel_flops``), the
port's counter on the meta device (every wrapper's CUDA dispatch down to a
stand-in kernel library that launches nothing, as in
tests/test_torch_sharding_phases_counts.py) and JAX's counter around its
lowered ``_jit_denoise_segment`` of one step."""

import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke as cs
from motioneditor_tpu.control.injection import InjectionSpec as JaxInjectionSpec
from motioneditor_tpu.models.controlnet import controlnet_config as jax_controlnet_config
from motioneditor_tpu.models.controlnet import init_controlnet
from motioneditor_tpu.models.controlnet import (
    precompute_cond_embedding as jax_precompute_cond_embedding,
)
from motioneditor_tpu.models.unet import UNetConfig as JaxUNetConfig
from motioneditor_tpu.models.unet import init_unet
from motioneditor_tpu.ops.flop_count import kernel_flop_counter as jax_counter
from motioneditor_tpu.pipelines.editor import _jit_denoise_segment
from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.control.injection import InjectionSpec, prepare_injection_masks
from motioneditor_tpu_torch.models.controlnet import (
    ControlNetModel,
    controlnet_config,
    precompute_cond_embedding,
)
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from motioneditor_tpu_torch.ops.flop_count import kernel_flop_counter
from motioneditor_tpu_torch.pipelines.editor import denoise_segment
from motioneditor_tpu_torch.schedulers import DiffusionSchedule

META, BF16 = torch.device("meta"), torch.bfloat16
F, LAT = cs.FRAMES, cs.LATENT


class StandInLibrary:
    """The kernel library's ``me_*`` entry points, each returning 0
    (launched) and launching nothing."""

    def __getattr__(self, name):
        if not name.startswith("me_"):
            raise AttributeError(name)
        return lambda *args: 0


@pytest.fixture(scope="module")
def closed_form():
    return cs.denoise_step_kernel_flops(UNetConfig(), F, LAT, cs.INJECTION_START)


def test_port_step_counts_the_closed_form(closed_form, monkeypatch):
    monkeypatch.setattr(_build, "kernels", StandInLibrary)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_build, "check_operands", lambda *args, **kwargs: None)
    config, cn_config = UNetConfig(), controlnet_config()
    with META:
        unet, cn = UNet3DConditionModel(config), ControlNetModel(cn_config)
    unet, cn = unet.to(BF16).eval(), cn.to(BF16).eval()
    schedule = DiffusionSchedule()

    def empty(*shape):
        return torch.empty(shape, device=META, dtype=BF16)

    _build.reset_launch_counts()
    try:
        with kernel_flop_counter() as kc:
            denoise_segment(unet, config, cn, cn_config, schedule, 50,
                            InjectionSpec.from_start_layer(cs.INJECTION_START), 7.5, 1.0,
                            empty(2, F, LAT, LAT, 4), schedule.inference_timesteps(50)[4:5],
                            empty(2, 77, 768), empty(2, 77, 768),
                            precompute_cond_embedding(cn, empty(2, F, 8 * LAT, 8 * LAT, 3)),
                            prepare_injection_masks(empty(F, LAT, LAT), F))
        launched = {k for k, v in _build.launch_counts.items() if v and not k.endswith(".tc")
                    and not k.startswith(cs.UNCOUNTED_KERNELS)}
        launches = dict(_build.launch_counts)
    finally:
        _build.reset_launch_counts()  # leave no stand-in launch for later tests
    assert dict(kc.by_entry) == closed_form
    assert kc.flops == sum(closed_form.values())
    assert set(kc.by_entry) == launched
    assert {k: launches[k] for k in launched} == {
        k: v for k, v in cs.EXPECTED_PER_STEP.items()
        if not k.endswith(".tc") and not k.startswith(cs.UNCOUNTED_KERNELS)}
    assert {k: launches[k] for k in cs.UNET_CONTROLNET_GROUP_NORMS} == cs.UNET_CONTROLNET_GROUP_NORMS


def test_jax_step_counts_the_closed_form(closed_form):
    config = JaxUNetConfig()
    cn_config = jax_controlnet_config()
    f32 = lambda s: jax.ShapeDtypeStruct(s, jnp.float32)  # noqa: E731
    cn_shapes = jax.eval_shape(lambda: init_controlnet(jax.random.PRNGKey(1), cn_config))
    cond_emb = jax.eval_shape(jax_precompute_cond_embedding, cn_shapes,
                              f32((2, F, 8 * LAT, 8 * LAT, 3)))
    sizes = (LAT, LAT // 2, LAT // 4, LAT // 8)
    seg = _jit_denoise_segment(config, cn_config, JaxSchedule(), 50,
                               JaxInjectionSpec.from_start_layer(cs.INJECTION_START), 7.5, 1.0,
                               True, False)
    jax.clear_caches()
    with jax_counter() as kc:
        seg.lower(jax.eval_shape(lambda: init_unet(jax.random.PRNGKey(0), config)), cn_shapes,
                  f32((2, F, LAT, LAT, 4)), jax.ShapeDtypeStruct((1,), jnp.int32),
                  f32((2, 77, 768)), f32((2, 77, 768)), f32((2, 1, 1, 1)),
                  jax.ShapeDtypeStruct(cond_emb.shape, cond_emb.dtype),
                  {(s, s): f32((F, s * s, 1)) for s in sizes}, f32(()))
    assert kc.flops == sum(closed_form.values())
