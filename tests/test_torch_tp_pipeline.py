"""``MotionEditorPipeline`` under tensor parallelism, from frames to frames
on the CPU: its UNet (with the adapter) and ControlNet split over the model
group of a (1, 1, 2) and a (1, 2, 2) layout of gloo ranks, the VAE and the
text encoder whole (tests/torch_tp_workers.py ``pipeline``), fp32, the
tiny models and clip of tests/test_torch_sharding_phases_pipeline.py (4
frames of 128 px): a generator-sampled encode, null-text inversion (3
steps, 2 inner steps), the edit with source masks and the per-step
embeddings (2 vanilla steps, then 1 injected), the decode.

- Against the port's unsharded pipeline on the same inputs: the latents
  (atol 1e-5), x_T (1e-4), the embeddings (1e-3) and the decoded video
  (2e-3), the tolerances of that file; every rank returns the same bits.
- Against JAX's unsharded ``MotionEditorPipeline.__call__`` from the
  unsharded x_T and embeddings: the decoded video at 2e-3.
- Through ``StubTokenizer``, whose ids are salted per process, every rank
  conditions on model rank 0's (and frame rank 0's) prompt embeddings.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharding_workers as workers
import torch_tp_workers as tp_workers
from motioneditor_tpu.models import clip_text as JC
from motioneditor_tpu.models import vae as JV
from motioneditor_tpu.models.controlnet import init_controlnet
from motioneditor_tpu.models.unet import init_unet
from motioneditor_tpu.pipelines.editor import MotionEditorPipeline as JaxPipeline

from motioneditor_tpu_torch.models.from_jax import (
    clip_text_state_dict,
    controlnet_state_dict,
    unet_state_dict,
    vae_state_dict,
)
from torch_port_helpers import JAX_TINY, TINY_KW, random_params, setup_torch, to_jax

F, SIZE = 4, 128
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
TEXT_KW = dict(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32)
RUN = dict(seed=5, prompts=["a man is dancing", "a man is jumping"], steps=3, inner_steps=2,
           start_step=2)


@pytest.fixture(scope="module")
def case():
    """The workers' inputs, the port's unsharded run and JAX's edit from
    its x_T and embeddings."""
    setup_torch()
    cn_config = dataclasses.replace(JAX_TINY, video=False, use_sc_attn=False)
    trees = dict(
        unet=random_params(lambda: init_unet(jax.random.PRNGKey(0), JAX_TINY), seed=71),
        controlnet=random_params(lambda: init_controlnet(jax.random.PRNGKey(1), cn_config),
                                 seed=72),
        vae=random_params(lambda: JV.init_vae(jax.random.PRNGKey(2), JV.VAEConfig(**VAE_KW)),
                          seed=73),
        text=random_params(lambda: JC.init_clip_text(jax.random.PRNGKey(3),
                                                     JC.CLIPTextConfig(**TEXT_KW)), seed=74))
    rng = np.random.default_rng(75)
    masks = np.zeros((F, SIZE, SIZE), np.float32)
    for i in range(F):
        masks[i, 24 + 8 * i:96, 32:100] = 1.0
    clip = dict(video=rng.uniform(-1.0, 1.0, (1, F, SIZE, SIZE, 3)).astype(np.float32),
                skeleton=rng.uniform(0.0, 1.0, (F, SIZE, SIZE, 3)).astype(np.float32),
                masks=masks)
    inputs = dict(config=TINY_KW, unet=unet_state_dict(trees["unet"]),
                  controlnet=controlnet_state_dict(trees["controlnet"]),
                  vae=vae_state_dict(trees["vae"]), vae_config=VAE_KW,
                  text=clip_text_state_dict(trees["text"]), text_config=TEXT_KW,
                  run=RUN, **{k: torch.from_numpy(v) for k, v in clip.items()})
    pipe = workers._tiny_pipeline(inputs, None)
    lat = pipe.encode_video(inputs["video"], generator=torch.Generator().manual_seed(RUN["seed"]))
    x_t, uncond = pipe.null_text_inversion(lat, RUN["prompts"][0], num_steps=RUN["steps"],
                                           null_inner_steps=RUN["inner_steps"])
    video = pipe(RUN["prompts"], torch.cat([x_t, x_t]), inputs["skeleton"],
                 source_masks=inputs["masks"], uncond_embeddings=uncond,
                 num_inference_steps=RUN["steps"], start_step=RUN["start_step"])
    jpipe = JaxPipeline(
        unet_params=to_jax(trees["unet"]), vae_params=to_jax(trees["vae"]),
        text_params=to_jax(trees["text"]), controlnet_params=to_jax(trees["controlnet"]),
        tokenizer=workers.FixedTokenizer(), unet_config=JAX_TINY,
        vae_config=JV.VAEConfig(**VAE_KW), text_config=JC.CLIPTextConfig(**TEXT_KW),
        null_text_dtype="float32")
    jx = jnp.asarray(x_t.numpy())
    ref = jpipe(RUN["prompts"], jnp.concatenate([jx, jx]), jnp.asarray(clip["skeleton"]),
                source_masks=jnp.asarray(clip["masks"]),
                uncond_embeddings=jnp.asarray(uncond.numpy()),
                num_inference_steps=RUN["steps"], start_step=RUN["start_step"])
    return inputs, dict(latents=lat, x_t=x_t, uncond=uncond, video=video,
                        jax_video=np.asarray(ref))


@pytest.fixture(scope="module", params=[(1, 1, 2), (1, 2, 2)], ids=["1x1x2", "1x2x2"])
def ranks(request, case, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_pipeline")
    workers.spawn(tp_workers.pipeline, request.param, tmp, case[0])
    return [torch.load(tmp / f"rank{r}.pt") for r in range(math.prod(request.param))]


def test_tp_pipeline_matches_unsharded(ranks, case):
    one, got = case[1], ranks[0]
    assert got["video"].shape == (2, F, SIZE, SIZE, 3) and torch.isfinite(got["video"]).all()
    for key, atol in (("latents", 1e-5), ("x_t", 1e-4), ("uncond", 1e-3), ("video", 2e-3)):
        np.testing.assert_allclose(got[key].numpy(), one[key].numpy(), atol=atol, err_msg=key)


def test_tp_pipeline_edit_matches_jax(ranks, case):
    np.testing.assert_allclose(ranks[0]["video"].numpy(), case[1]["jax_video"], atol=2e-3)


def test_tp_pipeline_is_the_same_bits_on_every_rank(ranks):
    for rank in ranks[1:]:
        for key in ("latents", "x_t", "uncond", "video", "stub"):
            assert torch.equal(rank[key], ranks[0][key]), key
