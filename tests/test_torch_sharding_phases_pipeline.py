"""The port's ``MotionEditorPipeline`` with a ``shard_ctx``, from frames to
frames over 2 gloo ranks on the CPU (tests/torch_sharding_workers.py), fp32,
the tiny models of tests/test_torch_pipeline.py at 4 frames of 128 px
(16x16 latents): a generator-sampled VAE encode, null-text inversion (3
steps, 2 inner steps), the edit with source masks and the per-step
embeddings (2 vanilla steps, then 1 injected), the VAE decode.

- Against the port's unsharded pipeline on the same inputs: the sampled
  latents (atol 1e-5: the same noise, drawn at the clip's shape and cut),
  x_T (1e-4), the embeddings (1e-3, as tests/test_torch_null_text.py) and
  the decoded video (2e-3, as tests/test_torch_sharding_pipeline.py);
  every rank returns the same whole clip.
- Against JAX's unsharded ``MotionEditorPipeline.__call__`` on the same
  x_T and embeddings: the decoded video at 2e-3.
- The layouts it refuses: a data axis, and frames that do not split.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharding_workers as workers
from torch_sharding_workers import spawn
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
from motioneditor_tpu_torch.parallel.mesh import FrameShardingCtx
from torch_port_helpers import JAX_TINY, TINY_KW, random_params, setup_torch, to_jax

F, SIZE = 4, 128
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
TEXT_KW = dict(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32)
RUN = dict(seed=5, prompts=["a man is dancing", "a man is jumping"], steps=3, inner_steps=2,
           start_step=2)


@pytest.fixture(scope="module")
def trees():
    setup_torch()
    cn_config = dataclasses.replace(JAX_TINY, video=False, use_sc_attn=False)
    return dict(
        unet=random_params(lambda: init_unet(jax.random.PRNGKey(0), JAX_TINY), seed=71),
        controlnet=random_params(lambda: init_controlnet(jax.random.PRNGKey(1), cn_config),
                                 seed=72),
        vae=random_params(lambda: JV.init_vae(jax.random.PRNGKey(2), JV.VAEConfig(**VAE_KW)),
                          seed=73),
        text=random_params(lambda: JC.init_clip_text(jax.random.PRNGKey(3),
                                                     JC.CLIPTextConfig(**TEXT_KW)), seed=74))


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(75)
    masks = np.zeros((F, SIZE, SIZE), np.float32)
    for i in range(F):
        masks[i, 24 + 8 * i:96, 32:100] = 1.0  # the protagonist's box, moving
    return dict(video=rng.uniform(-1.0, 1.0, (1, F, SIZE, SIZE, 3)).astype(np.float32),
                skeleton=rng.uniform(0.0, 1.0, (F, SIZE, SIZE, 3)).astype(np.float32),
                masks=masks)


@pytest.fixture(scope="module")
def inputs(trees, clip):
    """The workers' inputs: the weights as the port's state dicts, the clip."""
    return dict(config=TINY_KW, unet=unet_state_dict(trees["unet"]),
                controlnet=controlnet_state_dict(trees["controlnet"]),
                vae=vae_state_dict(trees["vae"]), vae_config=VAE_KW,
                text=clip_text_state_dict(trees["text"]), text_config=TEXT_KW,
                run=RUN, **{k: torch.from_numpy(v) for k, v in clip.items()})


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    spawn(workers.pipeline, (1, 2), tmp, inputs)
    return ([torch.load(tmp / f"sharded{r}.pt") for r in range(2)],
            torch.load(tmp / "unsharded0.pt"), tmp)


def test_sharded_pipeline_matches_unsharded(runs):
    sharded, unsharded, _ = runs
    got = sharded[0]
    assert got["video"].shape == (2, F, SIZE, SIZE, 3) and torch.isfinite(got["video"]).all()
    assert got["uncond"].shape == (RUN["steps"], 1, 77, 16)
    for key, atol in (("latents", 1e-5), ("x_t", 1e-4), ("uncond", 1e-3), ("video", 2e-3)):
        np.testing.assert_allclose(got[key].numpy(), unsharded[key].numpy(), atol=atol,
                                   err_msg=key)


def test_sharded_pipeline_returns_the_whole_clip_on_every_rank(runs):
    sharded, _, _ = runs
    for key in ("latents", "x_t", "uncond", "video"):
        assert torch.equal(sharded[0][key], sharded[1][key]), key


def test_sharded_pipeline_conditions_every_rank_on_the_same_text(runs):
    """Through ``StubTokenizer`` (ids from Python's per-process ``hash``)
    every rank still gets frame rank 0's prompt embeddings."""
    tmp = runs[2]
    ranks = [torch.load(tmp / f"stub{r}.pt") for r in range(2)]
    assert torch.equal(ranks[0], ranks[1])


def test_sharded_edit_matches_jax(trees, clip, runs):
    """JAX's unsharded edit (vanilla and injected segments, masks, per-step
    embeddings, decode) from the port's unsharded x_T and embeddings."""
    sharded, unsharded, _ = runs
    jpipe = JaxPipeline(
        unet_params=to_jax(trees["unet"]), vae_params=to_jax(trees["vae"]),
        text_params=to_jax(trees["text"]), controlnet_params=to_jax(trees["controlnet"]),
        tokenizer=workers.FixedTokenizer(), unet_config=JAX_TINY, vae_config=JV.VAEConfig(**VAE_KW),
        text_config=JC.CLIPTextConfig(**TEXT_KW), null_text_dtype="float32")
    x_t = jnp.asarray(unsharded["x_t"].numpy())
    ref = jpipe(RUN["prompts"], jnp.concatenate([x_t, x_t]), jnp.asarray(clip["skeleton"]),
                source_masks=jnp.asarray(clip["masks"]),
                uncond_embeddings=jnp.asarray(unsharded["uncond"].numpy()),
                num_inference_steps=RUN["steps"], start_step=RUN["start_step"])
    np.testing.assert_allclose(sharded[0]["video"].numpy(), np.asarray(ref), atol=2e-3)


# ---------------------------------------------------------------------------
# the layouts the pipeline refuses (no process group is needed to refuse)
# ---------------------------------------------------------------------------


def test_pipeline_refuses_a_data_axis(inputs):
    ctx = FrameShardingCtx(None, (0,), None, (0, 1), torch.device("cpu"))  # (data 2, frames 1)
    with pytest.raises(ValueError, match="data"):
        workers._tiny_pipeline(inputs, ctx)


@pytest.mark.parametrize("entry", ["encode_video", "ddim_invert", "null_text_inversion",
                                   "edit", "decode_latents"])
def test_pipeline_refuses_frames_that_do_not_split(inputs, entry):
    ctx = FrameShardingCtx(None, (0, 1), None, (0,), torch.device("cpu"))  # (data 1, frames 2)
    pipe = workers._tiny_pipeline(inputs, ctx)
    f = 3
    lat = torch.zeros((1, f, 16, 16, 4))
    calls = {
        "encode_video": lambda: pipe.encode_video(torch.zeros((1, f, SIZE, SIZE, 3))),
        "ddim_invert": lambda: pipe.ddim_invert(lat, num_inv_steps=1),
        "null_text_inversion": lambda: pipe.null_text_inversion(lat, "a", num_steps=1),
        "edit": lambda: pipe(["a", "b"], torch.cat([lat, lat]),
                             torch.zeros((f, SIZE, SIZE, 3)), num_inference_steps=1),
        "decode_latents": lambda: pipe.decode_latents(lat),
    }
    with pytest.raises(ValueError, match="frames do not split"):
        calls[entry]()
