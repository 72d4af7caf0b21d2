"""The port's p2p edit (``MotionEditorPipeline.__call__`` with a controller
and LocalBlend) with a ``shard_ctx`` over 2 gloo ranks on the CPU
(tests/torch_sharding_workers.py ``p2p_edit``), fp32, the tiny models at 4
frames of 128 px (16x16 latents, 2 frames per rank), against the
unsharded port on the same x_T: the replace controller over a vanilla and
an injected mask-mode segment, refine in mutual mode (no masks) and
reweight with masks, each with LocalBlend on "man".

- The decoded videos at 2e-3 (tests/test_torch_sharding_phases_pipeline.py);
  every rank returns the same whole clip.
- The controllers are built on every rank from its own ``StubTokenizer``,
  whose ids are salted per process: the mapper, the word gates and the
  LocalBlend word selection depend on word positions only, and every rank
  must hold the same arrays.
- LocalBlend's threshold is placed inside the range of the edit row's map
  (at random weights the maps are nearly flat and the config's 0.3 would
  keep every pixel) by chip_smoke.py's ``clear_threshold``, where no map
  value of either run lies within MARGIN of it (a value there could flip
  between the sharded and the unsharded run), with an edit mask of both
  sides; every rank picks the same one.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
import torch_sharding_workers as workers
from torch_sharding_workers import spawn
from motioneditor_tpu.models import clip_text as JC
from motioneditor_tpu.models import vae as JV
from motioneditor_tpu.models.controlnet import init_controlnet
from motioneditor_tpu.models.unet import init_unet

from motioneditor_tpu_torch.models.from_jax import (
    clip_text_state_dict,
    controlnet_state_dict,
    unet_state_dict,
    vae_state_dict,
)
from torch_port_helpers import JAX_TINY, TINY_KW, random_params, setup_torch

F, SIZE = 4, 128
MARGIN = cs.P2P_MARGIN
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
TEXT_KW = dict(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32)
RUN = dict(steps=4, cases=[("replace", 2, True), ("refine", 0, False), ("reweight", 0, True)],
           prompts={"replace": ["a girl is dancing", "a man is dancing"],
                    "refine": ["a girl is dancing", "a man is dancing outside"],
                    "reweight": ["a girl is dancing", "a man is dancing"]})


@pytest.fixture(scope="module")
def inputs():
    """The workers' inputs: the weights as the port's state dicts, x_T, the
    skeleton and the masks, from a numpy seed."""
    setup_torch()
    cn_config = dataclasses.replace(JAX_TINY, video=False, use_sc_attn=False)
    rng = np.random.default_rng(81)
    masks = np.zeros((F, SIZE, SIZE), np.float32)
    for i in range(F):
        masks[i, 24 + 8 * i:96, 32:100] = 1.0  # the protagonist's box, moving
    return dict(
        config=TINY_KW,
        unet=unet_state_dict(random_params(lambda: init_unet(jax.random.PRNGKey(0), JAX_TINY),
                                           seed=82)),
        controlnet=controlnet_state_dict(random_params(
            lambda: init_controlnet(jax.random.PRNGKey(1), cn_config), seed=83)),
        vae=vae_state_dict(random_params(
            lambda: JV.init_vae(jax.random.PRNGKey(2), JV.VAEConfig(**VAE_KW)), seed=84)),
        vae_config=VAE_KW,
        text=clip_text_state_dict(random_params(
            lambda: JC.init_clip_text(jax.random.PRNGKey(3), JC.CLIPTextConfig(**TEXT_KW)),
            seed=85)),
        text_config=TEXT_KW,
        x_t=torch.from_numpy(rng.standard_normal((1, F, 16, 16, 4)).astype(np.float32)),
        skeleton=torch.from_numpy(rng.uniform(0.0, 1.0, (F, SIZE, SIZE, 3)).astype(np.float32)),
        masks=torch.from_numpy(masks), **RUN)


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("p2p")
    spawn(workers.p2p_edit, (1, 2), tmp, inputs)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.mark.parametrize("kind", [case[0] for case in RUN["cases"]])
def test_sharded_p2p_edit_matches_unsharded(runs, kind):
    got = runs[0]["videos"][("sharded", kind)]
    ref = runs[0]["videos"][("unsharded", kind)]
    assert got.shape == (2, F, SIZE, SIZE, 3) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-3)
    assert torch.equal(got, runs[1]["videos"][("sharded", kind)])


@pytest.mark.parametrize("kind", [case[0] for case in RUN["cases"]])
def test_every_rank_builds_the_same_controller(runs, kind):
    a, b = runs[0]["arrays"][kind], runs[1]["arrays"][kind]
    assert a.keys() == b.keys()
    for key in a:
        assert (a[key] is None) == (b[key] is None), key
        if a[key] is not None:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_local_blend_maps_clear_of_the_threshold(runs):
    assert runs[0]["thresholds"] == runs[1]["thresholds"]
    assert min(min(r["gaps"]) for r in runs) > MARGIN
