"""The port's full edit from frames to frames against the JAX package, fp32
on the CPU: a tiny ``MotionEditorPipeline`` (UNet, ControlNet, VAE and CLIP
text encoder on the same converted weights) driven by ``inference.edit``
over a ``VideoDataset`` of PNG frames written under tmp_path, against the
JAX pipeline driven as scripts/inference.py's ``main`` drives it. Also the
entry point's device rule, the copied config and dataset modules, and the
null-text path of ``edit``.

Tolerance: the decoded videos atol 2e-3 (that of the multi-step denoise
segment in tests/test_torch_slice.py; the VAE decode adds a few convs).
"""

import dataclasses
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu import configs as JCF
from motioneditor_tpu.data.dataset import VideoDataset as JaxVideoDataset
from motioneditor_tpu.models import clip_text as JC
from motioneditor_tpu.models import vae as JV
from motioneditor_tpu.models.controlnet import init_controlnet
from motioneditor_tpu.pipelines.editor import MotionEditorPipeline as JaxPipeline

from motioneditor_tpu_torch import configs as TCF
from motioneditor_tpu_torch import inference
from motioneditor_tpu_torch.data.dataset import VideoDataset
from motioneditor_tpu_torch.models import clip_text as TC
from motioneditor_tpu_torch.models import vae as TV
from motioneditor_tpu_torch.models.controlnet import ControlNetModel, controlnet_config
from motioneditor_tpu_torch.models.from_jax import (
    clip_text_state_dict,
    controlnet_state_dict,
    vae_state_dict,
)
from motioneditor_tpu_torch.models.unet import UNetConfig
from motioneditor_tpu_torch.pipelines.editor import MotionEditorPipeline

from torch_port_helpers import (
    JAX_TINY,
    TINY_KW,
    assert_close,
    random_params,
    setup_torch,
    tiny_unet,
    to_jax,
)

F, SIZE = 2, 128  # 16x16 latents
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
TEXT_KW = dict(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32)
REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture(scope="module")
def pipelines():
    setup_torch()
    unet_tree, unet = tiny_unet(seed=11)
    cn_jax_config = dataclasses.replace(JAX_TINY, video=False, use_sc_attn=False)
    cn_tree = random_params(lambda: init_controlnet(jax.random.PRNGKey(1), cn_jax_config),
                            seed=12)
    vae_tree = random_params(lambda: JV.init_vae(jax.random.PRNGKey(2), JV.VAEConfig(**VAE_KW)),
                             seed=13)
    text_tree = random_params(
        lambda: JC.init_clip_text(jax.random.PRNGKey(3), JC.CLIPTextConfig(**TEXT_KW)), seed=14)
    jpipe = JaxPipeline(
        unet_params=unet_tree, vae_params=to_jax(vae_tree), text_params=to_jax(text_tree),
        controlnet_params=to_jax(cn_tree), tokenizer=JC.StubTokenizer(), unet_config=JAX_TINY,
        vae_config=JV.VAEConfig(**VAE_KW), text_config=JC.CLIPTextConfig(**TEXT_KW),
        null_text_dtype="float32")
    tiny = UNetConfig(**TINY_KW)
    cn = ControlNetModel(controlnet_config(tiny)).eval()
    cn.load_state_dict(controlnet_state_dict(cn_tree))
    vae = TV.AutoencoderKL(TV.VAEConfig(**VAE_KW)).eval()
    vae.load_state_dict(vae_state_dict(vae_tree))
    text = TC.CLIPTextModel(TC.CLIPTextConfig(**TEXT_KW)).eval()
    text.load_state_dict(clip_text_state_dict(text_tree))
    pipe = MotionEditorPipeline(unet=unet, vae=vae, text_encoder=text, controlnet=cn,
                                tokenizer=TC.StubTokenizer(), unet_config=tiny,
                                vae_config=TV.VAEConfig(**VAE_KW),
                                text_config=TC.CLIPTextConfig(**TEXT_KW))
    return jpipe, pipe


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    """A data/case-N layout of F PNG frames, pose images and masks."""
    from PIL import Image

    root = tmp_path_factory.mktemp("case")
    rng = np.random.default_rng(15)
    dirs = ("images", "source_condition/openposefull", "target_condition/openposefull",
            "man.mask")
    for d in dirs:
        (root / d).mkdir(parents=True)
    for i in range(F):
        for d in dirs[:3]:
            img = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
            Image.fromarray(img).save(root / d / f"{i:05d}.png")
        mask = np.zeros((SIZE, SIZE), np.uint8)
        mask[24 + 8 * i:96, 32:100] = 255
        Image.fromarray(mask).save(root / "man.mask" / f"{i:05d}.png")
    return str(root)


def _config(module, clip_dir, **validation):
    """configs/smoke/eval.yaml's edit on the generated clip."""
    cfg = module.RunConfig(seed=3)
    cfg.input_data = module.InputDataConfig(
        video_dir=clip_dir, prompt="a man is dancing", n_sample_frames=F, width=SIZE,
        height=SIZE, source_mask_dir="man.mask")
    cfg.validation_data = module.ValidationDataConfig(
        **{"prompts": ("a man is jumping",), "num_inference_steps": 4, "num_inv_steps": 2,
           "use_null_inv": False, **validation})
    return cfg


def test_dataset_matches_jax(clip_dir):
    kw = dict(video_dir=clip_dir, prompt="p", width=SIZE, height=SIZE, n_sample_frames=F,
              source_mask_dir="man.mask")
    got, ref = VideoDataset(**kw)[0], JaxVideoDataset(**kw)[0]
    assert got.keys() == ref.keys()
    for key in ("pixel_values", "source_masks", "sample_indices"):
        np.testing.assert_allclose(got[key], ref[key], atol=1e-6)
    for key in ("source_conditions", "target_conditions"):
        np.testing.assert_allclose(got[key]["openposefull"], ref[key]["openposefull"], atol=1e-6)
    assert got["pixel_values"].shape == (F, SIZE, SIZE, 3)
    assert set(np.unique(got["source_masks"])) == {0.0, 1.0}


def test_edit_matches_jax_from_frames_to_frames(pipelines, clip_dir):
    """Frames -> VAE mean -> DDIM inversion (2 steps) -> the 4-step edit of
    configs/smoke/eval.yaml (all vanilla at the default start_step 4, as
    there; the injected steps are held against JAX in
    tests/test_torch_slice.py and tests/test_torch_mask_auto.py) -> decoded
    [reconstruction, edit] frames."""
    jpipe, pipe = pipelines
    cfg = _config(TCF, clip_dir)
    vd = cfg.validation_data
    batch = VideoDataset(**vars(cfg.input_data))[0]
    out = inference.edit(pipe, cfg, batch)
    assert list(out) == ["a man is jumping"]
    got = out["a man is jumping"]
    assert got.shape == (2, F, SIZE, SIZE, 3) and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0

    jbatch = JaxVideoDataset(**vars(cfg.input_data))[0]
    latents = jpipe.encode_video(jnp.asarray(jbatch["pixel_values"])[None], sample=False)
    inv = jpipe.ddim_invert(latents, prompt="", num_inv_steps=vd.num_inv_steps,
                            normal_infer=True)
    ref = jpipe(["a man is dancing", "a man is jumping"], jnp.concatenate([inv, inv]),
                jnp.asarray(jbatch["target_conditions"]["openposefull"]),
                source_masks=jnp.asarray(jbatch["source_masks"]),
                num_inference_steps=vd.num_inference_steps, guidance_scale=vd.guidance_scale,
                controlnet_conditioning_scale=vd.controlnet_conditioning_scale)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-3)


def test_edit_with_null_text_inversion(pipelines, clip_dir):
    """The null-text branch with one uncond embedding per edit step, over 5
    steps: 4 vanilla, then 1 injected in mask mode."""
    _, pipe = pipelines
    cfg = _config(TCF, clip_dir, num_inference_steps=5, num_inv_steps=5, use_null_inv=True)
    batch = VideoDataset(**vars(cfg.input_data))[0]
    out = inference.edit(pipe, cfg, batch, torch.Generator().manual_seed(0))
    got = out["a man is jumping"]
    assert got.shape == (2, F, SIZE, SIZE, 3) and np.isfinite(got).all()


def test_pipeline_encoders_match_jax(pipelines):
    jpipe, pipe = pipelines
    prompts = ["a man is dancing", ""]
    assert_close(pipe.encode_prompt(prompts), jpipe.encode_prompt(prompts), atol=1e-5)
    rng = np.random.default_rng(16)
    lat = (0.3 * rng.standard_normal((1, F, 16, 16, 4))).astype(np.float32)
    assert_close(pipe.decode_latents(torch.from_numpy(lat)),
                 jpipe.decode_latents(jnp.asarray(lat)), atol=1e-4)


def test_call_rejects_what_it_does_not_run(pipelines):
    """A LocalBlend at latents that never reach a 16x16 (256-token) map
    site, as JAX's __call__ (editor.py:248-253); too few uncond embeddings."""
    from motioneditor_tpu_torch.control.p2p import make_local_blend

    _, pipe = pipelines
    lat = torch.zeros((2, F, 16, 16, 4))
    skel = torch.zeros((F, SIZE, SIZE, 3))
    prompts = ["a girl is dancing", "a man is dancing"]
    blend = make_local_blend(prompts, [["man"]] * 2, pipe.tokenizer)
    for hw in ((8, 8), (40, 40)):
        with pytest.raises(ValueError, match="16x16"):
            pipe(prompts, torch.zeros((2, F) + hw + (4,)), skel, local_blend=blend)
    with pytest.raises(ValueError, match="uncond"):
        pipe(["a", "b"], lat, skel, uncond_embeddings=torch.zeros((2, 1, 77, 16)),
             num_inference_steps=3)


def test_main_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        inference.main(osp.join(REPO, "configs", "smoke", "eval.yaml"))
    assert inference.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", ["smoke/eval.yaml", "smoke/eval-null.yaml",
                                  "case-1/eval-motion.yaml", "smoke/eval-p2p.yaml"])
def test_configs_match_jax(name, tmp_path):
    path = osp.join(REPO, "configs", name)
    got, ref = TCF.load_config(path), JCF.load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.compute_dtype == (torch.bfloat16 if ref.mixed_precision in ("bf16", "fp16")
                                 else torch.float32)
    TCF.save_config(got, str(tmp_path / "c.yaml"))
    assert dataclasses.asdict(TCF.load_config(str(tmp_path / "c.yaml"))) == \
        dataclasses.asdict(got)
