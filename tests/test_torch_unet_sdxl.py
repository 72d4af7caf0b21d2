"""SDXL's UNet inflated to video (models/unet.py with a text_time
configuration) against the plain reference benchmark/reference/sdxl_video.py,
in float32 on seeded random weights at a tiny SDXL-shaped size: three
levels, the first without attention, transformer depths (1, 2, 3), heads 8
wide in per-level counts, Linear projections, the text_time conditioning,
3 frames. The reference imports nothing of the port. Also the checkpoint
loader on a synthetic SDXL state dict, and the refusals of the paths not
ported to this configuration."""

import dataclasses

import pytest
import torch

from benchmark import data
from benchmark.reference import sdxl_video as X
from motioneditor_tpu_torch.models.unet import (
    SDXL_BASE,
    UNet3DConditionModel,
    UNetConfig,
    unet_apply,
)

SEED = 2 ** 33 + 24
INIT = {"qk_gain": 3.0, "norm_spread": 0.1}  # every module drawn, zero-init ones too
FRAMES, LATENT, BATCH = 3, 16, 1
MODEL = {  # the reference's configuration group at the tiny size
    "in_channels": 4, "out_channels": 4, "block_out_channels": [16, 32, 48],
    "layers_per_block": 2,
    "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
    "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"],
    "transformer_layers_per_block": [1, 2, 3], "attention_head_dim": [2, 4, 6],
    "num_attention_heads": None, "use_linear_projection": True, "cross_attention_dim": 24,
    "addition_embed_type": "text_time", "addition_time_embed_dim": 8,
    "projection_class_embeddings_input_dim": 12 + 6 * 8, "norm_num_groups": 8,
    "norm_eps": 1e-5, "transformer_norm_eps": 1e-6,
}
CONFIG = UNetConfig(
    block_out_channels=(16, 32, 48), cross_attention_dim=24, norm_num_groups=8,
    down_block_types=tuple(MODEL["down_block_types"]), transformer_layers_per_block=(1, 2, 3),
    num_attention_heads=(2, 4, 6), use_linear_projection=True, addition_embed_type="text_time",
    addition_time_embed_dim=8, projection_class_embeddings_input_dim=12 + 6 * 8)
TRAINABLE = ("attn1.to_q", "attn2.to_q", "attn_temp")
# the same float32 arithmetic in other orders (products, convolutions per
# frame, GroupNorm sums) and the port's sinusoids reduced mod 2 pi before
# sin / cos (the reference takes them at the raw argument, up to 1024 here):
# ~1e-6 of a norm; 1e-4 leaves room and still fails a wrong head split or a
# dropped term (each moves the output by 1e-2 or more)
REL = 1e-4


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def pair():
    """The port's UNet and the reference on the same weights, and inputs."""
    torch.manual_seed(0)
    with torch.device("meta"):
        model = UNet3DConditionModel(CONFIG, include_adapter=False)
    model = model.to_empty(device="cpu")
    shapes = X.unet_shapes(MODEL)
    data.load_into(model, shapes, SEED, 1, INIT)
    ref = X.Reference(data.reference_params(shapes, SEED, 1, "cpu", torch.float32, INIT), MODEL)
    g = torch.Generator().manual_seed(7)
    x = {"sample": torch.randn(BATCH, FRAMES, LATENT, LATENT, 4, generator=g),
         "text": torch.randn(BATCH, 5, 24, generator=g),
         "added": {"text_embeds": torch.randn(BATCH, 12, generator=g),
                   "time_ids": torch.tensor([[1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0]])}}
    return model, ref, x


def test_parameter_layout_is_the_references():
    with torch.device("meta"):
        model = UNet3DConditionModel(CONFIG, include_adapter=False)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == X.unet_shapes(MODEL)
    proj = [p for n, p in model.named_parameters() if n.endswith(("proj_in.weight",
                                                                  "proj_out.weight"))]
    assert len(proj) == 2 * (2 + 2 + 1 + 3 + 3) and all(p.dim() == 2 for p in proj)


def test_full_width_layout_is_the_references():
    """SDXL's published widths: 70 transformer blocks, heads of 64, 3.06 B
    parameters with the inflation, 614 M of them stage 1's trainables."""
    model_cfg = {**MODEL, "block_out_channels": [320, 640, 1280], "cross_attention_dim": 2048,
                 "transformer_layers_per_block": [1, 2, 10], "attention_head_dim": [5, 10, 20],
                 "addition_time_embed_dim": 256, "projection_class_embeddings_input_dim": 2816,
                 "norm_num_groups": 32}
    with torch.device("meta"):
        model = UNet3DConditionModel(SDXL_BASE, include_adapter=False)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == X.unet_shapes(model_cfg)
    assert sum(n.endswith("attn1.to_q.weight") for n in shapes) == 70
    assert {a.heads * 64 == a.to_q.out_features for m in model.modules()
            if type(m).__name__ == "BasicTransformerBlock"
            for a in (m.attn1, m.attn2, m.attn_temp)} == {True}
    total = sum(torch.Size(s).numel() for s in shapes.values())
    trained = sum(torch.Size(s).numel() for n, s in shapes.items()
                  if any(f".{t}." in f".{n}" for t in TRAINABLE))
    assert (round(total / 1e9, 2), round(trained / 1e6)) == (3.06, 614)


def test_unet_output(pair):
    model, ref, x = pair
    t = torch.tensor([417])
    with torch.no_grad():
        got = unet_apply(model, CONFIG, x["sample"], t, x["text"],
                         added_cond_kwargs=x["added"])
        want = ref.unet(x["sample"], t, x["text"], "motion_frame", x["added"])
        # the added conditioning moves the output: a dropped term fails REL
        plain = ref.unet(x["sample"], t, x["text"], "motion_frame",
                         {**x["added"], "time_ids": torch.zeros(1, 6)})
    assert rel(got, want) < REL
    assert rel(plain, want) > 100 * REL


def test_stage1_loss_and_gradients(pair):
    """The stage-1 loss and the gradient of every trainable leaf, through
    the port's checkpointed step functions."""
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule
    from motioneditor_tpu_torch.training.common import trainable_mask
    from motioneditor_tpu_torch.training.stage1 import stage1_loss

    model, ref, x = pair
    schedule = DiffusionSchedule()
    acp = schedule.alphas_cumprod.float()
    g = torch.Generator().manual_seed(3)
    noise = torch.randn(x["sample"].shape, generator=g)
    t = torch.tensor([611])
    mask = trainable_mask(model, TRAINABLE)
    params = dict(model.named_parameters())
    for n, p in params.items():
        p.requires_grad_(mask[n])
    model.zero_grad()
    loss = stage1_loss(model, CONFIG, x["sample"], x["text"], noise, t, schedule, remat=True,
                       added_cond_kwargs=x["added"])
    loss.backward()
    names = [n for n in ref.p if mask[n]]
    leaves = {n: ref.p[n].clone().requires_grad_(True) for n in names}
    want_ref = X.Reference({**ref.p, **leaves}, MODEL)
    want = X.stage1_loss(want_ref, acp, x["sample"], x["text"], x["added"], noise, t)
    grads = torch.autograd.grad(want, [leaves[n] for n in names])
    assert abs(loss.item() - want.item()) / want.item() < REL
    assert len(names) == sum(mask.values()) > 0
    for n, gr in zip(names, grads):
        assert rel(params[n].grad, gr) < 10 * REL, n  # a gradient sums more terms


def test_ddim_invert_step(pair):
    from motioneditor_tpu_torch.pipelines.editor import ddim_invert
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    from benchmark.reference import sd15_video as R

    model, ref, x = pair
    schedule = DiffusionSchedule()
    sched = {"num_train_timesteps": 1000, "beta_start": 0.00085, "beta_end": 0.012,
             "steps_offset": 1}
    steps = 10
    with torch.no_grad():
        _, lat = ddim_invert(model, CONFIG, schedule, x["sample"], x["text"], steps,
                             normal_infer=False, added_cond_kwargs=x["added"])
        t = R.timesteps(sched, steps)[-1]
        eps = ref.unet(x["sample"], t, x["text"], "motion_frame", x["added"])
        want = R.ddim_inverse_step(R.alphas_cumprod(sched), sched, eps, t, x["sample"], steps)
    assert rel(lat[1] - lat[0], want - x["sample"]) < REL


def test_text_time_without_its_conditioning_raises(pair):
    model, _, x = pair
    with pytest.raises(ValueError, match="added_cond_kwargs"):
        unet_apply(model, CONFIG, x["sample"], 1, x["text"])
    with pytest.raises(ValueError, match="added_cond_kwargs"):
        unet_apply(model, CONFIG, x["sample"], 1, x["text"],
                   added_cond_kwargs={"text_embeds": x["added"]["text_embeds"]})


def test_added_conditioning_without_text_time_raises():
    sd15 = UNetConfig(block_out_channels=(16, 16, 16, 16), norm_num_groups=8,
                      cross_attention_dim=24, attention_heads=2)
    with torch.device("meta"):
        model = UNet3DConditionModel(sd15, include_adapter=False)
    with pytest.raises(ValueError, match="without text_time"):
        unet_apply(model, sd15, torch.empty(1, 2, 16, 16, 4, device="meta"), 1,
                   torch.empty(1, 5, 24, device="meta"),
                   added_cond_kwargs={"text_embeds": None, "time_ids": None})


@pytest.mark.parametrize("path", ["controlnet", "adapter", "residuals", "injection", "p2p",
                                  "shard", "tensor_parallel"])
def test_unported_paths_refuse_text_time(pair, path):
    from motioneditor_tpu_torch.control.injection import InjectionSpec
    from motioneditor_tpu_torch.models.controlnet import ControlNetModel, controlnet_config
    from motioneditor_tpu_torch.parallel.tp import shard_params_tp

    model, _, x = pair
    call = dict(sample=x["sample"], timesteps=1, encoder_hidden_states=x["text"],
                added_cond_kwargs=x["added"])
    with pytest.raises(NotImplementedError, match="text_time"):
        if path == "controlnet":
            controlnet_config(CONFIG)
        elif path == "adapter":
            UNet3DConditionModel(CONFIG)
        elif path == "residuals":
            unet_apply(model, CONFIG, **call, down_block_additional_residuals=[])
        elif path == "injection":
            unet_apply(model, CONFIG, **call, injection=InjectionSpec.from_start_layer(0))
        elif path == "p2p":
            unet_apply(model, CONFIG, **call, prob_editor=lambda p, cross: p)
        elif path == "shard":
            unet_apply(model, CONFIG, **call, shard_ctx=object())
        else:
            shard_params_tp(model, type("Layout", (), {"tp": 2})())
    if path == "controlnet":
        with pytest.raises(NotImplementedError, match="text_time"):
            ControlNetModel(dataclasses.replace(CONFIG, video=False))


def test_load_sdxl_unet(tmp_path):
    """A diffusers SDXL ``unet/`` directory (Linear projections,
    ``add_embedding``, no temporal modules) loads into the video UNet; the
    temporal modules keep their init; a missing SDXL key raises."""
    from motioneditor_tpu_torch.models.weights import load_sdxl_unet

    with torch.device("meta"):
        model = UNet3DConditionModel(CONFIG, include_adapter=False)
    video = ("temp_conv1", "temp_conv2", "attn_temp", "norm_temp")
    g = torch.Generator().manual_seed(5)
    sd = {n: torch.randn(p.shape, generator=g) for n, p in model.named_parameters()
          if not any(f".{v}." in n for v in video)}
    assert any(n.startswith("add_embedding.") for n in sd)
    (tmp_path / "unet").mkdir()
    torch.save(sd, tmp_path / "unet" / "diffusion_pytorch_model.bin")
    unet = load_sdxl_unet(str(tmp_path), CONFIG, device="cpu")
    own = dict(unet.named_parameters())
    assert all(torch.equal(own[n], v) for n, v in sd.items())
    assert all(own[n].abs().sum() == 0 for n in own if ".temp_conv" in n)
    del sd["down_blocks.1.attentions.0.proj_in.weight"]
    torch.save(sd, tmp_path / "unet" / "diffusion_pytorch_model.bin")
    with pytest.raises(KeyError, match="proj_in"):
        load_sdxl_unet(str(tmp_path), CONFIG, device="cpu")
