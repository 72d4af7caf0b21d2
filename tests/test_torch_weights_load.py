"""The checkpoint readers of the port (models/weights.py) against the JAX
package's (motioneditor_tpu/models/weights.py), fp32 on the CPU.

A tiny diffusers directory is written here from seeded JAX trees (through
models/from_jax.py) in the layouts the loaders must accept: the UNet
without temporal or adapter keys (as SD-1.5 has none) or with the adapter
and unnumbered ``to_out`` keys, the VAE under the ``to_q`` / ``to_out.0``
names with 1x1-conv attention weights and ``norm``, the text encoder with
and without the ``text_model.`` prefix and with a ``position_ids`` buffer,
the ControlNet, and the reference's adapter ``.pth``; each in ``.bin`` and
in ``.safetensors``. After loading, the port's state dict equals
``from_jax`` of JAX's loaded tree bitwise on every checkpoint key, and a
UNet forward of the loaded weights matches JAX's within 1e-4 (the leaves
JAX keeps from its own init copied into the port). The loaders raise on an
unexpected key, a wrong shape or a partly missing module; the full-width
manifests load onto the full-width modules on the meta device with no key
left over. The safetensors reader returns what the safetensors package
does. ``inference.edit`` runs on such a directory and a ``.pth`` adapter.
"""

import dataclasses
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.models import clip_text as JC
from motioneditor_tpu.models import vae as JV
from motioneditor_tpu.models import weights as JW
from motioneditor_tpu.models.controlnet import init_controlnet
from motioneditor_tpu.models.unet import init_unet
from motioneditor_tpu.models.unet import unet_apply as jax_unet_apply

from motioneditor_tpu_torch import configs as TCF
from motioneditor_tpu_torch import inference
from motioneditor_tpu_torch.data.dataset import VideoDataset
from motioneditor_tpu_torch.models import weights as W
from motioneditor_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel, StubTokenizer
from motioneditor_tpu_torch.models.controlnet import ControlNetModel, controlnet_config
from motioneditor_tpu_torch.models.from_jax import (
    adapter_state_dict,
    clip_text_state_dict,
    controlnet_state_dict,
    unet_state_dict,
    vae_state_dict,
)
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig, unet_apply
from motioneditor_tpu_torch.models.vae import AutoencoderKL, VAEConfig

from torch_port_helpers import JAX_TINY, TINY_KW, normal, random_params, setup_torch, tensor

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
MANIFEST_DIR = osp.join(REPO, "tests", "fixtures", "manifests")
TINY = UNetConfig(**TINY_KW)
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
TEXT_KW = dict(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32)
VIDEO_ONLY = ("temp_conv1.", "temp_conv2.", ".attn_temp.", ".norm_temp.", "controlnet_adapter.")
FORMATS = ("bin", "safetensors")


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


@pytest.fixture(scope="module")
def trees():
    """Seeded JAX trees of the tiny UNet (with its adapter), ControlNet, VAE
    and text encoder."""
    cn_cfg = dataclasses.replace(JAX_TINY, video=False, use_sc_attn=False)
    return dict(
        unet=random_params(lambda: init_unet(jax.random.PRNGKey(0), JAX_TINY), seed=41),
        controlnet=random_params(lambda: init_controlnet(jax.random.PRNGKey(1), cn_cfg), seed=42),
        vae=random_params(lambda: JV.init_vae(jax.random.PRNGKey(2), JV.VAEConfig(**VAE_KW)),
                          seed=43),
        text=random_params(
            lambda: JC.init_clip_text(jax.random.PRNGKey(3), JC.CLIPTextConfig(**TEXT_KW)),
            seed=44))


def _save(sd, path):
    sd = {k: v.contiguous() for k, v in sd.items()}
    if path.endswith(".safetensors"):
        from safetensors.torch import save_file

        save_file(sd, path)
    else:
        torch.save(sd, path)


def _sd15_unet(sd, with_adapter=False):
    """The 2D SD-1.5 layout: no temporal keys; the adapter only when asked."""
    return {k: v for k, v in sd.items()
            if not any(t in k for t in VIDEO_ONLY)
            or (with_adapter and k.startswith("controlnet_adapter."))}


def _vae_to_q_layout(sd):
    """The VAE's attention under diffusers' newer names, as 1x1 convs, with
    ``norm`` for ``group_norm``."""
    names = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0",
             "group_norm": "norm"}
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if ".mid_block.attentions.0." in k and parts[-2] in names:
            new = names[parts[-2]]
            k = ".".join(parts[:-2] + [new, parts[-1]])
            if new != "norm" and parts[-1] == "weight":
                v = v[:, :, None, None]
        out[k] = v
    return out


def _unnumbered_to_out(sd):
    return {k.replace(".to_out.0.", ".to_out."): v for k, v in sd.items()}


def write_weights(root, trees, fmt, variant):
    """A diffusers SD-1.5 directory, a ControlNet directory and an adapter
    .pth under ``root``; ``variant`` 0 or 1 picks the layouts."""
    ext = ".safetensors" if fmt == "safetensors" else ".bin"
    for d in ("unet", "vae", "text_encoder", "controlnet"):
        (root / d).mkdir(parents=True)
    unet = _sd15_unet(unet_state_dict(trees["unet"]), with_adapter=variant == 1)
    if variant == 1:
        unet = _unnumbered_to_out(unet)
    _save(unet, str(root / "unet" / f"diffusion_pytorch_model{ext}"))
    vae = vae_state_dict(trees["vae"])
    _save(_vae_to_q_layout(vae) if variant == 0 else vae,
          str(root / "vae" / f"diffusion_pytorch_model{ext}"))
    text = clip_text_state_dict(trees["text"])
    if variant == 1:
        text = {k[len("text_model."):]: v for k, v in text.items()
                if k != "text_model.embeddings.position_ids"}
    _save(text, str(root / "text_encoder" / ("model.safetensors" if fmt == "safetensors"
                                             else "pytorch_model.bin")))
    _save(controlnet_state_dict(trees["controlnet"]),
          str(root / "controlnet" / f"diffusion_pytorch_model{ext}"))
    adapter = adapter_state_dict(trees["unet"]["controlnet_adapter"])
    torch.save(_unnumbered_to_out(adapter) if variant == 1 else adapter,
               str(root / "adapter.pth"))
    return str(root)


def _assert_equal_on(sd, ref, keys):
    assert keys
    for k in keys:
        assert torch.equal(sd[k], ref[k]), k


@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("fmt", FORMATS)
def test_loaders_match_jax_bitwise(tmp_path, trees, fmt, variant):
    path = write_weights(tmp_path, trees, fmt, variant)
    # JAX
    j_unet = JW.load_sd15_unet(path, JAX_TINY)
    j_vae, j_text = JW.load_sd15_vae(path), JW.load_sd15_text_encoder(path)
    j_cn = JW.load_controlnet(osp.join(path, "controlnet"))
    j_adapter = JW.load_adapter_checkpoint(osp.join(path, "adapter.pth"))
    # the port
    unet = W.load_sd15_unet(path, TINY)
    vae = W.load_sd15_vae(path, VAEConfig(**VAE_KW))
    text = W.load_sd15_text_encoder(path, CLIPTextConfig(**TEXT_KW))
    cn = W.load_controlnet(osp.join(path, "controlnet"), controlnet_config(TINY))
    W.load_adapter_checkpoint(osp.join(path, "adapter.pth"), unet.controlnet_adapter)

    in_file = _sd15_unet(unet_state_dict(trees["unet"]), with_adapter=variant == 1)
    _assert_equal_on(unet.state_dict(), unet_state_dict(j_unet), list(in_file))
    _assert_equal_on(unet.controlnet_adapter.state_dict(), adapter_state_dict(j_adapter),
                     list(adapter_state_dict(trees["unet"]["controlnet_adapter"])))
    _assert_equal_on(vae.state_dict(), vae_state_dict(j_vae), list(vae.state_dict()))
    ref_text = clip_text_state_dict(j_text)
    _assert_equal_on(text.state_dict(), ref_text,
                     [k for k in ref_text if not k.endswith("position_ids")])
    _assert_equal_on(cn.state_dict(), controlnet_state_dict(j_cn), list(cn.state_dict()))
    # what the file lacks keeps the port's init: temporal outputs zero
    sd = unet.state_dict()
    assert sd["down_blocks.0.resnets.0.temp_conv1.weight"].abs().max() == 0
    assert sd["down_blocks.0.attentions.0.transformer_blocks.0.attn_temp.to_out.0.weight"].abs(
    ).max() == 0


def test_loaded_unet_forward_matches_jax(tmp_path, trees):
    """A UNet forward on the loaded tiny weights against JAX's on its loaded
    tree, atol 1e-4. The leaves JAX keeps from its own init (the adapter)
    are carried into the port through from_jax. JAX's ``_merge`` replaces
    each block list whole, so its loaded tree holds no temporal modules at
    all; the port keeps them at their zero-output init, which adds nothing,
    so the two forwards are the same function."""
    path = write_weights(tmp_path, trees, "safetensors", 0)
    j_unet = JW.load_sd15_unet(path, JAX_TINY)
    unet = W.load_sd15_unet(path, TINY).eval()
    file_keys = set(_sd15_unet(unet_state_dict(trees["unet"])))
    carried = {k: v for k, v in unet_state_dict(j_unet).items() if k not in file_keys}
    assert carried and all(k.startswith("controlnet_adapter.") for k in carried)
    unet.load_state_dict(carried, strict=False)
    missing = set(unet.state_dict()) - set(unet_state_dict(j_unet))
    assert missing and all(any(t in k for t in VIDEO_ONLY[:4]) for k in missing)
    rng = np.random.default_rng(7)
    x, cond = normal(rng, (1, 2, 16, 16, 4), 0.3), normal(rng, (1, 7, 16), 0.3)
    ref = jax.jit(lambda p, x, c: jax_unet_apply(p, JAX_TINY, x, jnp.asarray(500), c))(
        j_unet, jnp.asarray(x), jnp.asarray(cond))
    with torch.no_grad():
        got = unet_apply(unet, TINY, tensor(x), 500, tensor(cond))
    assert float(np.abs(np.asarray(ref)).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


# -- strictness ---------------------------------------------------------------


def _mutate(path, fn):
    sd = W.load_state_dict(path)
    _save(fn(dict(sd)), path)


@pytest.mark.parametrize("fault", ["unexpected", "shape", "partial_temporal",
                                   "partial_adapter"])
def test_unet_loader_refuses(tmp_path, trees, fault):
    path = write_weights(tmp_path, trees, "bin", 1)
    file = osp.join(path, "unet", "diffusion_pytorch_model.bin")
    temporal = "down_blocks.0.resnets.0.temp_conv1"
    full = unet_state_dict(trees["unet"])
    edits = {
        "unexpected": lambda sd: {**sd, "conv_in.extra": torch.zeros(1)},
        "shape": lambda sd: {**sd, "conv_in.bias": torch.zeros(3)},
        # a temporal module that the file holds in part
        "partial_temporal": lambda sd: {**sd, temporal + ".weight": full[temporal + ".weight"]},
        "partial_adapter": lambda sd: {k: v for k, v in sd.items()
                                       if k != "controlnet_adapter.body.0.ff_norm.bias"},
    }
    _mutate(file, edits[fault])
    key = {"unexpected": "conv_in.extra", "shape": "conv_in.bias",
           "partial_temporal": temporal + ".bias",
           "partial_adapter": "controlnet_adapter.body.0.ff_norm.bias"}[fault]
    with pytest.raises((KeyError, ValueError), match=key.replace(".", r"\.")):
        W.load_sd15_unet(path, TINY)


@pytest.mark.parametrize("which", ["vae", "controlnet", "adapter", "text"])
def test_other_loaders_refuse_an_unexpected_key(tmp_path, trees, which):
    path = write_weights(tmp_path, trees, "bin", 0)
    files = {"vae": osp.join(path, "vae", "diffusion_pytorch_model.bin"),
             "controlnet": osp.join(path, "controlnet", "diffusion_pytorch_model.bin"),
             "adapter": osp.join(path, "adapter.pth"),
             "text": osp.join(path, "text_encoder", "pytorch_model.bin")}
    _mutate(files[which], lambda sd: {**sd, "stray.weight": torch.zeros(2)})
    load = {"vae": lambda: W.load_sd15_vae(path, VAEConfig(**VAE_KW)),
            "controlnet": lambda: W.load_controlnet(osp.join(path, "controlnet"),
                                                    controlnet_config(TINY)),
            "adapter": lambda: W.load_adapter_checkpoint(
                files["adapter"], UNet3DConditionModel(TINY).controlnet_adapter),
            "text": lambda: W.load_sd15_text_encoder(path, CLIPTextConfig(**TEXT_KW))}
    with pytest.raises((KeyError, RuntimeError), match="stray"):
        load[which]()


def _manifest(name):
    with open(osp.join(MANIFEST_DIR, name + ".txt")) as f:
        return {key: torch.empty(tuple(int(d) for d in shape.split(",")), device="meta")
                for key, shape in (line.split() for line in f)}


@pytest.mark.parametrize("name", ["sd15_unet", "sd15_vae", "sd15_clip_text",
                                  "controlnet_openpose"])
def test_full_width_manifests_load_on_meta(name):
    """The real checkpoints' key sets and shapes onto the full-width modules,
    on the meta device: no key left over on either side but the modules
    SD-1.5 lacks; one extra key or one wrong shape raises."""
    sd = _manifest(name)
    with torch.device("meta"):
        module, fixed, optional = {
            "sd15_unet": lambda: (UNet3DConditionModel(UNetConfig()), sd, W._video_group),
            "sd15_vae": lambda: (AutoencoderKL(), W.vae_key_fixups(sd), None),
            "sd15_clip_text": lambda: (CLIPTextModel(), W.text_key_fixups(sd),
                                       lambda k: k if k.endswith("position_ids") else None),
            "controlnet_openpose": lambda: (ControlNetModel(controlnet_config()), sd, None),
        }[name]()
    W.load_into(module, fixed, name, optional)
    extra = dict(fixed, **{"mid_block.stray.weight": torch.empty(1, device="meta")})
    with pytest.raises(KeyError, match="stray"):
        W.load_into(module, extra, name, optional)
    key = next(iter(fixed))
    wrong = dict(fixed, **{key: torch.empty(7, device="meta")})
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        W.load_into(module, wrong, name, optional)


# -- the safetensors reader ---------------------------------------------------


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(3)
    sd = {"a.f32": torch.randn(3, 5, generator=g),
          "b.f16": torch.randn(7, generator=g).half(),
          "c.bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
          "d.i64": torch.arange(77)[None],
          "e.scalar": torch.tensor(1.5),
          "f.empty": torch.zeros(0, 4)}
    path = str(tmp_path / "x.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    got, ref = W.read_safetensors(path), load_file(path)
    assert got.keys() == ref.keys() == sd.keys()
    for k in sd:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert torch.equal(got[k], ref[k]), k


def test_find_model_file_order(tmp_path):
    for name in ("pytorch_model.bin", "model.safetensors", "diffusion_pytorch_model.bin"):
        (tmp_path / name).write_bytes(b"")
        assert W.find_model_file(str(tmp_path)) == str(tmp_path / name)
        assert JW.find_model_file(str(tmp_path)) == str(tmp_path / name)
    with pytest.raises(FileNotFoundError):
        W.find_model_file(str(tmp_path / "none"))


# -- the entry point ----------------------------------------------------------


def test_inference_edit_runs_on_loaded_weights(tmp_path, trees, capsys):
    """inference.edit on a tiny synthetic weights directory, a ControlNet
    directory and the reference's .pth adapter (the parent tree raised
    NotImplementedError for both); the pipeline's models hold the files'
    weights. need_controlnet=False reads no ControlNet file."""
    from torch_p2p_helpers import write_clip

    path = write_weights(tmp_path / "weights", trees, "safetensors", 0)
    cfg = TCF.load_config(osp.join(REPO, "configs", "smoke", "eval.yaml"))
    cfg.pretrained_model_path = path
    cfg.controlnet_path = osp.join(path, "controlnet")
    cfg.adapter_weight_path = osp.join(path, "adapter.pth")
    cfg.input_data.video_dir = write_clip(tmp_path / "case")
    kw = dict(dtype=torch.float32, unet_config=TINY, vae_config=VAEConfig(**VAE_KW),
              text_config=CLIPTextConfig(**TEXT_KW), tokenizer=StubTokenizer())
    pipe = inference.build_pipeline(cfg, torch.device("cpu"), **kw)
    out = capsys.readouterr().out
    assert "loading SD-1.5 weights" in out and "loaded adapter weights" in out
    adapter = adapter_state_dict(trees["unet"]["controlnet_adapter"])
    _assert_equal_on(pipe.unet.controlnet_adapter.state_dict(), adapter, list(adapter))
    _assert_equal_on(pipe.controlnet.state_dict(), controlnet_state_dict(trees["controlnet"]),
                     list(pipe.controlnet.state_dict()))
    batch = VideoDataset(**vars(cfg.input_data))[0]
    samples = inference.edit(pipe, cfg, batch)
    got = samples[cfg.validation_data.prompts[0]]
    assert got.shape == (2, 2, 128, 128, 3) and np.isfinite(got).all()
    # without a ControlNet, its (now unreadable) file is never opened
    (tmp_path / "weights" / "controlnet" / "diffusion_pytorch_model.safetensors").write_bytes(
        b"not a checkpoint")
    pipe = inference.build_pipeline(cfg, torch.device("cpu"), need_controlnet=False, **kw)
    assert pipe.controlnet is None
