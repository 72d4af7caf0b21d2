"""JAX parameter trees -> this package's state_dicts.

Takes the nested parameter dicts of ``motioneditor_tpu`` (``init_unet``,
``init_controlnet``, ``init_vae``, ``init_clip_text``, ``init_clip_image``,
``init_lpips``, or any tree with the same structure) with numpy-convertible
leaves, and returns flat ``{checkpoint key: torch.Tensor}`` dicts for
``load_state_dict``. Layout changes are the inverse of
motioneditor_tpu/models/weights.py:

  linear kernel [in, out]        -> weight [out, in]
  conv kernel HWIO               -> weight OIHW
  temporal conv kernel [K, I, O] -> weight [O, I, K]
  norm scale / bias              -> weight / bias

``trainable_names`` maps a JAX ``trainable_mask`` tree onto the same keys.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _put(sd: Dict[str, torch.Tensor], key: str, kernel, bias=None, perm=None) -> None:
    k = np.asarray(kernel, dtype=np.float32)
    sd[key + ".weight"] = _t(k.transpose(perm) if perm is not None else k)
    if bias is not None:
        sd[key + ".bias"] = _t(bias)


def _lin(sd, key, p):
    _put(sd, key, p["kernel"], p.get("bias"), perm=(1, 0))


def _conv(sd, key, p):
    _put(sd, key, p["kernel"], p.get("bias"), perm=(3, 2, 0, 1))


def _conv1d(sd, key, p):
    _put(sd, key, p["kernel"], p["bias"], perm=(2, 1, 0))


def _norm(sd, key, p):
    _put(sd, key, p["scale"], p["bias"])


def _attn(sd, key, p):
    for name in ("to_q", "to_k", "to_v"):
        _lin(sd, f"{key}.{name}", p[name])
    _lin(sd, f"{key}.to_out.0", p["to_out"])


def _ff(sd, key, p):
    _lin(sd, f"{key}.net.0.proj", p["proj_in"])
    _lin(sd, f"{key}.net.2", p["proj_out"])


def _resnet(sd, key, p):
    for name in ("norm1", "norm2"):
        _norm(sd, f"{key}.{name}", p[name])
    for name in ("conv1", "conv2", "conv_shortcut"):
        if name in p:
            _conv(sd, f"{key}.{name}", p[name])
    if "time_emb_proj" in p:
        _lin(sd, f"{key}.time_emb_proj", p["time_emb_proj"])
    for name in ("temp_conv1", "temp_conv2"):
        if name in p:
            _conv1d(sd, f"{key}.{name}", p[name])


def _transformer2d(sd, key, p):
    _norm(sd, f"{key}.norm", p["norm"])
    _conv(sd, f"{key}.proj_in", p["proj_in"])
    _conv(sd, f"{key}.proj_out", p["proj_out"])
    for i, bp in enumerate(p["blocks"]):
        pre = f"{key}.transformer_blocks.{i}"
        for name in ("norm1", "norm2", "norm3", "norm_temp"):
            if name in bp:
                _norm(sd, f"{pre}.{name}", bp[name])
        for name in ("attn1", "attn2", "attn_temp"):
            if name in bp:
                _attn(sd, f"{pre}.{name}", bp[name])
        _ff(sd, f"{pre}.ff", bp["ff"])


def _block(sd, key, p):
    for j, rp in enumerate(p["resnets"]):
        _resnet(sd, f"{key}.resnets.{j}", rp)
    for j, ap in enumerate(p.get("attentions", [])):
        _transformer2d(sd, f"{key}.attentions.{j}", ap)
    for name in ("downsamplers", "upsamplers"):
        if name in p:
            _conv(sd, f"{key}.{name}.0.conv", p[name][0])


def _encoder(sd, tree):
    _conv(sd, "conv_in", tree["conv_in"])
    _lin(sd, "time_embedding.linear_1", tree["time_embedding"]["linear_1"])
    _lin(sd, "time_embedding.linear_2", tree["time_embedding"]["linear_2"])
    for i, block in enumerate(tree["down_blocks"]):
        _block(sd, f"down_blocks.{i}", block)
    _block(sd, "mid_block", tree["mid_block"])


def adapter_state_dict(tree) -> Dict[str, torch.Tensor]:
    """ControlAdapter tree {"body": [...]} -> state_dict (keys body.i.*)."""
    sd: Dict[str, torch.Tensor] = {}
    for i, bp in enumerate(tree["body"]):
        pre = f"body.{i}"
        _conv1d(sd, f"{pre}.block1", bp["block1"])
        _conv1d(sd, f"{pre}.block2", bp["block2"])
        for name in ("norm_temp", "cross_pose_norm", "ff_norm", "norm_self_temp"):
            _norm(sd, f"{pre}.{name}", bp[name])
        for name in ("attn_temp", "attn_pose", "attn_self_temp"):
            _attn(sd, f"{pre}.{name}", bp[name])
        _ff(sd, f"{pre}.ff", bp["ff"])
    return sd


def unet_state_dict(tree) -> Dict[str, torch.Tensor]:
    """Video UNet tree (``init_unet``, with or without the adapter) -> state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _encoder(sd, tree)
    for i, block in enumerate(tree["up_blocks"]):
        _block(sd, f"up_blocks.{i}", block)
    _norm(sd, "conv_norm_out", tree["conv_norm_out"])
    _conv(sd, "conv_out", tree["conv_out"])
    if "controlnet_adapter" in tree:
        for k, v in adapter_state_dict(tree["controlnet_adapter"]).items():
            sd["controlnet_adapter." + k] = v
    return sd


def controlnet_state_dict(tree) -> Dict[str, torch.Tensor]:
    """ControlNet tree (``init_controlnet``) -> state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _encoder(sd, tree)
    emb = tree["controlnet_cond_embedding"]
    _conv(sd, "controlnet_cond_embedding.conv_in", emb["conv_in"])
    for i, bp in enumerate(emb["blocks"]):
        _conv(sd, f"controlnet_cond_embedding.blocks.{i}", bp)
    _conv(sd, "controlnet_cond_embedding.conv_out", emb["conv_out"])
    for i, zc in enumerate(tree["controlnet_down_blocks"]):
        _conv(sd, f"controlnet_down_blocks.{i}", zc)
    _conv(sd, "controlnet_mid_block", tree["controlnet_mid_block"])
    return sd


def _vae_attention(sd, key, p):
    # a real SD-1.5 checkpoint keeps the legacy names (weights.py:261-280)
    _norm(sd, f"{key}.group_norm", p["group_norm"])
    for name, src in (("query", "to_q"), ("key", "to_k"), ("value", "to_v"),
                      ("proj_attn", "to_out")):
        _lin(sd, f"{key}.{name}", p[src])


def vae_state_dict(tree) -> Dict[str, torch.Tensor]:
    """VAE tree (``init_vae``) -> state_dict; the inverse of ``port_vae``."""
    sd: Dict[str, torch.Tensor] = {}
    for half, blocks in (("encoder", "down_blocks"), ("decoder", "up_blocks")):
        t = tree[half]
        _conv(sd, f"{half}.conv_in", t["conv_in"])
        for i, block in enumerate(t[blocks]):
            _block(sd, f"{half}.{blocks}.{i}", block)
        for j, rp in enumerate(t["mid_block"]["resnets"]):
            _resnet(sd, f"{half}.mid_block.resnets.{j}", rp)
        _vae_attention(sd, f"{half}.mid_block.attentions.0", t["mid_block"]["attentions"][0])
        _norm(sd, f"{half}.conv_norm_out", t["conv_norm_out"])
        _conv(sd, f"{half}.conv_out", t["conv_out"])
    _conv(sd, "quant_conv", tree["quant_conv"])
    _conv(sd, "post_quant_conv", tree["post_quant_conv"])
    return sd


def clip_text_state_dict(tree) -> Dict[str, torch.Tensor]:
    """CLIP text tree (``init_clip_text``) -> state_dict (keys text_model.*);
    the inverse of ``port_clip_text``."""
    pre = "text_model"
    n_pos = np.shape(tree["position_embedding"])[0]
    sd: Dict[str, torch.Tensor] = {
        f"{pre}.embeddings.token_embedding.weight": _t(tree["token_embedding"]),
        f"{pre}.embeddings.position_embedding.weight": _t(tree["position_embedding"]),
        f"{pre}.embeddings.position_ids": torch.arange(n_pos)[None],
    }
    _clip_layers(sd, pre, tree["layers"])
    _norm(sd, f"{pre}.final_layer_norm", tree["final_layer_norm"])
    if "text_projection" in tree:
        _put(sd, "text_projection", tree["text_projection"]["kernel"], perm=(1, 0))
    return sd


def _clip_layers(sd, pre, layers):
    for i, lp in enumerate(layers):
        key = f"{pre}.encoder.layers.{i}"
        _norm(sd, f"{key}.layer_norm1", lp["layer_norm1"])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(sd, f"{key}.self_attn.{name}", lp[name])
        _norm(sd, f"{key}.layer_norm2", lp["layer_norm2"])
        _lin(sd, f"{key}.mlp.fc1", lp["fc1"])
        _lin(sd, f"{key}.mlp.fc2", lp["fc2"])


def clip_image_state_dict(tree) -> Dict[str, torch.Tensor]:
    """CLIP image tree (``init_clip_image``) -> state_dict (keys
    vision_model.*, visual_projection.weight); the inverse of
    ``port_clip_image``."""
    pre = "vision_model"
    n_pos = np.shape(tree["position_embedding"])[0]
    sd: Dict[str, torch.Tensor] = {
        f"{pre}.embeddings.class_embedding": _t(tree["class_embedding"]),
        f"{pre}.embeddings.patch_embedding.weight": _t(
            np.asarray(tree["patch_embedding"], np.float32).transpose(3, 2, 0, 1)),
        f"{pre}.embeddings.position_embedding.weight": _t(tree["position_embedding"]),
        f"{pre}.embeddings.position_ids": torch.arange(n_pos)[None],
    }
    _norm(sd, f"{pre}.pre_layrnorm", tree["pre_layernorm"])
    _clip_layers(sd, pre, tree["layers"])
    _norm(sd, f"{pre}.post_layernorm", tree["post_layernorm"])
    _put(sd, "visual_projection", tree["visual_projection"]["kernel"], perm=(1, 0))
    return sd


def lpips_state_dict(tree) -> Dict[str, torch.Tensor]:
    """LPIPS tree (``init_lpips``: convs + lins) -> state_dict (keys
    features.{0,3,6,8,10}.*, lin{i}.model.1.weight)."""
    sd: Dict[str, torch.Tensor] = {}
    for i, cp in zip((0, 3, 6, 8, 10), tree["convs"]):
        _conv(sd, f"features.{i}", cp)
    for i, lp in enumerate(tree["lins"]):
        sd[f"lin{i}.model.1.weight"] = _t(np.asarray(lp["kernel"], np.float32)[:, 0][None, :,
                                                                                      None, None])
    return sd


_MODULES = {
    "linear": _lin,
    "conv": _conv,
    "temporal_conv": _conv1d,
    "norm": _norm,
    "attention": _attn,
    "feed_forward": _ff,
    "resnet": _resnet,
    "transformer2d": _transformer2d,
}


def module_state_dict(kind: str, tree) -> Dict[str, torch.Tensor]:
    """One module's tree -> its state_dict, keys relative to the module.
    ``kind``: linear, conv, temporal_conv, norm, attention, feed_forward,
    resnet or transformer2d."""
    sd: Dict[str, torch.Tensor] = {}
    _MODULES[kind](sd, "", tree)
    return {k[1:]: v for k, v in sd.items()}  # drop the leading "."


def _zip_map(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_zip_map(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def trainable_names(mask_tree, params_tree, convert=unet_state_dict) -> set:
    """The parameter names that a JAX ``trainable_mask`` tree (boolean
    leaves, the structure of ``params_tree``) marks trainable, under the
    state_dict converter ``convert``."""
    full = _zip_map(lambda m, p: np.full(np.shape(p), float(bool(m)), np.float32), mask_tree,
                    params_tree)
    return {k for k, v in convert(full).items() if bool(v.all())}


def _conv_tree(sd, tree, prefix=""):
    """{layer: {"kernel", "bias"?}} -> ``{prefix}{layer}.weight`` / ``.bias``."""
    for layer, p in tree.items():
        _conv(sd, prefix + layer, p)


def openpose_body_state_dict(tree) -> Dict[str, torch.Tensor]:
    """OpenPose body tree (``init_body_params``: {"model0": {...},
    "model1_1": ...}) -> ``BodyPoseModel`` state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for mod, layers in tree.items():
        _conv_tree(sd, layers, mod + ".")
    return sd


openpose_hand_state_dict = openpose_body_state_dict  # the same {module: {layer}} nesting


def openpose_face_state_dict(tree) -> Dict[str, torch.Tensor]:
    """OpenPose face tree (``init_face_params``, flat) -> ``FaceModel`` state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _conv_tree(sd, tree)
    return sd


def dpt_state_dict(tree) -> Dict[str, torch.Tensor]:
    """MiDaS DPT-Hybrid tree (``init_dpt_params``) -> ``DPTHybrid`` state_dict
    in the dpt_hybrid checkpoint layout; the inverse of
    ``convert_dpt_state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    bb = "pretrained.model.patch_embed.backbone."
    _conv(sd, bb + "stem.conv", tree["backbone"]["stem"]["conv"])
    _norm(sd, bb + "stem.norm", tree["backbone"]["stem"]["norm"])
    for s, blocks in enumerate(tree["backbone"]["stages"]):
        for b, blk in enumerate(blocks):
            pre = f"{bb}stages.{s}.blocks.{b}."
            for i in (1, 2, 3):
                _conv(sd, f"{pre}conv{i}", blk[f"conv{i}"])
                _norm(sd, f"{pre}norm{i}", blk[f"norm{i}"])
            if "down_conv" in blk:
                _conv(sd, pre + "downsample.conv", blk["down_conv"])
                _norm(sd, pre + "downsample.norm", blk["down_norm"])
    vm, vit = "pretrained.model.", tree["vit"]
    sd[vm + "cls_token"] = _t(vit["cls_token"])
    sd[vm + "pos_embed"] = _t(vit["pos_embed"])
    _conv(sd, vm + "patch_embed.proj", vit["patch_proj"])
    for i, blk in enumerate(vit["blocks"]):
        pre = f"{vm}blocks.{i}."
        _norm(sd, pre + "norm1", blk["norm1"])
        _lin(sd, pre + "attn.qkv", blk["qkv"])
        _lin(sd, pre + "attn.proj", blk["proj"])
        _norm(sd, pre + "norm2", blk["norm2"])
        _lin(sd, pre + "mlp.fc1", blk["fc1"])
        _lin(sd, pre + "mlp.fc2", blk["fc2"])
    for level in (3, 4):
        post, pre = tree[f"post{level}"], f"pretrained.act_postprocess{level}."
        _lin(sd, pre + "0.project.0", post["project"])
        _conv(sd, pre + "3", post["conv"])
        if "down" in post:
            _conv(sd, pre + "4", post["down"])
    sc = tree["scratch"]
    for i in range(1, 5):
        _conv(sd, f"scratch.layer{i}_rn", sc[f"layer{i}_rn"])
        rn, pre = sc[f"refinenet{i}"], f"scratch.refinenet{i}."
        _conv(sd, pre + "out_conv", rn["out_conv"])
        for j in (1, 2):
            for k in (1, 2):
                _conv(sd, f"{pre}resConfUnit{j}.conv{k}", rn[f"rcu{j}"][f"conv{k}"])
    for i, name in ((0, "head_conv1"), (2, "head_conv2"), (4, "head_conv3")):
        _conv(sd, f"scratch.output_conv.{i}", sc[name])
    return sd
