"""JAX parameter trees -> this package's state_dicts.

Takes the nested parameter dicts of ``motioneditor_tpu`` (``init_unet``,
``init_controlnet``, ``init_vae``, ``init_clip_text``, ``init_clip_image``,
``init_lpips``, ``init_grounding_dino``, ``init_sam``, or any tree with
the same structure) with numpy-convertible leaves, and returns flat
``{checkpoint key: torch.Tensor}`` dicts for ``load_state_dict``. Layout changes are the inverse of
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


def _mlp(sd, key, p):
    for i, lp in enumerate(p["layers"]):
        _lin(sd, f"{key}.layers.{i}", lp)


def _swin_block(sd, key, p):
    _norm(sd, f"{key}.norm1", p["norm1"])
    _lin(sd, f"{key}.attn.qkv", p["attn"]["qkv"])
    _lin(sd, f"{key}.attn.proj", p["attn"]["proj"])
    sd[f"{key}.attn.relative_position_bias_table"] = _t(p["attn"]["rel_bias_table"])
    _norm(sd, f"{key}.norm2", p["norm2"])
    _lin(sd, f"{key}.mlp.fc1", p["fc1"])
    _lin(sd, f"{key}.mlp.fc2", p["fc2"])


def _swin(sd, key, p):
    _conv(sd, f"{key}.patch_embed.proj", p["patch_embed"]["proj"])
    _norm(sd, f"{key}.patch_embed.norm", p["patch_embed"]["norm"])
    for i, stage in enumerate(p["stages"]):
        for j, bp in enumerate(stage["blocks"]):
            _swin_block(sd, f"{key}.layers.{i}.blocks.{j}", bp)
        if "downsample" in stage:
            _norm(sd, f"{key}.layers.{i}.downsample.norm", stage["downsample"]["norm"])
            _lin(sd, f"{key}.layers.{i}.downsample.reduction", stage["downsample"]["reduction"])
    for name in p:
        if name.startswith("out_norm"):
            _norm(sd, f"{key}.norm{name[len('out_norm'):]}", p[name])


def _bert(sd, key, p):
    e = f"{key}.embeddings"
    sd[f"{e}.word_embeddings.weight"] = _t(p["word_emb"])
    sd[f"{e}.position_embeddings.weight"] = _t(p["pos_emb"])
    sd[f"{e}.token_type_embeddings.weight"] = _t(p["type_emb"])
    _norm(sd, f"{e}.LayerNorm", p["emb_norm"])
    for i, lp in enumerate(p["layers"]):
        pre = f"{key}.encoder.layer.{i}"
        for name, src in (("query", "q"), ("key", "k"), ("value", "v")):
            _lin(sd, f"{pre}.attention.self.{name}", lp[src])
        _lin(sd, f"{pre}.attention.output.dense", lp["attn_out"])
        _norm(sd, f"{pre}.attention.output.LayerNorm", lp["attn_norm"])
        _lin(sd, f"{pre}.intermediate.dense", lp["fc1"])
        _lin(sd, f"{pre}.output.dense", lp["fc2"])
        _norm(sd, f"{pre}.output.LayerNorm", lp["out_norm"])


def _packed_attention(sd, key, p):
    """q / k / v / out -> nn.MultiheadAttention's packed in_proj + out_proj."""
    sd[f"{key}.in_proj_weight"] = _t(np.concatenate(
        [np.asarray(p[n]["kernel"], np.float32).T for n in ("q", "k", "v")], 0))
    sd[f"{key}.in_proj_bias"] = _t(np.concatenate([np.asarray(p[n]["bias"]) for n in "qkv"]))
    _lin(sd, f"{key}.out_proj", p["out"])


def _msdeform(sd, key, p):
    for name in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
        _lin(sd, f"{key}.{name}", p[name])


def _gdino_enc_layer(sd, key, p):
    _msdeform(sd, f"{key}.self_attn", p["self_attn"])
    _norm(sd, f"{key}.norm1", p["norm1"])
    _lin(sd, f"{key}.linear1", p["fc1"])
    _lin(sd, f"{key}.linear2", p["fc2"])
    _norm(sd, f"{key}.norm2", p["norm2"])


def _gdino_text_layer(sd, key, p):
    _packed_attention(sd, f"{key}.self_attn", p["attn"])
    _norm(sd, f"{key}.norm1", p["norm1"])
    _lin(sd, f"{key}.linear1", p["fc1"])
    _lin(sd, f"{key}.linear2", p["fc2"])
    _norm(sd, f"{key}.norm2", p["norm2"])


def _gdino_fusion(sd, key, p):
    _norm(sd, f"{key}.layer_norm_v", p["norm_v"])
    _norm(sd, f"{key}.layer_norm_l", p["norm_l"])
    for name in ("v_proj", "l_proj", "values_v_proj", "values_l_proj", "out_v_proj",
                 "out_l_proj"):
        _lin(sd, f"{key}.attn.{name}", p[name])
    sd[f"{key}.gamma_v"] = _t(p["gamma_v"])
    sd[f"{key}.gamma_l"] = _t(p["gamma_l"])


def _gdino_dec_layer(sd, key, p):
    _packed_attention(sd, f"{key}.self_attn", p["self_attn"])
    _norm(sd, f"{key}.norm2", p["norm2"])
    _packed_attention(sd, f"{key}.ca_text", p["ca_text"])
    _norm(sd, f"{key}.catext_norm", p["catext_norm"])
    _msdeform(sd, f"{key}.cross_attn", p["cross_attn"])
    _norm(sd, f"{key}.norm1", p["norm1"])
    _lin(sd, f"{key}.linear1", p["fc1"])
    _lin(sd, f"{key}.linear2", p["fc2"])
    _norm(sd, f"{key}.norm3", p["norm3"])


def _grounding_dino(sd, key, p):
    _swin(sd, f"{key}.backbone.0", p["backbone"])
    _bert(sd, f"{key}.bert", p["bert"])
    _lin(sd, f"{key}.feat_map", p["feat_map"])
    for i, ip in enumerate(p["input_proj"]):
        _conv(sd, f"{key}.input_proj.{i}.0", ip["conv"])
        _put(sd, f"{key}.input_proj.{i}.1", ip["gn_scale"], ip["gn_bias"])
    t = f"{key}.transformer"
    sd[f"{t}.level_embed"] = _t(p["level_embed"])
    for kind, fn, layers in (("layers", _gdino_enc_layer, "enc_layers"),
                             ("text_layers", _gdino_text_layer, "text_layers"),
                             ("fusion_layers", _gdino_fusion, "fusion_layers")):
        for i, lp in enumerate(p[layers]):
            fn(sd, f"{t}.encoder.{kind}.{i}", lp)
    _lin(sd, f"{t}.enc_output", p["enc_output"])
    _norm(sd, f"{t}.enc_output_norm", p["enc_output_norm"])
    _mlp(sd, f"{t}.enc_out_bbox_embed", p["enc_out_bbox_embed"])
    sd[f"{t}.tgt_embed.weight"] = _t(p["tgt_embed"])
    _mlp(sd, f"{t}.decoder.ref_point_head", p["ref_point_head"])
    for i, lp in enumerate(p["dec_layers"]):
        _gdino_dec_layer(sd, f"{t}.decoder.layers.{i}", lp)
    _norm(sd, f"{t}.decoder.norm", p["dec_norm"])
    _mlp(sd, f"{key}.bbox_embed.0", p["bbox_embed"])


def _sam_vit_block(sd, key, p):
    _norm(sd, f"{key}.norm1", p["norm1"])
    _lin(sd, f"{key}.attn.qkv", p["qkv"])
    _lin(sd, f"{key}.attn.proj", p["proj"])
    sd[f"{key}.attn.rel_pos_h"] = _t(p["rel_pos_h"])
    sd[f"{key}.attn.rel_pos_w"] = _t(p["rel_pos_w"])
    _norm(sd, f"{key}.norm2", p["norm2"])
    _lin(sd, f"{key}.mlp.lin1", p["fc1"])
    _lin(sd, f"{key}.mlp.lin2", p["fc2"])


def _sam_attention(sd, key, p):
    for name in ("q", "k", "v", "out"):
        _lin(sd, f"{key}.{name}_proj", p[name])


def _sam_twoway_block(sd, key, p):
    _sam_attention(sd, f"{key}.self_attn", p["self_attn"])
    _sam_attention(sd, f"{key}.cross_attn_token_to_image", p["ca_t2i"])
    _sam_attention(sd, f"{key}.cross_attn_image_to_token", p["ca_i2t"])
    for i in (1, 2, 3, 4):
        _norm(sd, f"{key}.norm{i}", p[f"norm{i}"])
    _lin(sd, f"{key}.mlp.lin1", p["fc1"])
    _lin(sd, f"{key}.mlp.lin2", p["fc2"])


def _sam(sd, key, p):
    enc, pe, dec = f"{key}.image_encoder", f"{key}.prompt_encoder", f"{key}.mask_decoder"
    _conv(sd, f"{enc}.patch_embed.proj", p["patch_embed"])
    sd[f"{enc}.pos_embed"] = _t(np.asarray(p["pos_embed"])[None])
    for i, bp in enumerate(p["blocks"]):
        _sam_vit_block(sd, f"{enc}.blocks.{i}", bp)
    _conv(sd, f"{enc}.neck.0", p["neck_conv1"])
    _norm(sd, f"{enc}.neck.1", p["neck_ln1"])
    _conv(sd, f"{enc}.neck.2", p["neck_conv2"])
    _norm(sd, f"{enc}.neck.3", p["neck_ln2"])
    sd[f"{pe}.pe_layer.positional_encoding_gaussian_matrix"] = _t(p["pe_gaussian"])
    for i in range(4):
        sd[f"{pe}.point_embeddings.{i}.weight"] = _t(np.asarray(p["point_embed"])[i:i + 1])
    sd[f"{pe}.not_a_point_embed.weight"] = _t(np.asarray(p["not_a_point"])[None])
    sd[f"{pe}.no_mask_embed.weight"] = _t(np.asarray(p["no_mask_embed"])[None])
    sd[f"{dec}.iou_token.weight"] = _t(p["iou_token"])
    sd[f"{dec}.mask_tokens.weight"] = _t(p["mask_tokens"])
    for i, bp in enumerate(p["twoway"]):
        _sam_twoway_block(sd, f"{dec}.transformer.layers.{i}", bp)
    _sam_attention(sd, f"{dec}.transformer.final_attn_token_to_image", p["final_attn"])
    _norm(sd, f"{dec}.transformer.norm_final_attn", p["norm_final"])
    _put(sd, f"{dec}.output_upscaling.0", p["up_conv1"]["kernel"], p["up_conv1"]["bias"])
    _norm(sd, f"{dec}.output_upscaling.1", p["up_ln"])
    _put(sd, f"{dec}.output_upscaling.3", p["up_conv2"]["kernel"], p["up_conv2"]["bias"])
    for i, mp in enumerate(p["hyper_mlps"]):
        _mlp(sd, f"{dec}.output_hypernetworks_mlps.{i}", mp)
    _mlp(sd, f"{dec}.iou_prediction_head", p["iou_head"])


def grounding_dino_state_dict(tree) -> Dict[str, torch.Tensor]:
    """GroundingDINO tree (``init_grounding_dino``) -> ``GroundingDINO``
    state_dict (the official checkpoint's names, packed attention
    projections); the inverse of ``map_groundingdino_state_dict`` on the
    keys the forward reads."""
    return module_state_dict("grounding_dino", tree)


def sam_state_dict(tree) -> Dict[str, torch.Tensor]:
    """SAM tree (``init_sam``) -> ``Sam`` state_dict (the official
    ``sam_vit_*.pth`` names but the mask-prompt downscaler)."""
    return module_state_dict("sam", tree)


_MODULES = {
    "linear": _lin,
    "conv": _conv,
    "temporal_conv": _conv1d,
    "norm": _norm,
    "attention": _attn,
    "feed_forward": _ff,
    "resnet": _resnet,
    "transformer2d": _transformer2d,
    "swin": _swin,
    "grounding_dino": _grounding_dino,
    "sam": _sam,
}


def module_state_dict(kind: str, tree) -> Dict[str, torch.Tensor]:
    """One module's tree -> its state_dict, keys relative to the module.
    ``kind``: linear, conv, temporal_conv, norm, attention, feed_forward,
    resnet, transformer2d, swin (GroundingDINO's backbone), grounding_dino
    or sam."""
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
