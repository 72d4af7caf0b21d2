"""Weight names of the port: the JAX mappers (models/weights.py) read the
port's state_dicts back into the JAX trees exactly; the port's key names
match the real checkpoint inventories (tests/fixtures/manifests); the
port's configs equal the JAX ones."""

import dataclasses
import os.path as osp

import jax
import numpy as np
import pytest
import torch

from motioneditor_tpu.control.injection import InjectionSpec as JaxInjectionSpec
from motioneditor_tpu.models.controlnet import controlnet_config as jax_controlnet_config
from motioneditor_tpu.models.controlnet import init_controlnet
from motioneditor_tpu.models.unet import UNetConfig as JaxUNetConfig, init_unet
from motioneditor_tpu.models.weights import port_adapter, port_controlnet, port_unet

from motioneditor_tpu_torch.control.injection import InjectionSpec
from motioneditor_tpu_torch.models.controlnet import ControlNetModel, controlnet_config
from motioneditor_tpu_torch.models.from_jax import (
    adapter_state_dict,
    controlnet_state_dict,
    unet_state_dict,
)
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig

from torch_port_helpers import JAX_TINY, TINY_KW, random_params, setup_torch

MANIFEST_DIR = osp.join(osp.dirname(__file__), "fixtures", "manifests")
# modules of the video UNet that the 2D SD-1.5 checkpoint does not hold
VIDEO_ONLY = ("temp_conv1.", "temp_conv2.", ".attn_temp.", ".norm_temp.", "controlnet_adapter.")


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_same_tree(got, want):
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    want_leaves, want_def = jax.tree_util.tree_flatten(want)
    assert got_def == want_def
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _manifest(name):
    with open(osp.join(MANIFEST_DIR, name + ".txt")) as f:
        return {key: tuple(int(d) for d in shape.split(","))
                for key, shape in (line.split() for line in f)}


def _meta_shapes(module_fn):
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in module_fn().state_dict().items()}


def test_unet_and_adapter_roundtrip_through_jax_mappers():
    tree = random_params(lambda: init_unet(jax.random.PRNGKey(0), JAX_TINY), seed=0)
    sd = unet_state_dict(tree)
    _assert_same_tree(port_unet(_numpy(sd), video=True), tree)
    adapter_sd = adapter_state_dict(tree["controlnet_adapter"])
    _assert_same_tree(port_adapter(_numpy(adapter_sd)), tree["controlnet_adapter"])
    # and the port's module takes exactly these keys
    UNet3DConditionModel(UNetConfig(**TINY_KW)).load_state_dict(sd, strict=True)


def test_controlnet_roundtrip_through_jax_mappers():
    cfg = dataclasses.replace(JAX_TINY, video=False, use_sc_attn=False)
    tree = random_params(lambda: init_controlnet(jax.random.PRNGKey(0), cfg), seed=1)
    sd = controlnet_state_dict(tree)
    _assert_same_tree(port_controlnet(_numpy(sd)), tree)
    ControlNetModel(controlnet_config(UNetConfig(**TINY_KW))).load_state_dict(sd, strict=True)


def test_unet_keys_match_sd15_manifest():
    port = _meta_shapes(lambda: UNet3DConditionModel(UNetConfig()))
    manifest = _manifest("sd15_unet")
    for key, shape in manifest.items():
        assert port.get(key) == shape, key
    extra = [k for k in port if k not in manifest]
    assert extra and all(any(tag in k for tag in VIDEO_ONLY) for k in extra), extra


def test_controlnet_keys_match_openpose_manifest():
    port = _meta_shapes(lambda: ControlNetModel(controlnet_config()))
    assert port == _manifest("controlnet_openpose")


def test_configs_match_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(UNetConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JaxUNetConfig)])
    assert dataclasses.asdict(controlnet_config()) == dataclasses.asdict(jax_controlnet_config())
    for cfg in (UNetConfig(), UNetConfig(use_st_attn=True), UNetConfig(use_sc_attn=False)):
        jcfg = JaxUNetConfig(**dataclasses.asdict(cfg))
        assert cfg.down_block_types == jcfg.down_block_types
        assert cfg.up_block_types == jcfg.up_block_types
        assert [cfg.attn1_mode(s) for s in (False, True)] == [
            jcfg.attn1_mode(s) for s in (False, True)]
    assert ([(f.name, f.default) for f in dataclasses.fields(InjectionSpec)]
            == [(f.name, f.default) for f in dataclasses.fields(JaxInjectionSpec)])
