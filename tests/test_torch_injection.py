"""The port's injection dispatch (control/injection.py) against the JAX
package, fp32 on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.control import injection as JI
from motioneditor_tpu.ops.attention import init_attention

from motioneditor_tpu_torch.control import injection as TI
from motioneditor_tpu_torch.models.from_jax import module_state_dict
from motioneditor_tpu_torch.ops.attention import Attention

from torch_port_helpers import assert_close, normal, random_params, setup_torch, to_jax


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


def test_spec_fields_and_defaults_match_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(TI.InjectionSpec)]
            == [(f.name, f.default) for f in dataclasses.fields(JI.InjectionSpec)])
    for kw in ({}, {"start_layer": 4}, {"mask_fgbg": False}, {"layer_idx": (1, 12)}):
        t, j = TI.InjectionSpec.from_start_layer(**kw), JI.InjectionSpec.from_start_layer(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.mask_fgbg == j.mask_fgbg


@pytest.mark.parametrize("num_steps,start,idx", [(50, 4, None), (10, 0, None), (8, 4, (1, 2, 6))])
def test_segment_step_ranges(num_steps, start, idx):
    assert (TI.segment_step_ranges(num_steps, start, idx)
            == JI.segment_step_ranges(num_steps, start, idx))


def test_masks():
    src = (np.random.default_rng(0).random((3, 40, 40)) > 0.5).astype(np.float32)
    res = ((40, 40), (20, 20), (10, 10), (5, 5))
    out = TI.prepare_injection_masks(torch.from_numpy(src), 3, res)
    ref = JI.prepare_injection_masks(jnp.asarray(src), 3, res)
    assert out.keys() == ref.keys()
    for key in ref:
        assert_close(out[key], ref[key], atol=0)
        assert_close(TI.motion_frame_mask(out[key]), JI.motion_frame_mask(ref[key]), atol=0)


@pytest.mark.parametrize("n", [64, 1024])
@pytest.mark.parametrize("mask_fgbg", [True, False])
def test_injected_spatial_attention(mask_fgbg, n):
    """Mask and mutual modes on both sides of the kernel gate (n = 1024
    reaches the kernels' wrappers, which take their plain versions on CPU)."""
    tree = random_params(lambda: init_attention(jax.random.PRNGKey(0), 32, heads=4), seed=1)
    module = Attention(32, heads=4)
    module.load_state_dict(module_state_dict("attention", tree))
    rng = np.random.default_rng(1)
    x = normal(rng, (4, 3, n, 32))
    mask = (rng.random((3, n, 1)) > 0.5).astype(np.float32)
    with torch.no_grad():
        out = TI.injected_spatial_attention(module, torch.from_numpy(x), 4,
                                            torch.from_numpy(mask), mask_fgbg)
    ref = JI.injected_spatial_attention(to_jax(tree), jnp.asarray(x), 4, jnp.asarray(mask),
                                        mask_fgbg, use_flash=False)
    assert_close(out, ref, atol=2e-5)


def test_injected_temporal_kv_rows():
    x = normal(np.random.default_rng(2), (4, 2, 3, 8))
    assert_close(TI.injected_temporal_kv(torch.from_numpy(x)),
                 JI.injected_temporal_kv(jnp.asarray(x)), atol=0)
