"""Tensor parallelism in the port (motioneditor_tpu_torch/parallel/tp.py and
the model group of parallel/mesh.py) on the CPU:

- the split set: on the tiny UNet with its adapter and on the ControlNet,
  the parameters ``tp_split_plan`` splits are the leaves whose JAX
  ``tp_param_shardings`` spec is not empty (a one-device (1, 1, 1) mesh:
  the specs do not depend on the model size there), through
  models/from_jax.py's names; a site whose heads T does not divide stays
  whole;
- the blocks: ``narrow_params`` at every index concatenates back to each
  weight, and ``gather_params_tp`` undoes ``shard_params_tp`` on 2 ranks;
- one attention layer of each kind (spatial motion_frame at N = 1024 on
  the kernels' route, whose plain versions run on the CPU; cross; temporal
  at N = 1024; mask injection at N = 1024), with a nonzero to_out.0 bias,
  on 2 gloo ranks of a (1, 1, 2) layout: forward and gradients with
  respect to the inputs and every weight against one process, within 1e-5
  of their magnitude;
- the routers at every SD-1.5 site's head-local width for T = 2 and 4:
  ``tensor_core_body`` as at full width, and the ``temporal_tile`` of K3
  and of K14's 4-of-8-frame shard, pinned;
- the rank layout and groups of (1, 2, 2) and of (2, 2, 1) (rank = (d fp
  + f) tp + m; the (2, 2, 1) groups as before the model axis).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_tp_workers as tp_workers
import torch_sharding_workers as workers
from motioneditor_tpu.models.controlnet import init_controlnet
from motioneditor_tpu.models.unet import init_unet
from motioneditor_tpu.parallel.mesh import create_mesh
from motioneditor_tpu.parallel.tp import tp_param_shardings

from motioneditor_tpu_torch.models.controlnet import ControlNetModel, controlnet_config
from motioneditor_tpu_torch.models.from_jax import (
    controlnet_state_dict,
    trainable_names,
    unet_state_dict,
)
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from motioneditor_tpu_torch.ops.attention import split_heads
from motioneditor_tpu_torch.ops.temporal_flash import SMEM_LIMIT, temporal_tile
from motioneditor_tpu_torch.ops.video_flash import rows_aligned, tensor_core_body
from motioneditor_tpu_torch.parallel import tp
from torch_port_helpers import JAX_TINY, TINY_KW, normal, setup_torch

META = torch.device("meta")
TINY = UNetConfig(**TINY_KW)


# ---------------------------------------------------------------------------
# the split set against JAX's
# ---------------------------------------------------------------------------


def _jax_split_names(init_fn, convert):
    shapes = jax.eval_shape(init_fn)
    specs = tp_param_shardings(shapes, create_mesh((1, 1, 1), jax.devices()[:1]))
    mask = jax.tree_util.tree_map(lambda s: any(s.spec), specs)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return trainable_names(mask, zeros, convert)


@pytest.fixture(scope="module")
def port_models():
    with META:
        return UNet3DConditionModel(TINY), ControlNetModel(controlnet_config(TINY))


@pytest.mark.parametrize("model", ["unet", "controlnet"])
@pytest.mark.parametrize("t", [1, 2, 4])
def test_split_set_matches_jax(port_models, model, t):
    if model == "unet":
        ref = _jax_split_names(lambda: init_unet(jax.random.PRNGKey(0), JAX_TINY),
                               unet_state_dict)
        module = port_models[0]
    else:
        cn_config = dataclasses.replace(JAX_TINY, video=False, use_sc_attn=False)
        ref = _jax_split_names(lambda: init_controlnet(jax.random.PRNGKey(1), cn_config),
                               controlnet_state_dict)
        module = port_models[1]
    plan = tp.tp_split_plan(module, t)
    assert set(plan) == ref
    assert len(plan) > (50 if model == "unet" else 20)
    assert all(dim == (1 if name.endswith("to_out.0.weight") else 0)
               for name, dim in plan.items())
    assert any(".controlnet_adapter." in f".{name}" for name in plan) == (model == "unet")


def test_sites_whose_heads_do_not_divide_stay_whole(port_models):
    """T = 8: the tiny UNet's 4-head sites stay whole, the adapter's 8-head
    sites split."""
    plan = tp.tp_split_plan(port_models[0], 8)
    assert plan and all(name.startswith("controlnet_adapter.") for name in plan)
    assert not tp.tp_split_plan(port_models[1], 8)


@pytest.mark.parametrize("t", [2, 4])
def test_blocks_concatenate_back_to_every_weight(t):
    torch.manual_seed(0)
    unet = UNet3DConditionModel(TINY)
    plan = tp.tp_split_plan(unet, t)
    blocks = []
    for m in range(t):
        part = UNet3DConditionModel(TINY)
        part.load_state_dict(unet.state_dict())
        tp.narrow_params(part, plan, t, m)
        blocks.append(part.state_dict())
    for name, w in unet.state_dict().items():
        if name in plan:
            assert blocks[0][name].shape[plan[name]] == w.shape[plan[name]] // t
            got = torch.cat([b[name] for b in blocks], dim=plan[name])
        else:
            got = blocks[t - 1][name]
        assert torch.equal(got, w), name


# ---------------------------------------------------------------------------
# one layer of each kind on 2 ranks, against one process
# ---------------------------------------------------------------------------

LAYER_SITES = ["spatial_motion_frame", "cross", "temporal", "injection"]


@pytest.fixture(scope="module")
def layer_results(tmp_path_factory):
    setup_torch()
    rng = np.random.default_rng(21)
    t = lambda *shape: torch.from_numpy(normal(rng, shape))  # noqa: E731
    inputs = dict(c=32, heads=4, tok=t(1, 2, 1024, 32), tok4=t(4, 2, 1024, 32),
                  small=t(1, 2, 16, 32), enc=t(1, 5, 16),
                  mask=torch.from_numpy((rng.random((2, 1024, 1)) > 0.5).astype(np.float32)))
    tmp = tmp_path_factory.mktemp("tp_layers")
    workers.spawn(tp_workers.layers, (1, 1, 2), tmp, inputs)
    return torch.load(tmp / "results.pt")


@pytest.mark.parametrize("site", LAYER_SITES)
def test_tp_layer_forward_and_gradients_match_one_process(layer_results, site):
    got = layer_results[site]
    assert got.pop("gathered_equal")
    assert [name for name, _ in got.pop("split")] == [
        "to_k.weight", "to_out.0.weight", "to_q.weight", "to_v.weight"]
    assert "grad to_out.0.bias" in got and "grad x" in got
    assert ("grad enc" in got) == (site == "cross")
    for key, err in got.items():
        assert err < 1e-5, (site, key, err)


# ---------------------------------------------------------------------------
# the routers at the head-local widths of SD-1.5
# ---------------------------------------------------------------------------

SD15_SITES = [(4096, 320), (1024, 640), (256, 1280), (64, 1280)]  # (N, C), 8 heads
# (C, T) -> the temporal tile of K3 (Fq = Fk = 8) and of K14 at a 4-of-8
# query-frame shard, as (sites, heads, rows, split, stages, warps, smem);
# only C = 320 at T = 4 (2 heads of 40) moves off the full width's tile
TILES = {
    (320, 1): ((4, 4, 2, 2, 2, 4, 61456), (4, 4, 1, 4, 2, 8, 51216)),
    (320, 2): ((4, 4, 2, 2, 2, 4, 61456), (4, 4, 1, 4, 2, 8, 51216)),
    (320, 4): ((8, 2, 2, 2, 2, 4, 61456), (8, 2, 1, 4, 2, 8, 51216)),
    (640, 1): ((4, 2, 2, 4, 2, 4, 61456), (5, 2, 1, 4, 2, 5, 64016)),
    (640, 2): ((4, 2, 2, 4, 2, 4, 61456), (5, 2, 1, 4, 2, 5, 64016)),
    (640, 4): ((4, 2, 2, 4, 2, 4, 61456), (5, 2, 1, 4, 2, 5, 64016)),
}


@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("n,c", SD15_SITES)
def test_head_local_routes(n, c, t):
    heads, d = 8 // t, c // 8
    x = torch.empty((2, 8, n, c // t), dtype=torch.bfloat16)
    views = [split_heads(x, heads).flatten(0, 1)] * 4
    assert tensor_core_body(torch.bfloat16, d, rows_aligned(*views))
    if (c, t) in TILES:
        k3 = temporal_tile(8, 8, d, heads, torch.bfloat16, False)
        k14 = temporal_tile(4, 8, d, heads, torch.bfloat16, False)
        assert (tuple(k3), tuple(k14)) == TILES[(c, t)]
        for tile in (k3, k14):
            assert heads % tile.heads == 0 and tile.smem_bytes <= SMEM_LIMIT


# ---------------------------------------------------------------------------
# the rank layout
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    got = {}
    for layout in ((1, 2, 2), (2, 2, 1)):
        tmp = tmp_path_factory.mktemp("layout")
        workers.spawn(tp_workers.layout, layout, tmp, {})
        got[layout] = [torch.load(tmp / f"rank{r}.pt") for r in range(4)]
    return got


def test_model_minor_rank_layout(layouts):
    for rank, got in enumerate(layouts[(1, 2, 2)]):
        f, m = divmod(rank, 2)
        assert got == dict(frame=(m, 2 + m), data=(rank,), model=(2 * f, 2 * f + 1), fp=2, dp=1,
                           tp=2, frame_rank=f, model_rank=m, shards_frames=True)
    for rank, got in enumerate(layouts[(2, 2, 1)]):
        d, f = divmod(rank, 2)
        assert got == dict(frame=(2 * d, 2 * d + 1), data=(f, 2 + f), model=(), fp=2, dp=2,
                           tp=1, frame_rank=f, model_rank=0, shards_frames=True)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 11t's emulation of a model group, at a small size
# ---------------------------------------------------------------------------


def test_phase_11t_emulation_on_cpu(monkeypatch):
    """Phase 11t on the CPU at two small levels (N = 1024, C = 64, where the
    sites take the kernels' routes and their plain versions run; and
    N = 64, C = 128), 2 frames: every site's T shards, summed, agree with
    the whole layer within TC_ERR_LIMITS (bf16); and K4-K8's sites at
    N = 1024, C = 64: each model rank's output and dq, dk, dv equal the same
    channels of the whole call's within TC_ERR_LIMITS."""
    import chip_smoke as cs

    setup_torch()
    monkeypatch.setattr(cs, "time_ms", lambda fn, reps=3: 0.0)
    monkeypatch.setattr(cs, "card", lambda: "cpu")
    monkeypatch.setattr(cs, "FRAMES", 2)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    results, launched = cs.phase_tp(torch.device("cpu"), levels=((1024, 64), (64, 128)))
    assert len(results) == 14 and launched == {"tp2": {}, "tp4": {}}
    for name, r in results.items():
        for t in cs.TP_SIZES:
            assert r[f"tp{t}"]["vs_kernel"]["max"] <= cs.TC_ERR_LIMITS["max"], name
    results, launched = cs.phase_tp_grad(torch.device("cpu"), levels=((1024, 64),))
    assert len(results) == 3 and launched == {"tp2_grad_layers": {}, "tp4_grad_layers": {}}
    for name, r in results.items():
        for t in cs.TP_SIZES:
            assert r[f"tp{t}"]["max"] <= cs.TC_ERR_LIMITS["max"], name
