"""The reductions tensor parallelism must run over the right group, each on
a (1, 1, 2) layout of gloo ranks (tests/torch_tp_workers.py ``faults``)
against the whole computation in one process, at a few hundred elements:

- the auto-mask injection of a split Attention runs on its model rank's
  heads: its scale and head split are those of H / T heads (1e-5 of the
  output's magnitude);
- the cross-attention maps a split Attention collects are the mean over
  every head, not over the local ones (1e-6);
- a sharded step's sums leave a replicated gradient and a loss share
  alone on a layout whose ranks are all model ranks (no sum over the
  model group), and ``mse``'s share is the plain mean there;
- the global-norm clip sums a split weight's squares over the model group
  and a replicated bias's once: the norm and the parameters after two
  clipped AdamW steps equal the whole tensors' (rtol 1e-6, atol 1e-7);
- 8-bit AdamW quantizes a column-split weight whose local blocks are not
  the full tensor's ([6, 200] split into [6, 100]) with the full tensor's
  block scales: after two steps the gathered codes and the scales equal
  the whole tensor's bit for bit.

And without a process group: ``quantize_split`` of each of the two blocks
of a column-split moment, their block maxima combined as the all-reduce
combines them, gives the full tensor's codes and scales bit for bit.
"""

import numpy as np
import pytest
import torch

import torch_sharding_workers as workers
import torch_tp_workers as tp_workers
from motioneditor_tpu_torch.parallel import tp
from motioneditor_tpu_torch.training import adam8bit
from torch_port_helpers import normal, setup_torch


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    setup_torch()
    rng = np.random.default_rng(41)
    t = lambda *shape, s=1.0: torch.from_numpy(normal(rng, shape, s))  # noqa: E731
    maps = torch.softmax(t(8, 256, 5, s=3.0), dim=-1)  # [4 F, 256, L]
    inputs = dict(c=32, heads=4, tok4=t(4, 2, 16, 32), small=t(1, 2, 16, 32), enc=t(1, 5, 16),
                  mask=torch.from_numpy((rng.random((2, 16, 1)) > 0.5).astype(np.float32)),
                  maps=maps, grad=t(10), pred=t(2, 3), target=t(2, 3), w=t(6, 200, s=0.1),
                  b=t(6, s=0.1), grads=[(t(6, 200), t(6)) for _ in range(2)], max_norm=0.5)
    tmp = tmp_path_factory.mktemp("tp_faults")
    workers.spawn(tp_workers.faults, (1, 1, 2), tmp, inputs)
    return torch.load(tmp / "results.pt")


def test_auto_mask_runs_on_the_local_heads(results):
    assert results["auto"] < 1e-5


def test_cross_attention_maps_mean_over_every_head(results):
    assert results["maps"] < 1e-6


def test_step_sums_skip_the_model_group(results):
    loss, grad_kept = results["step_sum"]
    assert loss == 0.5 and grad_kept


def test_loss_share_is_the_mean_over_the_model_group(results):
    share, plain = results["mse"]
    np.testing.assert_allclose(share, plain, rtol=1e-6)


def test_clip_norm_sums_split_squares_over_the_model_group(results):
    got, ref = results["optimizer"]["clip_tp"], results["optimizer"]["clip_one"]
    assert min(ref["norms"]) > 10 * 0.5  # the clip acts at both steps
    np.testing.assert_allclose(got["norms"], ref["norms"], rtol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-7)


def test_8bit_moments_take_the_full_layout_scales(results):
    got, ref = results["optimizer"]["8bit_tp"], results["optimizer"]["8bit_one"]
    assert ref["m"].shape == got["m"].shape == (5, 256)  # 1200 elements, padded
    for k in ("m", "v", "m_scale", "v_scale", "w"):
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("signed", [True, False])
def test_split_moment_codes_equal_the_unsplit_codes(signed, monkeypatch):
    """Pure CPU: each block's partial maxima recorded, then every rank's
    quantization handed their elementwise max, as the model group's MAX
    all-reduce does."""
    rng = np.random.default_rng(42)
    x = torch.from_numpy(normal(rng, (6, 200), 0.01))
    if not signed:
        x = x * x
    x[:, 150:] = 0.0  # blocks whose maximum one rank alone holds
    t, cols = 2, 100
    partials = []
    monkeypatch.setattr(tp, "max_over_model", lambda v, group: partials.append(v) or v)
    parts = [x[:, m * cols:(m + 1) * cols].contiguous() for m in range(t)]
    nblocks = -(-x.numel() // adam8bit.BLOCK)
    blocks = [adam8bit.full_blocks(p.shape, 1, t, m) for m, p in enumerate(parts)]
    for m, p in enumerate(parts):
        adam8bit.quantize_split(p, signed, blocks[m], nblocks, None)
    top = torch.maximum(*partials)
    monkeypatch.setattr(tp, "max_over_model", lambda v, group: top)
    got = [adam8bit.quantize_split(p, signed, blocks[m], nblocks, None)
           for m, p in enumerate(parts)]
    ref_q, ref_scale = adam8bit.quantize(x, signed)
    full = torch.cat([q for q, _ in got], dim=1)
    assert torch.equal(adam8bit.codes_to_full(full), ref_q)
    assert torch.equal(adam8bit.codes_from_full(ref_q, x.shape), full)
    for _, scale in got:
        assert torch.equal(scale, ref_scale)
    back = torch.cat([adam8bit.dequantize_split(q, s, blocks[m]) for m, (q, s) in enumerate(got)],
                     dim=1)
    assert torch.equal(back, adam8bit.dequantize(ref_q, ref_scale, x))
