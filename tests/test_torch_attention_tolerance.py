"""The scaled error limits that hold the bf16 outputs of K1 and K8
(chip_smoke.py's ``scaled_error`` and ``TC_ERR_LIMITS``, also used by
tests/test_torch_kernels_cuda.py) tell a right output from a wrong one at the main path's
key counts, where an output's RMS (about sqrt(e / keys) on inputs whose
logits are ~N(0, 1)) is smaller than the bf16 atol of 3e-2.

Here on the CPU, with the plain versions, at 8192 keys (motion_frame at
N = 4096) and 32768 (dense, 8 frames): the bf16 plain output against the
fp32 one, a sound rounding difference, passes; outputs that miss one
64-key tile of each K/V pass, or one frame of dense mode's keys, fail the
scaled limits though they pass atol 3e-2 / rtol 1.6e-2.
"""

import pytest
import torch

from chip_smoke import scaled_error
from motioneditor_tpu_torch.ops.video_flash import video_flash_attention_kv_plain
from test_torch_kernels_cuda import TOL

D, TILE = 40, 64


def _inputs(queries: int, frames: int, n: int):
    """q [1, 1, queries, d] and K/V [1, 1, frames * n, d] (the keys of
    ``frames`` source frames of n tokens, concatenated) in bf16."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 1, queries, D), generator=gen).bfloat16()
    k, v = (torch.randn((1, 1, frames * n, D), generator=gen).bfloat16() for _ in range(2))
    return q, k, v


def _attend(q, k, v):
    return video_flash_attention_kv_plain(q, k, v, D ** -0.5, 1)


@pytest.mark.parametrize("frames,n", [(2, 4096), (8, 4096)])
def test_sound_bf16_rounding_passes(frames, n):
    q, k, v = _inputs(256, frames, n)
    ref = _attend(q.float(), k.float(), v.float())
    scaled_error(_attend(q, k, v), ref)


@pytest.mark.parametrize("case", ["tile_per_pass", "dense_frame"])
def test_missing_keys_fail_the_scaled_limits(case):
    if case == "tile_per_pass":  # motion_frame: passes [f-1 | f], each short of one tile
        q, k, v = _inputs(256, 2, 4096)
        keep = torch.ones(2 * 4096, dtype=torch.bool)
        keep[4096 - TILE:4096] = keep[2 * 4096 - TILE:] = False
    else:  # dense over 8 frames with the last frame skipped
        q, k, v = _inputs(256, 8, 4096)
        keep = torch.arange(8 * 4096) < 7 * 4096
    ref = _attend(q.float(), k.float(), v.float())
    out = _attend(q.float(), k[:, :, keep].float(), v[:, :, keep].float()).bfloat16()
    torch.testing.assert_close(out.float(), ref, **TOL[torch.bfloat16])  # the atol misses it
    with pytest.raises(AssertionError, match="error .* of the reference.s"):
        scaled_error(out, ref)
