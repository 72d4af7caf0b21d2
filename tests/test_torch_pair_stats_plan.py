"""K10's launch plan, routing and summation order, on the CPU
(ops/gn_stats.py ``pair_stats_plan``, ``vector_body``; the kernel is
csrc/norm_stats.cu).

- The plan for every GroupNorm [B, S, C] of the SD-1.5 UNet at 512 px, 8
  and 24 frames, both pairs, on a card of 132 SMs: the 16-byte vector
  divides C, slices of whole 128-byte lines, at most one block an SM, S
  split (at most PAIR_SPLIT ways, one combine level) exactly where a
  block would read more than PAIR_BLOCK_BYTES, and the block fits the
  kernel. The shapes (chip_smoke.py ``unet_group_norm_shapes``) are
  pinned against the calls a tiny UNet's forward really makes.
- A walk of the plan in the kernel's order reads every row of every
  channel exactly once.
- A torch emulation of the kernel's summation order (each thread's rows
  in fp32 batches of U, the batches compensated, the block's lanes in runs
  of 8, the blocks' partials in chunks of consecutive blocks, the chunk
  sums in order) against JAX's ``_pair_stats`` (its Pallas
  kernel in interpret mode) and the plain version, fp32, to 1e-5 relative
  (as tests/test_torch_gn_stats.py).
- The routing predicate on views 2, 4 and 8 bytes off a 16-byte boundary
  and at C * itemsize % 16 != 0, and the launch it routes: one C entry
  call, one allocation, the plan's arguments, ``.vec`` counted only on the
  16-byte body, a failed launch raised and not retried (a stand-in for the
  kernel library; the kernel itself is held to the plain version on the
  card, tests/test_torch_kernels_cuda.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import unet_group_norm_shapes
from motioneditor_tpu.ops import gn_stats as JG
from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig, unet_apply
from motioneditor_tpu_torch.ops import gn_stats
from motioneditor_tpu_torch.ops.gn_stats import (
    PAIR_BLOCK_BYTES,
    PAIR_SLICE_BYTES,
    PAIR_SPLIT,
    PAIR_THREADS,
    PairStatsPlan,
    channel_pair_stats_plain,
    pair_stats_plan,
    vector_body,
)

from torch_port_helpers import TINY_KW, normal, setup_torch, tensor

SMS = 132  # H100 SXM
DTYPES = (torch.bfloat16, torch.float32)
SD15_SHAPES = sorted({(f, shape) for f in (8, 24) for shape in unet_group_norm_shapes(frames=f)})
U = {True: 8, False: 4}  # rows loaded back to back per thread: (x, x), (dy, x), as the kernel


@pytest.fixture(autouse=True)
def _threads():
    setup_torch()


def test_group_norm_shapes_are_the_unets_calls(monkeypatch):
    """``unet_group_norm_shapes`` at the tiny UNet's widths equals the
    [B, S, C] of every statistics call of its forward, in order."""
    monkeypatch.setenv("MOTIONEDITOR_FUSED_GN", "1")
    calls = []
    monkeypatch.setattr(gn_stats, "channel_pair_stats",
                        lambda a, b: calls.append(tuple(a.shape)) or channel_pair_stats_plain(a, b))
    config = UNetConfig(**TINY_KW)
    torch.manual_seed(0)
    model = UNet3DConditionModel(config, include_adapter=False).eval()
    with torch.no_grad():
        unet_apply(model, config, torch.randn(2, 3, 8, 8, 4), 10, torch.randn(2, 5, 16))
    assert calls == unet_group_norm_shapes(TINY_KW["block_out_channels"], batch=2, frames=3,
                                           latent=8)
    assert len(unet_group_norm_shapes()) == 61


@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("frames,shape", SD15_SHAPES, ids=str)
def test_plan_at_sd15_shapes(frames, shape, dtype, same):
    b, s, c = shape
    plan = pair_stats_plan(b, s, c, dtype, SMS, True, same)
    assert plan.vec * dtype.itemsize == 16 and c % plan.vec == 0
    slices = plan.slices(c)
    assert slices * plan.cols * plan.vec >= c > (slices - 1) * plan.cols * plan.vec
    line = plan.cols * 16  # bytes of a row a slice reads
    assert 128 <= line <= PAIR_SLICE_BYTES[-1]
    assert b * slices * plan.ctas <= SMS  # one block an SM at most
    # slices of 128 bytes a row unless B times those would pass the SMs
    narrow = b * -(-(c // plan.vec) // (PAIR_SLICE_BYTES[0] // 16))
    assert line == PAIR_SLICE_BYTES[0] or narrow > SMS
    block_bytes = -(-s // plan.ctas) * line * (1 if same else 2)
    if plan.ctas == 1:  # a small input, or no SM left for a second block
        assert s * line * (1 if same else 2) <= PAIR_BLOCK_BYTES or 2 * b * slices > SMS
    else:  # split as far as the SMs allow, at most PAIR_SPLIT ways
        assert block_bytes * plan.ctas >= s * line * (1 if same else 2)
        assert plan.ctas == min(PAIR_SPLIT, SMS // (b * slices))
    assert plan.threads <= PAIR_THREADS and plan.threads % plan.cols == 0
    assert plan.threads >= 480  # 15 warps of 16-byte loads
    assert plan.ctas * plan.rows >= s > (plan.ctas - 1) * plan.rows
    if plan.ctas > 1:
        assert plan.combine_chunks() >= 8  # a combining thread adds at most 2 partials


@pytest.mark.parametrize("vector", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_every_plan_fits_the_kernel(dtype, vector):
    """What the C entry refuses (csrc/norm_stats.cu me_pair_stats) never
    comes out of the plan: at most 512 threads, at most 2 x 512 runs of 8
    lanes a sum, a grid within the card's limits, whole column groups."""
    for b in (1, 2, 8, 24, 200, 4000):
        for s in (1, 7, 64, 512, 4096, 100000):
            for c in (8, 32, 96, 100, 320, 1280, 2560, 8192):
                vec = 16 // dtype.itemsize if vector else 1
                if c % vec:
                    continue
                for same in (True, False):
                    plan = pair_stats_plan(b, s, c, dtype, SMS, vector, same)
                    lanes = plan.threads // plan.cols
                    assert plan.threads <= PAIR_THREADS and plan.threads % plan.cols == 0
                    assert plan.cols * plan.vec * -(-lanes // 8) <= 2 * PAIR_THREADS
                    assert plan.ctas == -(-s // plan.rows) <= PAIR_SPLIT
                    assert plan.slices(c) <= 65535
                    assert plan.ctas * b * plan.slices(c) <= max(SMS, b * plan.slices(c))


@pytest.mark.parametrize("shape,same,want", [
    ((1, 32768, 320), True, (8, 8, 16, 2048, 512)),    # 5 slices x 16 blocks
    ((8, 4096, 320), True, (8, 8, 3, 1366, 512)),      # 40 x 3
    ((1, 512, 2560), True, (8, 8, 1, 512, 512)),       # 40 x 1: no combine
    ((8, 64, 1280), True, (8, 16, 1, 64, 512)),        # 8 x 10 slices of 256 bytes
    ((1, 2048, 1280), False, (8, 8, 6, 342, 512)),     # (dy, x): 256 KB a slice, split
    ((8, 1024, 640), False, (8, 8, 1, 1024, 512)),     # (dy, x): 128 KB a slice
], ids=str)
def test_plan_pinned(shape, same, want):
    """The plans of the measured shapes (chip_variants.py --k10-plans)."""
    assert tuple(pair_stats_plan(*shape, torch.bfloat16, SMS, True, same)) == want


def walk(plan, b, s, c, same=True):
    """(batch row, row, column group) in the order the kernel's threads read
    them, block by block: thread (lane, col) of block (cta, slice, bi) reads
    rows r0 + lane, r0 + lane + lanes, ... below r1, U at a time."""
    lanes = plan.threads // plan.cols
    cv = c // plan.vec
    for bi in range(b):
        for sl in range(plan.slices(c)):
            for cta in range(plan.ctas):
                r0, r1 = cta * plan.rows, min(s, (cta + 1) * plan.rows)
                for tid in range(plan.threads):
                    col, lane = tid % plan.cols, tid // plan.cols
                    g = sl * plan.cols + col
                    if g >= cv:
                        continue
                    for r in range(r0 + lane, r1, U[same] * lanes):
                        for u in range(U[same]):
                            if r + u * lanes < r1:
                                yield bi, r + u * lanes, g


MANY_BLOCKS = PairStatsPlan(4, 8, 59, 17, 512)  # fp32 [1, 1000, 32]: 59 partials to combine


@pytest.mark.parametrize("shape,dtype,sms,vector", [
    ((1, 1000, 32), torch.float32, MANY_BLOCKS, True),
    ((3, 333, 100), torch.bfloat16, SMS, False),  # the general body, ragged C
    ((2, 7, 32), torch.bfloat16, SMS, True),      # fewer rows than SMs
    ((8, 64, 1280), torch.bfloat16, 16, True),    # C cut into slices
    ((1, 512, 2560), torch.float32, 8, True),
    ((2, 64, 24), torch.float32, 4, True),        # one block along S
    ((1, 65536, 320), torch.bfloat16, SMS, True),  # 16 blocks along S
    ((1, 400000, 8), torch.bfloat16, SMS, True),  # a narrow C over a long S
], ids=str)
@pytest.mark.parametrize("same", [True, False])
def test_walk_reads_every_row_once(shape, dtype, sms, vector, same):
    b, s, c = shape
    plan = sms if isinstance(sms, PairStatsPlan) else pair_stats_plan(
        b, s, c, dtype, sms, vector, same)
    seen = np.zeros((b, s, c // plan.vec), np.int64)
    for bi, r, g in walk(plan, b, s, c, same):
        seen[bi, r, g] += 1
    assert (seen == 1).all()


def lane_runs(values):
    """The block's lane sums (csrc/norm_stats.cu): runs of 8 lanes each
    added in lane order (a compensated fp32 pair there, fp64 here), then
    the runs in order."""
    values = list(values)
    total = torch.zeros_like(values[0])
    for r in range(0, len(values), 8):
        run = torch.zeros_like(values[0])
        for v in values[r:r + 8]:
            run = run + v
        total = total + run
    return total


def combine(parts, chunks):
    """A combining block's sum of ``parts`` (csrc/norm_stats.cu
    sum_partials): ``chunks`` runs of consecutive parts, each added in
    order from 0, then (with more than one) the run sums in order from 0."""
    m = -(-len(parts) // chunks)
    sums = []
    for j in range(chunks):
        t1, t2 = torch.zeros_like(parts[0][0]), torch.zeros_like(parts[0][1])
        for p1, p2 in parts[j * m:(j + 1) * m]:
            t1, t2 = t1 + p1, t2 + p2
        sums.append((t1, t2))
    if chunks == 1:
        return sums[0]
    t1, t2 = torch.zeros_like(sums[0][0]), torch.zeros_like(sums[0][1])
    for p1, p2 in sums:
        t1, t2 = t1 + p1, t2 + p2
    return t1, t2


def emulate(a, b, plan, same):
    """K10's sums in the kernel's order, rounded to fp32 at the end: each
    thread's rows in fp32 batches of U, the batches in order in fp64 (the
    kernel's compensated fp32 pair keeps about 48 bits), the
    block's lanes through ``lane_runs``, then the blocks' partials through
    ``combine``, all in fp64 (the
    kernel fuses each product into its add; here it is rounded first)."""
    bt, s, c = a.shape
    af, prod = a.float(), a.float() * b.float()
    lanes = plan.threads // plan.cols
    s1 = torch.zeros(bt, c, dtype=torch.float64)
    s2 = torch.zeros(bt, c, dtype=torch.float64)
    for bi in range(bt):  # every channel at once: each one's order is its thread's
        partials = []
        for cta in range(plan.ctas):
            r0, r1 = cta * plan.rows, min(s, (cta + 1) * plan.rows)
            lane_sums = []
            for lane in range(lanes):
                t1, t2 = torch.zeros_like(s1[0]), torch.zeros_like(s1[0])
                for r in range(r0 + lane, r1, U[same] * lanes):
                    b1, b2 = torch.zeros(c), torch.zeros(c)  # a batch, fp32
                    for rr in range(r, min(r1, r + U[same] * lanes), lanes):
                        b1, b2 = b1 + af[bi, rr], b2 + prod[bi, rr]
                    t1, t2 = t1 + b1.double(), t2 + b2.double()
                lane_sums.append((t1, t2))
            partials.append((lane_runs(t for t, _ in lane_sums),
                             lane_runs(t for _, t in lane_sums)))
        s1[bi], s2[bi] = combine(partials, plan.combine_chunks())
    return s1.float(), s2.float()


@pytest.mark.parametrize("shape,sms", [
    ((1, 1000, 32), MANY_BLOCKS),  # 59 blocks along S
    ((2, 512, 64), PairStatsPlan(4, 8, 4, 128, 512)),  # 4 blocks along S, 2 slices
    ((3, 200, 48), 16),           # one block along S, 4 slices
    ((1, 64, 16), 1),             # one block
], ids=str)
@pytest.mark.parametrize("same", [True, False])
def test_emulated_order_matches_jax_kernel(shape, sms, same):
    rng = np.random.default_rng(48)
    a = normal(rng, shape, 2.0) + 0.5
    b = a if same else normal(rng, shape)
    plan = sms if isinstance(sms, PairStatsPlan) else pair_stats_plan(
        *shape, torch.float32, sms, True, same)
    assert plan.ctas > 1 or shape[1] <= 200
    got = emulate(tensor(a), tensor(b), plan, same)
    rows = JG._pick_rows(shape[1], shape[2], 4)
    ref = JG._pair_stats(jnp.asarray(a), jnp.asarray(b), rows, True)
    plain = channel_pair_stats_plain(tensor(a), tensor(b))
    for g, r, p in zip(got, ref, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-5, atol=1e-5)


def off(shape, dtype, nbytes):
    """A contiguous [B, S, C] whose base lies ``nbytes`` past a 16-byte boundary."""
    skip = nbytes // dtype.itemsize
    base = torch.zeros(math.prod(shape) + 16, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    return base[skip:skip + math.prod(shape)].view(shape)


@pytest.mark.parametrize("dtype,nbytes", [
    (torch.bfloat16, 0), (torch.bfloat16, 2), (torch.bfloat16, 4), (torch.bfloat16, 8),
    (torch.float32, 0), (torch.float32, 4), (torch.float32, 8),
], ids=str)
@pytest.mark.parametrize("operand", ["a", "b"])
def test_vector_body_needs_16_byte_boundaries(dtype, nbytes, operand):
    shape = (2, 5, 320)
    x = torch.zeros(shape, dtype=dtype)
    moved = off(shape, dtype, nbytes)
    a, b = (moved, x) if operand == "a" else (x, moved)
    assert vector_body(a, b) is (nbytes == 0)


@pytest.mark.parametrize("dtype,c,want", [
    (torch.bfloat16, 320, True), (torch.bfloat16, 8, True), (torch.bfloat16, 2560, True),
    (torch.bfloat16, 100, False), (torch.bfloat16, 36, False), (torch.bfloat16, 4, False),
    (torch.float32, 320, True), (torch.float32, 4, True), (torch.float32, 100, True),
    (torch.float32, 6, False), (torch.float32, 33, False),
], ids=str)
def test_vector_body_needs_rows_of_16_bytes(dtype, c, want):
    x = torch.zeros((2, 5, c), dtype=dtype)
    assert vector_body(x, x) is want


class RecordingLibrary:
    """Stands in for the kernel library: records ``me_pair_stats``'s
    arguments and returns ``code`` (0: launched)."""

    def __init__(self, code: int = 0):
        self.args = []
        self.code = code

    def me_pair_stats(self, *args):
        self.args.append(args)
        return self.code


@pytest.fixture
def lib(monkeypatch):
    fake = RecordingLibrary()
    monkeypatch.setattr(_build, "kernels", lambda: fake)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_build, "check_operands", lambda *a, **k: None)
    monkeypatch.setattr(gn_stats, "_sm_count", lambda index: SMS)
    _build.reset_launch_counts()
    yield fake
    _build.reset_launch_counts()


@pytest.mark.parametrize("dtype,c,nbytes,vector", [
    (torch.bfloat16, 320, 0, True), (torch.float32, 2560, 0, True),
    (torch.bfloat16, 320, 8, False), (torch.bfloat16, 100, 0, False),
    (torch.float32, 320, 4, False),
], ids=str)
@pytest.mark.parametrize("same", [True, False])
def test_launch_takes_the_routed_body(lib, monkeypatch, dtype, c, nbytes, vector, same):
    shape = (2, 300, c)
    a = off(shape, dtype, nbytes)
    b = a if same else torch.zeros(shape, dtype=dtype)
    allocated = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *s, **k: allocated.append(s) or real_empty(*s, **k))
    s1, s2 = gn_stats._pair_stats_kernel(a, b)
    plan = pair_stats_plan(*shape, dtype, SMS, vector, same)
    assert len(lib.args) == 1 and len(allocated) == 1
    args = lib.args[0]
    assert args[0] == a.data_ptr() and (args[1] == a.data_ptr()) is same
    assert args[5:9] == (*shape, _build.DTYPE_CODES[dtype]) and args[9:14] == tuple(plan)
    assert args[3] == args[2] + 8 * 2 * c  # the workspace follows the [2, B, C] sums
    assert s1.shape == s2.shape == (2, c) and s2.data_ptr() == s1.data_ptr() + 4 * 2 * c
    assert allocated[0][0] == 2 * 2 * c + plan.workspace_floats(2, c)
    assert dict(_build.launch_counts) == {
        "channel_pair_stats": 1, **({"channel_pair_stats.vec": 1} if vector else {})}


def test_a_failed_launch_raises_and_is_not_retried(lib):
    lib.code = 1  # cudaErrorInvalidValue
    x = torch.zeros((2, 300, 320), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        gn_stats._pair_stats_kernel(x, x)
    assert len(lib.args) == 1 and not _build.launch_counts


def test_the_cpu_takes_the_plain_version(lib):
    x = torch.randn((2, 30, 64))
    got = gn_stats.channel_pair_stats(x, x)
    for g, r in zip(got, channel_pair_stats_plain(x, x)):
        torch.testing.assert_close(g, r)
    assert lib.args == [] and not _build.launch_counts
