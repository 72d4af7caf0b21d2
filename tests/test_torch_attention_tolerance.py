"""The scaled error limits that hold the bf16 outputs of the tensor-core
bodies (chip_smoke.py's ``scaled_error`` and ``TC_ERR_LIMITS``, also used by
tests/test_torch_kernels_cuda.py) tell a right output from a wrong one at
the main path's sizes.

Forward (K1, K8, K12): an output's RMS (about sqrt(e / keys) on inputs
whose logits are ~N(0, 1)) is smaller than the bf16 atol of 3e-2. Here on
the CPU, with the plain versions, at 8192 keys (motion_frame at N = 4096)
and 32768 (dense, 8 frames): the bf16 plain output against the fp32 one, a
sound rounding difference, passes; outputs that miss one 64-key tile of
each K/V pass, or one frame of dense mode's keys, fail the scaled limits
though they pass atol 3e-2 / rtol 1.6e-2.

Backward (K6's dK/dV partials): 4096 queries of one target frame against
its 8192 source keys (motion_frame at N = 4096). Partials with P and dS
rounded to bf16, as the tensor-core body rounds them, pass against the
fp32 plain partials; partials that miss one 64-query tile, or whose dS
lacks the - delta term, fail. The bf16 gradient check of the kernel tests
(max error < 0.06 of max |ref|) and atol 3e-2 both pass the dS without
- delta (its dK is off by 4% of max |ref| at most, 2% in RMS); a missing
query tile moves single values by 0.028-0.10, around that atol (the first
tile's dV passes it): only the scaled limits catch every fault.

Backward (K5's dQ, and K4's lse that it reads): one target frame at the two
gated sites, 4096 queries against 8192 keys (d = 40) and 1024 against 2048
(d = 80). A dQ with P and dS rounded to bf16 passes against the fp32 plain
dQ; a dQ that misses one 64-key tile, or whose dS lacks the - delta term,
fails. An lse short of one key tile's sum fails the lse check (atol 1e-4,
chip_smoke.py phase 3b and the kernel tests) at both sites; the dQ made
from it fails the scaled limits at 2048 keys, but at 8192 keys it is off by
one tile in 128 (~0.8% in RMS) and reads under them: there the lse check
is what catches it.

Injection (K2, K13 on the injection instantiation): one target frame at
the two gated sites, 4096 queries against 8192 source + 4096 target keys
(d = 40) and 1024 against 2048 + 1024 (d = 80). The kernel's arithmetic
written out tile by tile in fp32 (each source key scored once, its two
logits' exponentials summed, P rounded to bf16, binary tiles on the
{s', 0} fast path) passes against the fp32 plain version for binary,
fractional and mixed masks; dropping the zero logits of m = 0 keys, the
target pass or one source tile fails. The output depends on the mask only
through the pair {m, 1 - m}, so every binary mask gives the same output
(pinned on the JAX reference and on the plain version): a mask read from
the wrong frame passes with a binary mask and fails with a fractional one,
so the fractional-mask checks are what guard the mask addressing.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import fg_mask, scaled_error
from motioneditor_tpu.ops.video_flash import (
    video_injection_attention as jax_video_injection_attention,
)
from motioneditor_tpu_torch.ops.video_flash import (
    video_flash_attention_kv_plain,
    video_injection_attention_kv_plain,
    video_injection_attention_plain,
)
from motioneditor_tpu_torch.ops.video_flash_bwd import (
    _delta,
    video_flash_bwd_dkv_plain,
    video_flash_bwd_plain,
    video_flash_fwd_res_plain,
)
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


@pytest.fixture(scope="module")
def backward_case():
    """One target frame (frame 1 of a motion_frame pair at N = 4096, so its
    8192 keys are two distinct frames) and the fp32 plain partials of its
    two slots, [4096 keys x 2, d]."""
    gen = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn((1, 2, 4096, D), generator=gen).bfloat16().float()
                   for _ in range(4))
    scale = D ** -0.5
    out, lse = video_flash_fwd_res_plain(q, k, v, "motion_frame", scale, 1)
    delta = _delta(out, do, 1)
    dkp, dvp = video_flash_bwd_dkv_plain(q, k, v, lse, delta, do, "motion_frame", scale, 1)
    frame = dict(q=q[0, 1], k=k[0].reshape(-1, D), v=v[0].reshape(-1, D), do=do[0, 1],
                 lse=lse[0, 1], delta=delta[0, 1], scale=scale)
    return frame, (dkp[0, 1].reshape(-1, D), dvp[0, 1].reshape(-1, D))


def _partials(frame, rounded=False, skip_rows=None, with_delta=True):
    """dK and dV of one target frame's keys, the formulas of the dk/dv
    kernel written out; ``rounded`` rounds P and dS to bf16 before their
    products, ``skip_rows`` drops those query rows' contribution."""
    p = torch.exp(frame["q"] @ frame["k"].T * frame["scale"] - frame["lse"])
    if skip_rows is not None:
        p[skip_rows] = 0.0
    ds = p * (frame["do"] @ frame["v"].T - (frame["delta"] if with_delta else 0.0))
    if rounded:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    return frame["scale"] * ds.T @ frame["q"], p.T @ frame["do"]


def test_dkv_partials_helper_is_the_plain_version(backward_case):
    frame, ref = backward_case
    for got, want in zip(_partials(frame), ref):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_dkv_bf16_rounding_passes(backward_case):
    frame, ref = backward_case
    for got, want in zip(_partials(frame, rounded=True), ref):
        scaled_error(got, want)


@pytest.mark.parametrize("case", ["first_query_tile", "last_query_tile", "no_delta"])
def test_dkv_faults_fail_the_scaled_limits(backward_case, case):
    frame, ref = backward_case
    atol = TOL[torch.bfloat16]["atol"]
    if case == "no_delta":
        got = _partials(frame, with_delta=False)
        faulty = got[:1]  # dV does not read delta
        # the kernel tests' bf16 gradient check and the atol both miss it
        assert (got[0] - ref[0]).abs().max() / ref[0].abs().max() < 0.06
        assert (got[0] - ref[0]).abs().max() < atol
    else:
        lo = 0 if case == "first_query_tile" else 4096 - TILE
        got = _partials(frame, skip_rows=slice(lo, lo + TILE))
        faulty = got
        if case == "first_query_tile":  # the atol misses it in dV
            assert (got[1] - ref[1]).abs().max() < atol
    for out, want in zip(faulty, ref):
        with pytest.raises(AssertionError, match="error .* of the reference.s"):
            scaled_error(out, want)


@pytest.fixture(scope="module", params=[(4096, 40), (1024, 80)], ids=["n4096_d40", "n1024_d80"])
def dq_case(request):
    """One target frame (frame 1 of a motion_frame pair, so its 2n keys are
    two distinct frames) at a gated site's (n, d), and its fp32 plain dQ."""
    n, d = request.param
    gen = torch.Generator().manual_seed(2)
    q, k, v, do = (torch.randn((1, 2, n, d), generator=gen).bfloat16().float()
                   for _ in range(4))
    scale = d ** -0.5
    out, lse = video_flash_fwd_res_plain(q, k, v, "motion_frame", scale, 1)
    dq = video_flash_bwd_plain(q, k, v, out, lse, do, "motion_frame", scale, 1)[0]
    keys = k[0].reshape(-1, d)
    frame = dict(q=q[0, 1], k=keys, v=v[0].reshape(-1, d), do=do[0, 1], lse=lse[0, 1],
                 delta=_delta(out, do, 1)[0, 1], scale=scale,
                 scores=q[0, 1] @ keys.T * scale)
    return frame, dq[0, 1]


def _dq(frame, rounded=False, skip_keys=None, with_delta=True, lse=None):
    """dQ of one target frame, the formulas of the dq kernel written out;
    ``rounded`` rounds P and dS to bf16, ``skip_keys`` drops those keys'
    contribution, ``lse`` replaces the forward's."""
    p = torch.exp(frame["scores"] - (frame["lse"] if lse is None else lse))
    if skip_keys is not None:
        p[:, skip_keys] = 0.0
    if rounded:
        p = p.bfloat16().float()
    ds = p * (frame["do"] @ frame["v"].T - (frame["delta"] if with_delta else 0.0))
    if rounded:
        ds = ds.bfloat16().float()
    return frame["scale"] * ds @ frame["k"]


def test_dq_helper_is_the_plain_version(dq_case):
    frame, ref = dq_case
    torch.testing.assert_close(_dq(frame), ref, atol=1e-5, rtol=1e-4)


def test_dq_bf16_rounding_passes(dq_case):
    frame, ref = dq_case
    scaled_error(_dq(frame, rounded=True), ref)


@pytest.mark.parametrize("case", ["first_key_tile", "last_key_tile", "no_delta"])
def test_dq_faults_fail_the_scaled_limits(dq_case, case):
    frame, ref = dq_case
    keys = frame["k"].shape[0]
    if case == "no_delta":
        got = _dq(frame, with_delta=False)
    else:
        lo = 0 if case == "first_key_tile" else keys - TILE
        got = _dq(frame, skip_keys=slice(lo, lo + TILE))
    with pytest.raises(AssertionError, match="error .* of the reference.s"):
        scaled_error(got, ref)


def test_lse_short_of_one_key_tile(dq_case):
    """An lse that misses the last 64-key tile's sum fails the lse check at
    both sites; the dQ made from it fails the scaled limits at 2048 keys
    and reads under them at 8192."""
    frame, ref = dq_case
    keys = frame["k"].shape[0]
    short = torch.logsumexp(frame["scores"][:, :keys - TILE], dim=-1, keepdim=True)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(short, frame["lse"], atol=1e-4, rtol=1e-5)
    got = _dq(frame, lse=short)
    if keys <= 2048:
        with pytest.raises(AssertionError, match="error .* of the reference.s"):
            scaled_error(got, ref)
    else:
        scaled_error(got, ref)  # one tile in 128: the lse check is what catches it


# ---------------------------------------------------------------------------
# K2 / K13: the injection variant's arithmetic
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[(4096, 40), (1024, 80)], ids=["n4096_d40", "n1024_d80"])
def injection_case(request):
    """One target frame: q [n, d] against the source keys of frames f-1 and
    f ([2n, d], one mask row each) and its n target keys, bf16 values in
    fp32."""
    n, d = request.param
    gen = torch.Generator().manual_seed(3)
    q, kt, vt = (torch.randn((n, d), generator=gen).bfloat16().float() for _ in range(3))
    ks, vs = (torch.randn((2 * n, d), generator=gen).bfloat16().float() for _ in range(2))
    return dict(q=q, ks=ks, vs=vs, kt=kt, vt=vt, n=n, scale=d ** -0.5, gen=gen)


def _plain(case, m):
    """The fp32 plain version of the case (K13's, one frame; K2's for a
    frame f >= 1 is the same softmax)."""
    q, ks, vs, kt, vt = (case[k][None, None] for k in ("q", "ks", "vs", "kt", "vt"))
    return video_injection_attention_kv_plain(q, ks, vs, kt, vt, m[None], case["scale"], 1)[0, 0]


def _emulate(case, m, round_p=True, drop_zero_logits=False, skip_target=False, skip_tile=None):
    """The injection kernel's arithmetic, 64 keys at a time in fp32: an
    online softmax in log2 units; a source key's two logits m s' and
    (1 - m) s', the pair {s', 0} on a tile whose mask values are all 0 or 1;
    P rounded to bf16 for P.V (``round_p``). The faults: ``drop_zero_logits`` takes the
    fg logit of every m = 0 key as -inf; ``skip_target`` leaves the target
    pass out; ``skip_tile`` leaves that source tile out."""
    q, sl2 = case["q"], case["scale"] * math.log2(math.e)
    rows = q.shape[0]
    m_run = torch.full((rows, 1), -math.inf)
    l_run = torch.zeros((rows, 1))
    o = torch.zeros_like(q)
    tiles = [("src", i) for i in range(0, case["ks"].shape[0], TILE)]
    if not skip_target:
        tiles += [("tgt", i) for i in range(0, case["kt"].shape[0], TILE)]
    for kind, k0 in tiles:
        if kind == "src" and k0 == skip_tile:
            continue
        k, v = ((case["ks"], case["vs"]) if kind == "src" else (case["kt"], case["vt"]))
        k, v = k[k0:k0 + TILE], v[k0:k0 + TILE]
        s = q @ k.T
        if kind == "tgt":
            logits = [s * sl2]
        elif bool(((m[k0:k0 + TILE] == 0) | (m[k0:k0 + TILE] == 1)).all()):
            logits = [s * sl2, torch.zeros_like(s)]  # the fast path's {s', 0}
            if drop_zero_logits:  # the zero logit is m = 0's fg, m = 1's bg
                logits = [s * sl2]
        else:
            mt = m[k0:k0 + TILE]
            fg = s * mt * sl2
            if drop_zero_logits:
                fg = torch.where(mt == 0, -math.inf, fg)
            logits = [fg, (s - s * mt) * sl2]
        m_new = torch.maximum(m_run, torch.stack([x.amax(-1, keepdim=True) for x in logits])
                              .amax(0))
        p = sum(torch.exp2(x - m_new) for x in logits)
        alpha = torch.exp2(m_run - m_new)
        l_run = l_run * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + (p.bfloat16().float() if round_p else p) @ v
        m_run = m_new
    return o / l_run


@pytest.mark.parametrize("kind", ["binary", "fractional", "mixed"])
def test_injection_emulation_passes_the_scaled_limits(injection_case, kind):
    m = fg_mask(kind, (2 * injection_case["n"],), "cpu", torch.Generator().manual_seed(4))
    ref = _plain(injection_case, m)
    got = _emulate(injection_case, m)
    torch.testing.assert_close(got, ref, **TOL[torch.bfloat16])
    scaled_error(got, ref)


def test_injection_emulation_helper_is_the_plain_version(injection_case):
    """With P left in fp32 the tile-by-tile emulation is the plain version,
    on the fast path and on the general one."""
    m = fg_mask("mixed", (2 * injection_case["n"],), "cpu", torch.Generator().manual_seed(4))
    torch.testing.assert_close(_emulate(injection_case, m, round_p=False),
                               _plain(injection_case, m), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("kind,fault", [
    ("binary", "drop_zero_logits"), ("mixed", "drop_zero_logits"),
    ("binary", "skip_target"), ("fractional", "skip_target"), ("mixed", "skip_target"),
    ("binary", "skip_tile"), ("fractional", "skip_tile"), ("mixed", "skip_tile"),
])
def test_injection_faults_fail_the_scaled_limits(injection_case, kind, fault):
    n = injection_case["n"]
    m = fg_mask(kind, (2 * n,), "cpu", torch.Generator().manual_seed(4))
    ref = _plain(injection_case, m)
    got = _emulate(injection_case, m, **{fault: n - TILE if fault == "skip_tile" else True})
    with pytest.raises(AssertionError, match="error .* of the reference.s"):
        scaled_error(got, ref)


@pytest.mark.parametrize("kind", ["binary", "fractional"])
def test_injection_mask_from_the_wrong_frame(injection_case, kind):
    """Source pass 0 (frame f-1) reading frame f's mask row: the same output
    for a binary mask, a wrong one for a fractional mask."""
    n = injection_case["n"]
    m = fg_mask(kind, (2 * n,), "cpu", torch.Generator().manual_seed(4))
    wrong = torch.cat([m[n:], m[n:]])
    ref = _plain(injection_case, m)
    got = _emulate(injection_case, wrong)
    if kind == "binary":
        scaled_error(got, ref)
    else:
        with pytest.raises(AssertionError, match="error .* of the reference.s"):
            scaled_error(got, ref)


def _small_injection(seed: int):
    rng = np.random.default_rng(seed)
    shape = (1, 3, 256, 32)  # B, F, N, C with 4 heads: d = 8
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(5)]
    binary = (rng.random((3, 256)) > 0.5).astype(np.float32)
    fractional = rng.random((3, 256)).astype(np.float32)
    return arrays, binary, fractional


def test_jax_reference_sees_only_the_pair_m_and_one_minus_m():
    """JAX's kernel (interpret mode on the CPU) gives one output for a
    binary m, for 1 - m and for the all-zeros mask."""
    arrays, binary, _ = _small_injection(5)

    def run(mask):
        return np.asarray(jax_video_injection_attention(
            *(jnp.asarray(a) for a in arrays), jnp.asarray(mask), 8 ** -0.5, 4))

    out = run(binary)
    np.testing.assert_allclose(run(1.0 - binary), out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(run(np.zeros_like(binary)), out, atol=1e-5, rtol=0)


def test_plain_version_sees_only_the_pair_m_and_one_minus_m():
    """The port's plain version: a binary m and 1 - m give one output; a
    fractional mask gives another."""
    arrays, binary, fractional = _small_injection(5)
    tensors = [torch.from_numpy(a) for a in arrays]

    def run(mask):
        return video_injection_attention_plain(*tensors, torch.from_numpy(mask), 8 ** -0.5, 4)

    out = run(binary)
    torch.testing.assert_close(run(1.0 - binary), out, atol=1e-5, rtol=0)
    assert (run(fractional) - out).abs().max() > 0.05
