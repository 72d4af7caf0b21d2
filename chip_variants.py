"""Times the bf16 injection kernels (K2, K13) against K1 on one GPU, for
this checkout and for copies of it whose injection instantiation takes
one consumer warpgroup fewer than K1's at padded d <= 48 or at d <= 80;
with --temporal, times the TMA-staged temporal bodies (K3, K7, and K14 on
K3's body) at other tiles than the one ops/temporal_flash.py
``temporal_tile`` picks.

    python3 chip_variants.py
    python3 chip_variants.py --temporal
    python3 chip_variants.py --k14-device <checkout>
    python3 chip_variants.py --k10-device <checkout>
    python3 chip_variants.py --k10-plans
    python3 chip_variants.py --stage2-shapes

--temporal: at the bf16 shapes of PERF.md's K3 and K7 rows and at K14's
shard-local shape (2 query frames of 8 at the last shard's offset), every
tile of a small grid (head group, sites, rows, split, warps; 2 stages)
that fits the card's shared memory, launched through the C entries
directly, each output held to the plain version at chip_smoke.py's bf16
tolerance and timed with CUDA events over TEMPORAL_REPS launches; then the
tile ``temporal_tile`` picks, in the same process.

--k14-device: K14 (``temporal_flash_attention_global``) of the checkout at
<checkout>, bf16, at the one-rank shape [2, 8, N, C] and at each 2-frame
shard of a 4-way split of 8 frames (offsets 0, 2, 4, 6), N, C at both
latent sizes: the device time per launch from torch.profiler over
K14_DEVICE_REPS launches. A shard's kernel takes less than the host
spends on a launch, so CUDA events over many launches read the host.
Given a copy of another commit (git archive), it times that commit's
K14 the same way.

--k10-device: K10 (``channel_pair_stats``) of the checkout at <checkout>
at every [B, S, C] of a stage-1 step's GroupNorms (chip_smoke.py
``unet_group_norm_shapes``: SD-1.5, 512 px, 8 frames) and at
chip_smoke.PAIR_STATS_SHAPES, (x, x) and (dy, x), bf16 and fp32: the
device time per call from torch.profiler over K10_DEVICE_REPS calls (from
a call's first kernel's start to its last one's end: the parent's body
launched two; and each kernel's mean; the profiler there at times drops
records, see ``k10_kernels``), back to back
(an input under the 50 MB L2 stays there) and with a 96 MB buffer read
before each call (cold: the input comes from device memory), beside the
host-inclusive time per call from CUDA events over chip_smoke.KERNEL_REPS
back-to-back calls, the byte bound and its share, and the plain version's
time; then the sums over the 61 forward GroupNorms of one UNet forward.

--k10-plans: K10 in bf16 at every [B, S, C] of a stage-1 step's
GroupNorms, (x, x) and (dy, x), at a grid of launch plans (column groups a
slice, blocks along S) through the C entry directly, each output held to
the plain version, timed on the device: a sleeping kernel holds the card
while the host enqueues K10_PLAN_REPS launches between two CUDA events,
so the time per launch is the card's (with the gap between back-to-back
launches) and not the host's. The input stays in L2 from launch to launch
(warm); the four fastest plans and the plan ``pair_stats_plan`` picks are
also timed cold: each launch after a read of a 96 MB buffer, whose own
time (timed alone the same way) is taken off.

--stage2-shapes: chip_smoke.py's tiny fp32 and fp64 training steps
(phase 11b's models and shapes, three data draws), each run twice on the
same inputs: as one call, and with the ControlNet run on (batch 1, 2
frames) chunks, the call shapes of a (2, 2) layout's ranks, no rank
involved. Prints how far the loss, the trainables' gradients (max over
the max |g|, the worst parameters, relative L2) and the parameters after
one AdamW step (eps 1e-4) move: the rounding that a comparison of a
sharded step with an unsharded one cannot tell from a fault.

Each variant runs in its own process from its own copy under
build/variants/ (git-ignored), which builds its own kernels. Per variant:
ptxas's registers and spills of the injection instantiations, then at
chip_smoke.py's KERNEL_SHAPES K1 motion_frame and K2 / K13 with each fg
mask of chip_smoke.INJECTION_MASKS, each held to the plain version as
chip_smoke.py holds it (binary masks to the bf16 plain version, the others
to the fp32 one) and timed with CUDA events. For fractional and mixed
masks it also prints the output's scaled error against the bf16 plain
version, which rounds m and K*m to bf16. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the warpgroup rule of csrc/attention_tc.cuh and the variants of it
WGS_LINE = "  static constexpr int WGS = DP <= 48 ? 4 : DP <= 80 ? 3 : 2;"
VARIANTS = {
    "inj_wgs3_at_d48": "  static constexpr int WGS = DP <= 48 ? (INJ ? 3 : 4) : DP <= 80 ? 3 : 2;",
    "inj_wgs2_at_d80": "  static constexpr int WGS = DP <= 48 ? 4 : DP <= 80 ? (INJ ? 2 : 3) : 2;",
}


def make_copy(name: str, line: str) -> Path:
    """A copy of the package and chip_smoke.py with ``line`` in place of
    the warpgroup rule."""
    dst = ROOT / "build" / "variants" / name
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    shutil.copytree(ROOT / "motioneditor_tpu_torch", dst / "motioneditor_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    cuh = dst / "motioneditor_tpu_torch" / "csrc" / "attention_tc.cuh"
    text = cuh.read_text()
    if text.count(WGS_LINE) != 1:
        raise RuntimeError(f"{cuh}: the warpgroup rule is not the expected line")
    cuh.write_text(text.replace(WGS_LINE, line))
    return dst


def time_root(root: str) -> None:
    """The measurements of one checkout (run in a child process)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.ops.video_flash import (
        video_flash_attention,
        video_injection_attention,
        video_injection_attention_kv,
        video_injection_attention_kv_plain,
        video_injection_attention_plain,
    )

    path, log = _build.build()
    usage = {k: v for k, v in cs.ptxas_usage(log).items() if "inj" in k}
    print(f"[{root}] ptxas {json.dumps(usage)}", flush=True)
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    for n, c in cs.KERNEL_SHAPES:
        q, k, v, kt, vt = (torch.randn((2, cs.FRAMES, n, c), generator=gen, device=device)
                           .bfloat16() for _ in range(5))
        scale = (c // cs.HEADS) ** -0.5
        k_mf, v_mf = cs.motion_frame_kv(k), cs.motion_frame_kv(v)
        ms = cs.time_ms(lambda: video_flash_attention(q, k, v, "motion_frame", scale, cs.HEADS),
                        reps=10)
        print(f"[{root}] K1 motion_frame N={n} C={c}: {ms:.3f} ms", flush=True)
        for kind in cs.INJECTION_MASKS:
            m = cs.fg_mask(kind, (cs.FRAMES, n), device, gen)
            m_mf = torch.cat([torch.cat([m[:1], m[:-1]]), m], dim=1).contiguous()
            cases = {
                "K2": (lambda: video_injection_attention(q, k, v, kt, vt, m, scale, cs.HEADS),
                       video_injection_attention_plain, (q, k, v, kt, vt, m)),
                "K13": (lambda: video_injection_attention_kv(q, k_mf, v_mf, kt, vt, m_mf, scale,
                                                             cs.HEADS),
                        video_injection_attention_kv_plain, (q, k_mf, v_mf, kt, vt, m_mf)),
            }
            for name, (fn, plain, args) in cases.items():
                out = fn()
                torch.cuda.synchronize()
                bf16_ref = plain(*args, scale, cs.HEADS)
                ref = bf16_ref if kind == "binary" else plain(
                    *(t.float() for t in args[:5]), args[5], scale, cs.HEADS)
                torch.testing.assert_close(out.float(), ref.float(),
                                           **cs.tolerance(torch.bfloat16))
                got = cs.scaled_error(out, ref)
                line = f"scaled max {got['max']:.3e} rms {got['rms']:.3e}"
                if kind != "binary":
                    vs = cs.scaled_of(out, bf16_ref)
                    line += f", against the bf16 plain version max {vs['max']:.3e}"
                ms = cs.time_ms(fn, reps=10)
                print(f"[{root}] {name} {kind} N={n} C={c}: {ms:.3f} ms, {line}", flush=True)
                del out, ref, bf16_ref
        del q, k, v, kt, vt, k_mf, v_mf
        torch.cuda.empty_cache()


TEMPORAL_REPS = 200
# (name, [B, Fq, Fk, N, C]) at 8 heads, bf16: K3 at the denoise step's
# sites, the UNet's 64x64 and 32x32 sites at batch 4, K7 at the null-text
# shape, K14 at the last shard of a 4-way split of the denoise step's 8 frames
TEMPORAL_SHAPES = (("K3", (2, 8, 8, 4096, 320)), ("K3", (4, 8, 8, 4096, 320)),
                   ("K3", (4, 8, 8, 1024, 640)), ("K7", (1, 8, 8, 4096, 320)),
                   ("K14", (2, 2, 8, 4096, 320)), ("K14", (2, 2, 8, 1024, 640)))


def temporal_sweep() -> None:
    import itertools

    import torch

    import chip_smoke as cs
    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.ops.temporal_flash import (
        BOX_MAX,
        SMEM_LIMIT,
        TemporalTile,
        seq_threads,
        temporal_flash_attention_bwd_plain,
        temporal_flash_attention_global_plain,
        temporal_tile,
        tile_smem_bytes,
    )

    lib = _build.kernels()
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    heads = cs.HEADS
    for name, (b, fq, f, n, c) in TEMPORAL_SHAPES:
        d = c // heads
        backward = name == "K7"
        q_off = f - fq
        xs = [torch.randn((b, fq if i in (0, 3) else f, n, c), generator=gen,
                          device=device).bfloat16() for i in range(4 if backward else 3)]
        scale = d ** -0.5
        outs = [torch.empty_like(xs[0]) for _ in range(3 if backward else 1)]
        stream = _build.stream_handle(device)
        ptrs = [t.data_ptr() for t in (*xs, *outs)]
        if backward:
            ref = temporal_flash_attention_bwd_plain(*xs, scale, heads)

            def launch(t):
                return lib.me_temporal_attention_bwd_tma(*ptrs, b, f, n, heads, d, scale, 1,
                                                         *t, 1, stream)
        else:
            ref = (temporal_flash_attention_global_plain(*xs, scale, heads, True, q_off),)

            def launch(t):
                return lib.me_temporal_attention_tma(*ptrs, b, fq, f, n, heads, d, scale, 1,
                                                     q_off, *t, 1, stream)
        moved = cs.nbytes(*xs) + cs.nbytes(*outs)
        bound_ms = moved / cs.PEAK_BYTES * 1e3

        def run(label, t):
            code = launch(t)
            _build.check_status(label, code)
            torch.cuda.synchronize()
            if backward:
                cs.grad_error(outs, ref, torch.bfloat16)
            else:
                torch.testing.assert_close(outs[0].float(), ref[0].float(),
                                           **cs.tolerance(torch.bfloat16))
            ms = cs.time_ms(lambda: launch(t), reps=TEMPORAL_REPS)
            print(f"[temporal] {name} {[b, fq, f, n, c]} {label} {tuple(t)}: {ms:.4f} ms "
                  f"({TEMPORAL_REPS} launches), {100 * bound_ms / ms:.1f}% of the "
                  f"{bound_ms:.4f} ms byte bound", flush=True)
            return ms

        timed = {}
        groups = [h for h in (8, 4, 2, 1) if heads % h == 0 and h * d <= BOX_MAX][:2]
        for hg, sites, rows, split, warps in itertools.product(
                groups, (1, 2, 4, 8, 16), (1, 2), (1, 2, 4), (2, 4, 8)):
            if seq_threads(fq, rows, split) > 32 or (backward and rows == 2):  # K7: one row
                continue
            warps = min(warps, -(-sites * hg // (32 // seq_threads(fq, rows, split))))
            smem = tile_smem_bytes(fq, f, d, sites, hg, rows, split, 2, warps, 2, backward)
            t = TemporalTile(sites, hg, rows, split, 2, warps, smem)
            if smem > SMEM_LIMIT or t in timed:
                continue
            timed[t] = run("tile", t)
        chosen = temporal_tile(fq, f, d, heads, torch.bfloat16, backward)
        ms = run("temporal_tile", chosen)
        best = sorted(timed.items(), key=lambda kv: kv[1])[:5]
        print(f"[temporal] {name} {[b, fq, f, n, c]}: fastest "
              + "; ".join(f"{v:.4f} ms at {tuple(t)}" for t, v in best)
              + f"; temporal_tile {ms:.4f} ms at {tuple(chosen)}", flush=True)
        del xs, outs, ref
        torch.cuda.empty_cache()


K14_DEVICE_REPS = 50


def k14_device(root: str) -> None:
    """K14's device time per launch in the checkout at ``root``."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from motioneditor_tpu_torch.ops.temporal_flash import temporal_flash_attention_global

    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, c in ((4096, 320), (1024, 640)):
        q, k, v = (torch.randn((2, 8, n, c), generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        scale = (c // 8) ** -0.5
        for lo, hi in ((0, 8), (0, 2), (2, 4), (4, 6), (6, 8)):
            qs = q[:, lo:hi].contiguous()
            for _ in range(10):
                temporal_flash_attention_global(qs, k, v, scale, 8, True, lo)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(K14_DEVICE_REPS):
                    temporal_flash_attention_global(qs, k, v, scale, 8, True, lo)
                torch.cuda.synchronize()
            spans = [e.time_range.end - e.time_range.start for e in prof.events()
                     if e.device_type == DeviceType.CUDA and "temporal" in e.name.lower()]
            if len(spans) != K14_DEVICE_REPS:
                raise RuntimeError(f"profiled {len(spans)} K14 kernels, expected "
                                   f"{K14_DEVICE_REPS}")
            print(f"[k14-device] {root} bf16 q [2, {hi - lo}, {n}, {c}] q_off {lo}: "
                  f"{sum(spans) / len(spans) / 1e3:.4f} ms device per launch "
                  f"({K14_DEVICE_REPS} launches)", flush=True)
        del q, k, v
        torch.cuda.empty_cache()


K10_DEVICE_REPS = 50


def k10_kernels(fn, flush=None):
    """K10's kernels over K10_DEVICE_REPS calls of ``fn`` under
    torch.profiler: ({kernel name: [launches, device ms]}, the mean span of
    a call on the device, from its first kernel's start to its last one's
    end); ``flush`` runs before each call. The profiler of the card's host
    at times returns fewer kernels than ran, or none, after many sessions
    in one process: profiles again (up to 5 times) until it sees every
    launch, else keeps the fullest session if it saw 80% of them."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(K10_DEVICE_REPS):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        events = sorted((e.time_range.start, e.time_range.end, m.group(0))
                        for e in prof.events()
                        if e.device_type == DeviceType.CUDA
                        and (m := re.search(r"pair_stats_\w+", e.name)))
        kernels: dict = {}
        for t0, t1, name in events:
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (t1 - t0) / 1e3
        seen = min((n for n, _ in kernels.values()), default=0)
        if best is None or seen > best[0]:
            best = (seen, kernels, events)
        if seen == K10_DEVICE_REPS and all(n == seen for n, _ in kernels.values()):
            break
    seen, kernels, events = best
    if seen < 0.8 * K10_DEVICE_REPS:
        raise RuntimeError(f"the profiler saw K10 kernels {kernels} in {K10_DEVICE_REPS} calls")
    first, last = events[0][2], max(kernels, key=lambda k: [e[2] for e in events].index(k))
    spans, begin = [], None
    for t0, t1, name in events:
        if name == first:
            begin = t0
        if name == last and begin is not None:
            spans.append((t1 - begin) / 1e3)
            begin = None
    return kernels, sum(spans) / len(spans)


def k10_device(root: str) -> None:
    """K10's device time per call in the checkout at ``root``."""
    import chip_smoke as cs  # this checkout's, before ``root`` goes on the path

    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from motioneditor_tpu_torch.ops.gn_stats import channel_pair_stats, channel_pair_stats_plain

    forward = cs.unet_group_norm_shapes()
    shapes = sorted(set(forward) | set(cs.PAIR_STATS_SHAPES), key=lambda t: -t[0] * t[1] * t[2])
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    # read, not written, so that L2 holds clean lines with no write-back to pay
    flush_buf = torch.zeros(24 * 2**20, device="cuda")
    device_ms: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        for shape in shapes:
            x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
            dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for pair, (a, b) in (("x,x", (x, x)), ("dy,x", (dy, x))):
                def fn():
                    return channel_pair_stats(a, b)

                for _ in range(10):
                    fn()
                warm, ms = k10_kernels(fn)
                _, cold_ms = k10_kernels(fn, flush_buf.sum)
                device_ms[(shape, dt, pair)] = ms
                host_ms = cs.time_ms(fn, reps=cs.KERNEL_REPS)
                plain_ms = cs.time_ms(lambda: channel_pair_stats_plain(a, b), reps=20)
                moved = cs.nbytes(a) + (0 if b is a else cs.nbytes(b)) + 2 * shape[0] * shape[2] * 4
                bound_ms = moved / cs.PEAK_BYTES * 1e3
                per = ", ".join(f"{name} {t / n:.4f} ms over {n} of {K10_DEVICE_REPS} calls"
                                for name, (n, t) in sorted(warm.items()))
                print(f"[k10-device] {root} {dt} {list(shape)} ({pair}): {ms:.4f} ms device "
                      f"per call ({per}), {cold_ms:.4f} ms cold; {host_ms:.4f} ms per call by "
                      f"CUDA events over {cs.KERNEL_REPS}; byte bound {bound_ms:.4f} ms: "
                      f"device {100 * bound_ms / ms:.1f}%, cold {100 * bound_ms / cold_ms:.1f}%, "
                      f"host-inclusive {100 * bound_ms / host_ms:.1f}%; plain {plain_ms:.4f} ms",
                      flush=True)
            del x, dy
            torch.cuda.empty_cache()
        for pair in ("x,x", "dy,x"):
            total = sum(device_ms[(s, dt, pair)] for s in forward)
            print(f"[k10-device] {root} {dt} ({pair}) over the {len(forward)} forward "
                  f"GroupNorms of one UNet forward: {total:.4f} ms device", flush=True)


K10_PLAN_REPS = 20


def k10_plans() -> None:
    import torch

    import chip_smoke as cs
    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.ops import gn_stats as gn

    lib = _build.kernels()
    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    stream = _build.stream_handle(device)
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    tickets = torch.zeros(1 << 16, dtype=torch.int32, device=device)
    flush_buf = torch.zeros(24 * 2**20, device=device)  # read: L2 keeps clean lines

    def on_device(fn) -> float:
        """ms per call of ``fn`` on the card, K10_PLAN_REPS calls back to back"""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)  # ~2 ms: the host enqueues the calls meanwhile
        start.record()
        for _ in range(K10_PLAN_REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / K10_PLAN_REPS

    flush_ms = min(on_device(flush_buf.sum) for _ in range(3))
    shapes = sorted(set(cs.unet_group_norm_shapes()), key=lambda t: -t[0] * t[1] * t[2])
    for shape in shapes:
        b, s, c = shape
        x = (torch.randn(shape, generator=gen, device=device) * 2 + 0.5).bfloat16()
        dy = torch.randn(shape, generator=gen, device=device).bfloat16()
        cv = c // 8
        for pair, (a, o) in (("x,x", (x, x)), ("dy,x", (dy, x))):
            ref = gn.channel_pair_stats_plain(a, o)

            def run(plan, cold=False):
                buf = torch.empty(2 * b * c + plan.workspace_floats(b, c), device=device)

                def launch():
                    if cold:
                        flush_buf.sum()
                    _build.check_status("k10-plans", lib.me_pair_stats(
                        a.data_ptr(), o.data_ptr(), buf.data_ptr(), buf.data_ptr() + 8 * b * c,
                        tickets.data_ptr(), b, s, c, 1, *plan, stream))

                launch()
                torch.cuda.synchronize()
                got = buf[: 2 * b * c].view(2, b, c)
                torch.testing.assert_close(got[0], ref[0], rtol=1e-4, atol=1e-3)
                torch.testing.assert_close(got[1], ref[1], rtol=1e-4, atol=1e-3)
                return on_device(launch) - (flush_ms if cold else 0.0)

            timed = {}
            for cols in sorted({min(cv, k) for k in (40, 32, 20, 16, 10, 8)}, reverse=True):
                slices = -(-cv // cols)
                for ctas in (1, 2, 4, 8, 16, 32, 66, 132):
                    if ctas > s or b * slices * ctas > sms:
                        continue
                    rows = -(-s // ctas)
                    plan = gn.PairStatsPlan(8, cols, -(-s // rows), rows,
                                            max(1, gn.PAIR_THREADS // cols) * cols)
                    timed.setdefault(plan, run(plan))
            chosen = gn.pair_stats_plan(b, s, c, torch.bfloat16, sms, True, a is o)
            ms = run(chosen)
            bound_ms = (cs.nbytes(a) + (0 if a is o else cs.nbytes(o)) + 8 * b * c) \
                / cs.PEAK_BYTES * 1e3
            best = sorted(timed.items(), key=lambda kv: kv[1])[:4]
            cold = {t: run(t, cold=True) for t in {chosen, *(t for t, _ in best)}}
            print(f"[k10-plans] bf16 {list(shape)} ({pair}), byte bound {bound_ms:.4f} ms: "
                  f"pair_stats_plan {ms:.4f} ms, cold {cold[chosen]:.4f}, at {tuple(chosen)} "
                  f"(slices {chosen.slices(c)}); fastest " + "; ".join(
                      f"{v:.4f} ms, cold {cold[t]:.4f}, at {tuple(t)} (slices {t.slices(c)})"
                      for t, v in best), flush=True)
        del x, dy
        torch.cuda.empty_cache()


def stage2_shapes() -> None:
    """See --stage2-shapes in the module docstring."""
    import copy

    import torch

    import chip_smoke as cs
    from motioneditor_tpu_torch.training import stage1, stage2
    from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, cn_config, unet, cn, _ = cs.build_tiny_models(dev, cs.SEED + 63)
    cn.requires_grad_(False)
    apply, embed = stage2.controlnet_apply, stage2.precompute_cond_embedding

    def chunked_embed(model, skel):
        return torch.cat([torch.cat([embed(model, skel[b:b + 1, i:i + 2])
                                     for i in range(0, skel.shape[1], 2)], 1)
                          for b in range(skel.shape[0])], 0)

    def chunked_apply(model, config, x, t, enc, emb, **kw):
        rows = [[apply(model, config, x[b:b + 1, i:i + 2], t[b:b + 1], enc[b:b + 1],
                       emb[b:b + 1, i:i + 2], **kw) for i in range(0, x.shape[1], 2)]
                for b in range(x.shape[0])]
        down = [torch.cat([torch.cat([c[0][k] for c in row], 1) for row in rows], 0)
                for k in range(len(rows[0][0][0]))]
        return down, torch.cat([torch.cat([c[1] for c in row], 1) for row in rows], 0)

    for draw in range(3):
        g = torch.Generator(device=dev).manual_seed(100 + draw)
        lat = 0.5 * torch.randn((2, cs.FRAMES, 32, 32, 4), generator=g, device=dev)
        enc = 0.5 * torch.randn((2, 7, 16), generator=g, device=dev)
        skel = torch.rand((2, cs.FRAMES, 256, 256, 3), generator=g, device=dev)
        for stage, module in (("stage2", stage2), ("stage1", stage1)):
            for dtype in (torch.float32, torch.float64):
                out = []
                for chunked in (False, True):
                    stage2.controlnet_apply = chunked_apply if chunked else apply
                    stage2.precompute_cond_embedding = chunked_embed if chunked else embed
                    state = make_train_state(copy.deepcopy(unet).to(dtype),
                                             module.TRAINABLE_MODULES,
                                             make_optimizer(learning_rate=1e-3, eps=1e-4))
                    _, metrics = cs.train_step(
                        stage, state, copy.deepcopy(cn).to(dtype), config, cn_config,
                        lat.to(dtype), enc.to(dtype), skel.to(dtype),
                        torch.Generator(device=dev).manual_seed(7), remat=True,
                        use_flash=dtype == torch.float32)
                    out.append((float(metrics["loss"]),
                                {n: p.grad.double() for n, p in state.trainable.items()},
                                {n: p.detach().double() for n, p in state.trainable.items()}))
                stage2.controlnet_apply, stage2.precompute_cond_embedding = apply, embed
                (l0, g0, p0), (l1, g1, p1) = out
                top = max(x.abs().max().item() for x in g0.values())
                gerr = {n: (g1[n] - g0[n]).abs().max().item() / top for n in g0}
                worst = sorted(gerr.items(), key=lambda kv: -kv[1])[:2]
                l2 = max(((g1[n] - g0[n]).norm() / g0[n].norm().clamp_min(1e-30)).item()
                         for n in g0)
                perr = max((p1[n] - p0[n]).abs().max().item() for n in p0)
                print(f"[stage2-shapes] draw {draw} {stage} {str(dtype)[6:]}: loss {l0:.9f} "
                      f"vs {l1:.9f}, grad max err {max(gerr.values()):.3e} of max |g| (worst "
                      f"{worst}), max relative L2 {l2:.3e}, param max err {perr:.3e}",
                      flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--k10-plans"]:
        k10_plans()
        return 0
    if sys.argv[1:] == ["--stage2-shapes"]:
        stage2_shapes()
        return 0
    if sys.argv[1:] == ["--temporal"]:
        temporal_sweep()
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--k14-device":
        k14_device(sys.argv[2])
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--k10-device":
        k10_device(sys.argv[2])
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        time_root(sys.argv[2])
        return 0
    roots = [ROOT] + [make_copy(name, line) for name, line in VARIANTS.items()]
    for root in roots:
        subprocess.run([sys.executable, __file__, "--time", str(root)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
