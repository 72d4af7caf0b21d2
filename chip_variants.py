"""Times the bf16 injection kernels (K2, K13) against K1 on one GPU, for
this checkout and for copies of it whose injection instantiation takes
one consumer warpgroup fewer than K1's at padded d <= 48 or at d <= 80;
with --temporal, times the TMA-staged temporal bodies (K3, K7, and K14 on
K3's body) at other tiles than the one ops/temporal_flash.py
``temporal_tile`` picks.

    python3 chip_variants.py
    python3 chip_variants.py --temporal
    python3 chip_variants.py --k14-device <checkout>

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--temporal"]:
        temporal_sweep()
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--k14-device":
        k14_device(sys.argv[2])
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
