"""The frame-sharded and tensor-parallel paths of the PyTorch/CUDA port on
several GPUs, one NCCL rank per card.

    python3 chip_sharded.py --ranks 4 [--only-tp]

Rank r runs on cuda:r; the ranks meet at tcp://localhost:<a free port>.
The kernels are built once, before the ranks start. Each rank runs
chip_smoke.py's frame-sharded phases over R ranks instead of one:
  11b. check  tiny fp32 models: the injected denoise segment, inversion,
              null-text (its early stop reached) and the pipeline's edited
              latents over a (1, R) layout, and a stage-1 and a stage-2 step
              over (2, R/2), against rank 0's unsharded runs
  11.  shard  SD-1.5 at full width, bf16, 8 frames, 64x64 latents, over
              (1, R): the segment (3 steps after a warm-up step), inversion
              and null-text (5 steps each), the pipeline from frames to
              frames, then a stage-1 and a stage-2 step after a warm-up step,
              asserting every rank's launch counts per step; rank 0 then
              times each of them unsharded on its card
  11t. tp     tensor parallelism (parallel/tp.py) over (1, 1, R) and
              (1, 2, R/2) (data, frames, model) layouts: tiny fp32 checks of
              the injected segment and inversion with the UNet, adapter and
              ControlNet split over the model group, against rank 0's
              unsharded runs; then SD-1.5 at full width, bf16, 8 frames,
              64x64 latents over (1, R), (1, 1, R) and (1, 2, R/2) in turn:
              the segment (3 steps after a warm-up step) and inversion (5
              steps), asserting every rank's launches and model-group
              all-reduces per step, with ms per step, peak memory and the
              bytes all-reduced over the model group per step; rank 0 then
              runs both unsharded on its card; then, over (1, 1, R) and
              (1, 2, R/2), chip_smoke.py's phase 11u paths: tiny fp32
              checks of null-text, the pipeline, the auto-mask and p2p
              segments and both training stages (AdamW and 8-bit AdamW)
              against rank 0's unsharded runs, and each at full width for
              TP_PATH_STEPS steps, launches and all-reduces asserted,
              held to rank 0's unsharded run. --only-tp runs this phase
              alone
Prints one JSON line of every rank's results, then
{"ok": true, "device": {...}} last. Needs R CUDA devices, R even. A rank
still running after --stall-seconds prints every thread's stack and exits;
a rank that fails prints its error and exits at once, and the spawn stops
the others (they would wait in a collective for it).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import chip_smoke as cs


def rank_main(rank, ranks, port, out_dir, stall_s, only_tp):
    """One rank, on cuda:rank over NCCL."""
    import faulthandler

    import torch
    import torch.distributed as dist

    from motioneditor_tpu_torch.parallel.mesh import init_frame_sharding

    faulthandler.dump_traceback_later(stall_s, exit=True)
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=ranks,
                            timeout=datetime.timedelta(seconds=stall_s))
    try:
        seg_ctx = init_frame_sharding(1, ranks, device, rank=rank)
        train_ctx = init_frame_sharding(2, ranks // 2, device, rank=rank)
        tp_ctxs = [init_frame_sharding(1, 1, device, rank=rank, model=ranks),
                   init_frame_sharding(1, 2, device, rank=rank, model=ranks // 2)]
        t0 = time.perf_counter()
        paths, metrics = {}, {}
        if not only_tp:
            cs.log(f"[rank {rank}] check")
            paths = cs.phase_sharded_check(device, seg_ctx, train_ctx)
            cs.log(f"[rank {rank}] shard")
            shard_paths, metrics = cs.phase_sharded(device, seg_ctx, dist.barrier,
                                                    reference=rank == 0)
            paths.update(shard_paths)
        cs.log(f"[rank {rank}] tp check")
        for ctx in tp_ctxs:
            paths.update(cs.phase_tp_check(device, ctx))
            dist.barrier()
            paths.update(cs.phase_tp_check_paths(device, ctx))
            dist.barrier()
        cs.log(f"[rank {rank}] tp shard")
        tp_paths, metrics["tp"] = cs.phase_tp_sharded(
            device, [(str(cs.layout_of(ctx)), ctx) for ctx in [seg_ctx] + tp_ctxs],
            dist.barrier, reference=rank == 0)
        paths.update(tp_paths)
        for ctx in tp_ctxs:
            got_paths, metrics[f"tp_paths_{cs.layout_of(ctx)}"] = cs.tp_paths_full_width(
                device, ctx, dist.barrier)
            paths.update(got_paths)
            dist.barrier()
        cs.log(f"[rank {rank}] done in {time.perf_counter() - t0:.1f} s")
        gathered = [None] * ranks
        dist.all_gather_object(gathered, {"metrics": metrics, "launches": paths})
        if rank == 0:
            with open(os.path.join(out_dir, "result.json"), "w") as fh:
                json.dump({"ranks": gathered, "seconds": time.perf_counter() - t0}, fh)
    except BaseException:
        # the other ranks wait in a collective for this one, and NCCL's
        # destroy_process_group would wait for them: print the error and
        # leave at once, so that the spawn stops the other ranks
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--stall-seconds", type=int, default=600,
                        help="a rank still running after this many seconds dumps its "
                             "stacks and exits (also the process group's timeout)")
    parser.add_argument("--only-tp", action="store_true",
                        help="run only the tensor-parallel phase (11t)")
    args = parser.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < args.ranks:
        print(f"chip_sharded: needs {args.ranks} CUDA devices", file=sys.stderr)
        return 1
    if args.ranks % 2:
        print("chip_sharded: --ranks must be even (the (2, R/2) stage-1 layout)",
              file=sys.stderr)
        return 1
    from motioneditor_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cs.log(f"[device] {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)} | "
           f"{smi.splitlines()}")
    t0 = time.perf_counter()
    path, _ = _build.build()
    cs.log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(rank_main, args=(args.ranks, cs.free_port(), out_dir, args.stall_seconds,
                                  args.only_tp), nprocs=args.ranks, join=True)
        with open(os.path.join(out_dir, "result.json")) as fh:
            result = json.load(fh)
    print(json.dumps(result))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
