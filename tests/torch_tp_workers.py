"""The ranks of tests/test_torch_tp*.py: functions that
``torch_sharding_workers.spawn`` runs on a (data, frames, model) layout,
one process per rank over gloo on the CPU. Like torch_sharding_workers.py
this module imports only torch and the port, so a rank starts without JAX.
Each worker reads ``<out_dir>/inputs.pt`` and writes what it checked or
computed to ``<out_dir>/``.
"""

import copy
import os

import torch
import torch.distributed as dist

from torch_sharding_workers import _inputs, _tiny_unet
from motioneditor_tpu_torch.parallel import tp
from motioneditor_tpu_torch.parallel.mesh import gather_video, shard_video


class CollectiveLog:
    """Counts the all-reduces and all-gathers issued over ``group`` while
    active (``torch.distributed`` wrapped in place)."""

    def __init__(self, group):
        self.group, self.counts = group, {"all_reduce": 0, "all_gather": 0}

    def __enter__(self):
        self.saved = {op: getattr(dist, op) for op in self.counts}
        for op, fn in self.saved.items():
            def wrapped(*args, _op=op, _fn=fn, **kwargs):
                if kwargs.get("group") is self.group:
                    self.counts[_op] += 1
                return _fn(*args, **kwargs)
            setattr(dist, op, wrapped)
        return self

    def __exit__(self, *exc):
        for op, fn in self.saved.items():
            setattr(dist, op, fn)


def _gather_dim(x, ctx, dim):
    parts = [torch.empty_like(x) for _ in range(ctx.tp)]
    dist.all_gather(parts, x.contiguous(), group=ctx.model_group)
    return torch.cat(parts, dim=dim)


def _rel(got, ref):
    return (got - ref).abs().max().item() / max(1e-6, ref.abs().max().item())


def layers(ctx, out_dir):
    """One attention layer of each kind split over the model group, with a
    nonzero to_out.0 bias: forward, and gradient with respect to the inputs
    and every weight (split ones gathered from the model ranks), against
    the whole layer in this process. Records the largest error of each
    relative to the reference's magnitude, and whether the blocks gather
    back to the whole weights."""
    from motioneditor_tpu_torch.control.injection import injected_spatial_attention
    from motioneditor_tpu_torch.ops.attention import (
        MOTION_FRAME,
        Attention,
        cross_attention,
        spatial_self_attention,
        temporal_self_attention_video,
    )

    inp = _inputs(out_dir)
    heads = inp["heads"]
    gen = torch.Generator().manual_seed(7)

    def layer(cross_dim=None):
        a = Attention(inp["c"], cross_dim=cross_dim, heads=heads)
        with torch.no_grad():
            for prm in a.parameters():
                prm.uniform_(-0.25, 0.25, generator=gen)
        return a

    sites = {
        "spatial_motion_frame": (layer(), lambda p, t, e: spatial_self_attention(
            p, t, MOTION_FRAME, heads), inp["tok"], None),
        "cross": (layer(inp["enc"].shape[-1]), lambda p, t, e: cross_attention(p, t, e, heads),
                  inp["small"], inp["enc"]),
        "temporal": (layer(), lambda p, t, e: temporal_self_attention_video(p, t, heads),
                     inp["tok"], None),
        "injection": (layer(), lambda p, t, e: injected_spatial_attention(
            p, t, heads, inp["mask"]), inp["tok4"], None),
    }
    results = {}
    for name, (full, fn, x, enc) in sites.items():
        local = copy.deepcopy(full)
        plan = tp.shard_params_tp(local, ctx)
        runs = {}
        for tag, mod in (("tp", local), ("one", full)):
            xs = x.clone().requires_grad_()
            es = None if enc is None else enc.clone().requires_grad_()
            out = fn(mod, xs, es)
            w = torch.cos(torch.arange(out.numel(), dtype=out.dtype)).reshape(out.shape)
            (out * w).sum().backward()
            grads = {"x": xs.grad, **({} if es is None else {"enc": es.grad})}
            for pname, prm in mod.named_parameters():
                g = prm.grad
                if tag == "tp" and pname in plan:
                    g = _gather_dim(g, ctx, plan[pname])
                grads[pname] = g
            runs[tag] = (out.detach(), grads)
        err = {"forward": _rel(runs["tp"][0], runs["one"][0])}
        err.update({f"grad {k}": _rel(g, runs["one"][1][k]) for k, g in runs["tp"][1].items()})
        tp.gather_params_tp(local, ctx)
        err["gathered_equal"] = all(torch.equal(a, b) for a, b in zip(
            local.state_dict().values(), full.state_dict().values())) and local.tp_size == 1
        err["split"] = sorted(plan.items())
        results[name] = err
    if ctx.rank == 0:
        torch.save(results, os.path.join(out_dir, "results.pt"))


def unet_forward(ctx, out_dir):
    """The tiny UNet forward with its attention split over the model group
    (and its frames over the frame group), counting the model group's
    collectives; rank 0 writes the gathered output, every rank its counts
    and whether the blocks gather back to the whole weights."""
    from motioneditor_tpu_torch.models.unet import unet_apply

    inp = _inputs(out_dir)
    config, unet = _tiny_unet(inp)
    full = copy.deepcopy(unet)
    plan = tp.shard_params_tp(unet, ctx)
    called = sum(1 for name, _ in tp.split_sites(unet, ctx.tp)
                 if not name.startswith("controlnet_adapter."))
    x = shard_video(inp["x"], ctx)
    tp.reset_collective_counts()
    with CollectiveLog(ctx.model_group) as log, torch.no_grad():
        out = unet_apply(unet, config, x, inp["t"], inp["enc"], use_flash=inp["use_flash"],
                         shard_ctx=ctx)
    out = gather_video(out, ctx)
    tp.gather_params_tp(unet, ctx)
    same = all(torch.equal(a, b) for a, b in zip(unet.state_dict().values(),
                                                   full.state_dict().values()))
    torch.save({"calls": log.counts, "counted": dict(tp.collective_counts),
                "sites_called": called, "plan": len(plan), "gathered_equal": same},
               os.path.join(out_dir, f"rank{ctx.rank}.pt"))
    if ctx.rank == 0:
        torch.save(out, os.path.join(out_dir, "out.pt"))


def phases(ctx, out_dir):
    """The injected denoise segment and DDIM inversion with the UNet, its
    adapter and the ControlNet split over the model group, and on rank 0 the
    same unsharded; rank 0 writes both, every rank its model-group
    all-reduces per phase."""
    from motioneditor_tpu_torch.control.injection import InjectionSpec
    from motioneditor_tpu_torch.models.controlnet import (
        ControlNetModel,
        controlnet_config,
        precompute_cond_embedding,
    )
    from motioneditor_tpu_torch.pipelines.editor import ddim_invert, denoise_segment
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    inp = _inputs(out_dir)
    config, unet = _tiny_unet(inp)
    cn_config = controlnet_config(config)
    cn = ControlNetModel(cn_config).eval()
    cn.load_state_dict(inp["controlnet"])
    spec = InjectionSpec.from_start_layer(10)
    runs = [("tp", ctx)] + ([("one", None)] if ctx.rank == 0 else [])
    results, counts = {}, {}
    for name, shard in runs:
        u, c = unet, cn
        if shard is not None:
            u, c = copy.deepcopy(unet), copy.deepcopy(cn)
            tp.shard_params_tp(u, shard)
            tp.shard_params_tp(c, shard)

        def cut(x, **kw):
            return x if shard is None else shard_video(x, shard, **kw)

        tp.reset_collective_counts()
        with torch.no_grad():
            emb = precompute_cond_embedding(c, cut(inp["skel"], branch_axis=True))
        seg = denoise_segment(
            u, config, c, cn_config, DiffusionSchedule(), 50, spec, 7.5, 1.0,
            cut(inp["lat"], branch_axis=True), inp["seg_ts"], inp["cond"], inp["uncond"], emb,
            {k: cut(m, frame_dim=0) for k, m in inp["masks"].items()}, shard_ctx=shard)
        counts["segment"] = dict(tp.collective_counts)
        tp.reset_collective_counts()
        x_t, all_lat = ddim_invert(u, config, DiffusionSchedule(), cut(inp["inv_lat"]),
                                   inp["inv_cond"], inp["inv_steps"], normal_infer=False,
                                   shard_ctx=shard)
        counts["inversion"] = dict(tp.collective_counts)
        if shard is not None:
            seg = gather_video(seg, shard, branch_axis=True)
            all_lat = gather_video(all_lat, shard, branch_axis=True, frame_dim=2)
        results[name] = {"segment": seg, "inversion": all_lat}
        if shard is not None:
            torch.save(counts, os.path.join(out_dir, f"counts{ctx.rank}.pt"))
    if ctx.rank == 0:
        torch.save(results, os.path.join(out_dir, "out.pt"))


def layout(ctx, out_dir):
    """This rank's groups and indices."""
    torch.save(dict(frame=ctx.frame_ranks, data=ctx.data_ranks, model=ctx.model_ranks,
                    fp=ctx.fp, dp=ctx.dp, tp=ctx.tp, frame_rank=ctx.frame_rank,
                    model_rank=ctx.model_rank, shards_frames=ctx.shards_frames),
               os.path.join(out_dir, f"rank{ctx.rank}.pt"))
