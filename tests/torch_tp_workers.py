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
from motioneditor_tpu_torch.models.clip_text import StubTokenizer
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


# ---------------------------------------------------------------------------
# the paths outside the segment and inversion: null-text, the pipeline, the
# p2p and auto-mask segments, both training stages and the checkpoints
# ---------------------------------------------------------------------------


def _split_copy(module, ctx):
    out = copy.deepcopy(module)
    tp.shard_params_tp(out, ctx)
    return out


def full_state(module, ctx):
    """``module``'s state dict with every split parameter gathered from the
    model group's blocks."""
    split = tp.split_parameters(module)
    return {n: (tp.gather_tensor(v, split[n], ctx) if n in split else v.clone())
            for n, v in module.state_dict().items()}


def _counting_loss(calls):
    """``editor.null_text_loss`` recording the timestep of each call."""
    from motioneditor_tpu_torch.pipelines import editor

    loss_fn = editor.null_text_loss

    def counting_loss(*args, **kwargs):
        calls.append(args[8])
        return loss_fn(*args, **kwargs)

    return counting_loss


def null_text(ctx, out_dir):
    """``null_optimization`` along the given trajectory and
    ``null_text_inversion`` from the latents, the UNet split over the model
    group: every rank writes its embeddings, the timesteps of its objective
    calls, the gathered x_T and the model-group collectives of the
    optimization."""
    from motioneditor_tpu_torch.pipelines import editor
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    inp = _inputs(out_dir)
    config, unet = _tiny_unet(inp)
    tp.shard_params_tp(unet, ctx)
    calls = []
    editor.null_text_loss = _counting_loss(calls)
    opt = inp["opt"]
    args = (unet, config, DiffusionSchedule())
    tp.reset_collective_counts()
    uncond = editor.null_optimization(
        *args, shard_video(inp["all_lat"], ctx, branch_axis=True, frame_dim=2), inp["cond"],
        inp["uncond0"], opt["num_steps"], opt["inner_steps"], opt["base_lr"],
        opt["guidance_scale"], early_stop_epsilon=opt["early_stop_epsilon"], shard_ctx=ctx)
    counts = dict(tp.collective_counts)
    opt_calls = list(calls)
    calls.clear()
    x_t, inv_uncond = editor.null_text_inversion(
        *args, shard_video(inp["lat"], ctx), inp["cond"], inp["uncond0"], opt["num_steps"],
        opt["inner_steps"], opt["base_lr"], opt["guidance_scale"], null_normal_infer=False,
        early_stop_epsilon=opt["early_stop_epsilon"], shard_ctx=ctx)
    torch.save({"uncond": uncond, "calls": opt_calls, "inversion_uncond": inv_uncond,
                "inversion_calls": list(calls), "x_t": gather_video(x_t, ctx), "counts": counts},
               os.path.join(out_dir, f"rank{ctx.rank}.pt"))


def pipeline(ctx, out_dir):
    """MotionEditorPipeline from frames to frames with its UNet and
    ControlNet split over the model group (the VAE and text encoder
    whole); every rank writes its results, and a prompt's embeddings
    through ``StubTokenizer``, whose ids differ between processes."""
    from torch_sharding_workers import _tiny_pipeline

    inp = _inputs(out_dir)
    kw = inp["run"]
    pipe = _tiny_pipeline(inp, ctx)
    tp.shard_params_tp(pipe.unet, ctx)
    tp.shard_params_tp(pipe.controlnet, ctx)
    lat = pipe.encode_video(inp["video"], generator=torch.Generator().manual_seed(kw["seed"]))
    x_t, uncond = pipe.null_text_inversion(lat, kw["prompts"][0], num_steps=kw["steps"],
                                           null_inner_steps=kw["inner_steps"])
    video = pipe(kw["prompts"], torch.cat([x_t, x_t]), inp["skeleton"],
                 source_masks=inp["masks"], uncond_embeddings=uncond,
                 num_inference_steps=kw["steps"], start_step=kw["start_step"])
    stub = _tiny_pipeline(inp, ctx, StubTokenizer())
    torch.save({"latents": lat, "x_t": x_t, "uncond": uncond, "video": video,
                "stub": stub.encode_prompt(kw["prompts"])},
               os.path.join(out_dir, f"rank{ctx.rank}.pt"))


def segments(ctx, out_dir):
    """The p2p segment (mask mode, the replace controller, LocalBlend at the
    test's threshold) and the auto-mask segment, the UNet, its adapter and
    the ControlNet split over the model group; every rank writes the
    gathered latents, the gathered map sum, the least gap of a LocalBlend
    map value to the threshold and the model-group all-reduces."""
    import chip_smoke as cs
    from motioneditor_tpu_torch.control.injection import InjectionSpec
    from motioneditor_tpu_torch.control.p2p import P2PController
    from motioneditor_tpu_torch.models.controlnet import (
        ControlNetModel,
        controlnet_config,
        precompute_cond_embedding,
    )
    from motioneditor_tpu_torch.pipelines.editor import denoise_segment
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    inp = _inputs(out_dir)
    config, unet = _tiny_unet(inp)
    cn = ControlNetModel(controlnet_config(config)).eval()
    cn.load_state_dict(inp["controlnet"])
    tp.shard_params_tp(unet, ctx)
    tp.shard_params_tp(cn, ctx)
    with torch.no_grad():
        emb = precompute_cond_embedding(cn, shard_video(inp["skel"], ctx, branch_axis=True))
    masks = {k: shard_video(m, ctx, frame_dim=0) for k, m in inp["masks"].items()}
    lat = shard_video(inp["lat"], ctx, branch_axis=True)
    controller = P2PController(**inp["controller"])
    out = {}
    maps0 = inp["maps0"]  # [sites, 4 F, 256, L], rows (branch, frame)
    by_frame = maps0.reshape(maps0.shape[0], 4, -1, *maps0.shape[2:])
    for mode, spec_kw in inp["modes"].items():
        p2p = mode == "mask"
        maps = shard_video(by_frame, ctx, branch_axis=True, frame_dim=2).flatten(1, 2) \
            if p2p else None
        blend = cs.recording_blend(inp["alpha"], inp["threshold"]) if p2p else None
        tp.reset_collective_counts()
        seg = denoise_segment(
            unet, config, cn, controlnet_config(config), DiffusionSchedule(), inp["steps"],
            InjectionSpec.from_start_layer(10, **spec_kw), 7.5, 1.0, lat, inp["seg_ts"],
            inp["cond"], inp["uncond"], emb, masks, use_flash=False, shard_ctx=ctx,
            p2p_controller=controller if p2p else None, local_blend=blend,
            seg_lo=inp["seg_lo"], maps_sum=maps)
        out[mode] = {"latents": gather_video(seg, ctx, branch_axis=True),
                     "all_reduce": tp.collective_counts["all_reduce"]}
        if p2p:
            local = maps.reshape(maps.shape[0], 4, -1, *maps.shape[2:])
            out[mode]["maps_sum"] = gather_video(local, ctx, branch_axis=True,
                                                 frame_dim=2).reshape(maps0.shape)
            out[mode]["gap"] = min(c["gap"] for c in blend.calls)
    torch.save(out, os.path.join(out_dir, f"rank{ctx.rank}.pt"))


def _draws(stage_module, draws):
    """Make ``stage_module``'s step take ``draws`` [(noise, t), ...] (at the
    global shape) in order."""
    it = iter(draws)
    stage_module.draw_noise = lambda *a: next(it)


def train(ctx, out_dir):
    """Two steps of stage ``inp["stage"]`` with each optimizer of
    ``inp["optimizers"]`` on the given noise, the model (and the ControlNet)
    split over the model group; every rank writes the loss and the
    gathered trainables after each step, its own blocks, the optimizer's
    full-layout state and the model-group collectives per step. Then, per
    optimizer, the state is saved through ``save_train_state`` (the
    file's path written) and restored into a fresh split state, which must
    hold the same blocks and moments bit for bit; in stage 2 the adapter
    likewise through ``save_adapter`` and ``load_adapter``."""
    from motioneditor_tpu_torch.models.controlnet import ControlNetModel, controlnet_config
    from motioneditor_tpu_torch.training import checkpoint, stage1, stage2
    from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state

    inp = _inputs(out_dir)
    config, unet = _tiny_unet(inp)
    module = stage1 if inp["stage"] == 1 else stage2
    cn = None
    if inp["stage"] == 2:
        cn = ControlNetModel(controlnet_config(config)).eval()
        cn.load_state_dict(inp["controlnet"])
        cn.requires_grad_(False)
        tp.shard_params_tp(cn, ctx)
    lat, enc = shard_video(inp["lat"], ctx), inp["enc"]
    skel = shard_video(inp["skel"], ctx) if cn is not None else None
    out = {}
    for name, opt_kw in inp["optimizers"].items():

        def fresh():
            model = _split_copy(unet, ctx)
            return make_train_state(model, module.TRAINABLE_MODULES, make_optimizer(**opt_kw))

        state = fresh()
        _draws(module, inp["draws"])
        steps = []
        for _ in inp["draws"]:
            tp.reset_collective_counts()
            if cn is None:
                state, metrics = stage1.train_step_stage1(
                    state, lat, enc, torch.Generator(), config, remat=True, shard_ctx=ctx)
            else:
                state, metrics = stage2.train_step_stage2(
                    state, cn, lat, skel, enc, torch.Generator(), config,
                    controlnet_config(config), remat=True, shard_ctx=ctx)
            full = full_state(state.model, ctx)
            steps.append({"loss": float(metrics["loss"]),
                          "trainable": {n: full[n] for n in state.trainable},
                          "collectives": dict(tp.collective_counts)})
        blocks = {n: p.detach().clone() for n, p in state.trainable.items()}
        path = checkpoint.save_train_state(os.path.join(out_dir, f"ckpt_{name}"), 2, state, ctx)
        dist.barrier()
        back = checkpoint.restore_train_state(path, fresh(), ctx)
        same_blocks = all(torch.equal(back.trainable[n], b) for n, b in blocks.items())
        same_moments = all(
            torch.equal(a, b) for i, st in state.optimizer.state_dict()["state"].items()
            for k, a in st.items() if torch.is_tensor(a)
            for b in [back.optimizer.state_dict()["state"][i][k]])
        out[name] = {"steps": steps, "blocks": blocks, "path": path,
                     "restored_equal": same_blocks and same_moments}
        if cn is not None:  # the adapter's own file, saved and loaded split
            adapter = state.model.controlnet_adapter
            apath = checkpoint.save_adapter(os.path.join(out_dir, f"adapter_{name}"), 2,
                                            adapter, ctx)
            dist.barrier()
            fresh_adapter = fresh().model.controlnet_adapter
            checkpoint.load_adapter(apath, fresh_adapter, ctx)
            out[name].update(adapter_path=apath, adapter_equal=all(
                torch.equal(a, b) for a, b in zip(fresh_adapter.state_dict().values(),
                                                  adapter.state_dict().values())))
    torch.save(out, os.path.join(out_dir, f"rank{ctx.rank}.pt"))


def faults(ctx, out_dir):
    """On (1, 1, 2): the cases of tests/test_torch_tp_faults.py, each
    against the whole computation in this process: the auto-mask
    injection and the cross-attention maps of a split Attention, the step
    sum of a replicated gradient, the loss share, the clip norm and the
    8-bit moments of a split weight."""
    from motioneditor_tpu_torch.control.injection import injected_spatial_attention_auto
    from motioneditor_tpu_torch.ops.attention import Attention, cross_attention
    from motioneditor_tpu_torch.training.common import (
        make_optimizer,
        mse,
        sum_step_over_shards,
    )

    inp = _inputs(out_dir)
    heads, gen = inp["heads"], torch.Generator().manual_seed(3)

    def layer(cross_dim=None):
        a = Attention(inp["c"], cross_dim=cross_dim, heads=heads)
        with torch.no_grad():
            for prm in a.parameters():
                prm.uniform_(-0.25, 0.25, generator=gen)
        return a

    res = {}
    with torch.no_grad():
        full = layer()
        split = _split_copy(full, ctx)
        run = lambda a: injected_spatial_attention_auto(  # noqa: E731
            a, inp["tok4"], heads, inp["mask"], [inp["maps"]], (1,), 0.5, use_flash=False)
        res["auto"] = _rel(run(split), run(full))
        full = layer(inp["enc"].shape[-1])
        split = _split_copy(full, ctx)
        maps = {}
        for tag, a in (("tp", split), ("one", full)):
            maps[tag] = []
            cross_attention(a, inp["small"], inp["enc"], heads, collect_maps_into=maps[tag])
        res["maps"] = _rel(maps["tp"][0], maps["one"][0])
    # a replicated gradient and a loss share: the model ranks hold the same
    # tokens, so the step's sums leave them as they are
    g = inp["grad"].clone()
    p = torch.nn.Parameter(torch.zeros_like(g))
    p.grad = g.clone()
    loss = sum_step_over_shards(torch.tensor(0.5), make_optimizer()([p]), ctx)
    res["step_sum"] = (float(loss), torch.equal(p.grad, g))
    res["mse"] = (float(mse(inp["pred"], inp["target"], ctx)),
                  float(mse(inp["pred"], inp["target"])))
    # two steps of a split to_out.0 weight (split by columns) beside a
    # replicated bias, against the whole weight here: AdamW under a clip
    # that acts, and 8-bit AdamW without a clip (so both runs' moments are
    # the same bits, and so must their codes and scales be)
    from motioneditor_tpu_torch.training.adam8bit import codes_to_full

    w, b = inp["w"], inp["b"]
    cols = w.shape[1] // ctx.tp
    mine = lambda x: x[:, ctx.model_rank * cols:][:, :cols].clone()  # noqa: E731
    runs = {}
    for case, opt_kw in (("clip", dict(max_grad_norm=inp["max_norm"])),
                         ("8bit", dict(max_grad_norm=1e30, use_8bit=True))):
        for tag, shard in (("tp", ctx), ("one", None)):
            pw = torch.nn.Parameter(mine(w) if shard else w.clone())
            pb = torch.nn.Parameter(b.clone())
            opt = make_optimizer(learning_rate=1e-2, **opt_kw)([pw, pb])
            if shard:
                opt.split = {pw: 1}
            norms = []
            for gw, gb in inp["grads"]:
                pw.grad = mine(gw) if shard else gw.clone()
                pb.grad = gb.clone()
                norms.append(float(opt.step(shard)))
            got = {"norms": norms, "w": pw.detach(), "b": pb.detach()}
            if case == "8bit":
                st = opt.inner.state[pw]
                got.update({k: st[k] for k in ("m", "v", "m_scale", "v_scale")})
                if shard:
                    got["m"], got["v"] = (codes_to_full(tp.gather_tensor(st[k], 1, ctx))
                                          for k in ("m", "v"))
            if shard:
                got["w"] = tp.gather_tensor(got["w"], 1, ctx)
            runs[f"{case}_{tag}"] = got
    res["optimizer"] = runs
    if ctx.rank == 0:
        torch.save(res, os.path.join(out_dir, "results.pt"))
