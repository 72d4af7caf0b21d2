"""The ranks of tests/test_torch_sharding*.py: functions that
``torch.multiprocessing.spawn`` runs, one process per rank, over gloo on the
CPU. This module imports only torch, the port and chip_smoke.py (which
imports neither JAX nor the JAX package), so a rank starts without JAX.
Each worker reads its inputs from ``<out_dir>/inputs.pt`` (written by the
test) and writes what it checked or computed to ``<out_dir>/``; an
assertion error in any rank fails the spawn.
"""

import datetime
import math
import os
import pathlib
import socket
import traceback
import zlib

import torch
import torch.distributed as dist

from motioneditor_tpu_torch.models.clip_text import StubTokenizer
from motioneditor_tpu_torch.parallel.mesh import (
    gather_video,
    init_frame_sharding,
    shard_video,
)


COLLECTIVE_TIMEOUT_S = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def spawn(fn, layout, out_dir, inputs):
    """Run ``fn(ctx, out_dir)`` on a (data, frames[, model]) ``layout`` of
    ranks, with ``inputs`` saved for them to read; raises with every failed
    rank's traceback."""
    import torch.multiprocessing as mp

    out_dir = pathlib.Path(out_dir)
    torch.save(inputs, out_dir / "inputs.pt")
    try:
        mp.spawn(_entry, args=(fn, free_port(), str(out_dir), layout), nprocs=math.prod(layout),
                 join=True)
    except Exception:
        errors = sorted(out_dir.glob("error*.txt"))
        raise AssertionError("\n".join(e.read_text() for e in errors) or "a rank failed")


def _entry(rank, fn, port, out_dir, layout):
    torch.set_num_threads(1)
    try:
        # a rank left waiting in a collective (ranks that took different
        # control flow) fails the test within the timeout instead of hanging
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=math.prod(layout),
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        ctx = init_frame_sharding(layout[0], layout[1], "cpu", rank=rank,
                                  model=layout[2] if len(layout) > 2 else 1)
        fn(ctx, out_dir)
        dist.barrier()
    except Exception:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _inputs(out_dir):
    return torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)


# ---------------------------------------------------------------------------
# the collectives and the sharded attention sites, against one process
# ---------------------------------------------------------------------------


def _grad_check(name, ctx, fn_sharded, fn_global, x_global, w_global, results, **shard_kw):
    """Forward and gradient of ``fn_sharded`` on every rank's block against
    ``fn_global`` on the whole tensor in one process (rank 0): the loss is
    sum(out * w), w a fixed random weight of the output's shape. Records
    (forward max error, gradient max error / max |gradient|)."""
    xl = shard_video(x_global, ctx, **shard_kw).requires_grad_()
    out = fn_sharded(xl)
    (out * shard_video(w_global, ctx, **shard_kw)).sum().backward()
    got = gather_video(out.detach(), ctx, **shard_kw)
    gx = gather_video(xl.grad, ctx, **shard_kw)
    if ctx.rank == 0:
        xg = x_global.detach().clone().requires_grad_()
        ref = fn_global(xg)
        (ref * w_global).sum().backward()
        fwd = (got - ref.detach()).abs().max().item()
        bwd = (gx - xg.grad).abs().max().item() / max(1e-6, xg.grad.abs().max().item())
        results[name] = (fwd, bwd)


def collectives(ctx, out_dir):
    """Each collective and each sharded attention site: forward and
    gradient against the unsharded computation of the same function."""
    from torch import nn

    from motioneditor_tpu_torch.control.injection import injected_spatial_attention
    from motioneditor_tpu_torch.models.layers import group_norm, temporal_conv
    from motioneditor_tpu_torch.ops.attention import (
        DENSE,
        MOTION_FRAME,
        SPARSE_CAUSAL,
        Attention,
        spatial_self_attention,
        temporal_self_attention_video,
    )
    from motioneditor_tpu_torch.parallel import flash_sharding as fs

    inp = _inputs(out_dir)
    x, w = inp["x"], inp["w"]  # [2, 8, 6, 16]
    video, wv = inp["video"], inp["wv"]  # [2, 8, 3, 3, 16]
    results = {}
    _grad_check("prev_frames", ctx, lambda t: fs.prev_frames(t, ctx),
                lambda t: torch.cat([t[:, :1], t[:, :-1]], dim=1), x, w, results)
    f = x.shape[1]
    _grad_check("first_frame", ctx,
                lambda t: fs.first_frame(t, ctx).expand(-1, t.shape[1], -1, -1) * 1.0,
                lambda t: t[:, :1].expand(-1, f, -1, -1) * 1.0, x, w, results)
    fl = f // ctx.fp
    _grad_check("all_frames", ctx,
                lambda t: fs.all_frames(t, ctx)[:, :fl] * 0.5 + fs.all_frames(t, ctx)[:, -fl:],
                lambda t: torch.cat([t[:, :fl] * 0.5 + t[:, -fl:]] * ctx.fp, dim=1), x, w,
                results)

    gen = torch.Generator().manual_seed(5)
    conv = nn.Conv1d(16, 16, 3)
    norm = nn.GroupNorm(4, 16)
    with torch.no_grad():
        for prm in list(conv.parameters()) + list(norm.parameters()):
            prm.copy_(0.3 * torch.randn(prm.shape, generator=gen) + (1.0 if prm is norm.weight
                                                                     else 0.0))
    _grad_check("temporal_conv", ctx, lambda t: temporal_conv(conv, t, shard=ctx),
                lambda t: temporal_conv(conv, t), video, wv, results)
    _grad_check("group_norm", ctx, lambda t: group_norm(norm, t, 4, 1e-5, shard=ctx),
                lambda t: group_norm(norm, t, 4, 1e-5), video, wv, results)
    os.environ["MOTIONEDITOR_FUSED_GN"] = "1"
    try:
        _grad_check("group_norm_fused", ctx, lambda t: group_norm(norm, t, 4, 1e-5, shard=ctx),
                    lambda t: group_norm(norm, t, 4, 1e-5), video, wv, results)
    finally:
        del os.environ["MOTIONEDITOR_FUSED_GN"]

    # the attention sites at N = 1024 (the kernels' gate: on the CPU their
    # plain versions run through the same sharded route) and N = 6 (the
    # plain fallback), against the unsharded port
    attn = Attention(16, heads=2)
    with torch.no_grad():
        for prm in attn.parameters():
            prm.uniform_(-0.25, 0.25, generator=gen)
    for n_tok, tokens, wt in (("1024", inp["tok"], inp["wt"]), ("6", x, w)):
        for mode in (SPARSE_CAUSAL, MOTION_FRAME, DENSE):
            _grad_check(f"spatial_{mode}_{n_tok}", ctx,
                        lambda t, m=mode: spatial_self_attention(attn, t, m, 2, shard=ctx),
                        lambda t, m=mode: spatial_self_attention(attn, t, m, 2, use_flash=False),
                        tokens, wt, results)
        _grad_check(f"temporal_{n_tok}", ctx,
                    lambda t: temporal_self_attention_video(attn, t, 2, shard=ctx),
                    lambda t: temporal_self_attention_video(attn, t, 2, use_kernel=False),
                    tokens, wt, results)
        mask = inp["mask" + n_tok]  # [F, N, 1]
        mask_l = shard_video(mask, ctx, frame_dim=0)
        _grad_check(f"injection_{n_tok}", ctx,
                    lambda t: injected_spatial_attention(attn, t, 2, mask_l, shard=ctx),
                    lambda t: injected_spatial_attention(attn, t, 2, mask, use_flash=False),
                    inp["tok4"] if n_tok == "1024" else inp["x4"],
                    inp["wt4"] if n_tok == "1024" else inp["w4"], results, branch_axis=True)
    if ctx.rank == 0:
        torch.save(results, os.path.join(out_dir, "results.pt"))


# ---------------------------------------------------------------------------
# the UNet forward, the denoise segment and the stage-1 step
# ---------------------------------------------------------------------------


def _tiny_unet(inp):
    from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig

    config = UNetConfig(**inp["config"])
    unet = UNet3DConditionModel(config).eval()
    unet.load_state_dict(inp["unet"])
    return config, unet


def unet_forward(ctx, out_dir):
    """The frame-sharded tiny UNet forward; rank 0 writes the gathered
    output."""
    from motioneditor_tpu_torch.models.unet import unet_apply

    inp = _inputs(out_dir)
    config, unet = _tiny_unet(inp)
    x = shard_video(inp["x"], ctx)
    with torch.no_grad():
        out = unet_apply(unet, config, x, inp["t"], inp["enc"], shard_ctx=ctx)
    out = gather_video(out, ctx)
    if ctx.rank == 0:
        torch.save(out, os.path.join(out_dir, "out.pt"))


def denoise(ctx, out_dir):
    """The frame-sharded injected denoise segment; rank 0 writes the
    gathered latents."""
    from motioneditor_tpu_torch.control.injection import InjectionSpec
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
    spec = InjectionSpec.from_start_layer(10, **inp["spec"])
    with torch.no_grad():
        cond_emb = precompute_cond_embedding(cn, shard_video(inp["skel"], ctx, branch_axis=True))
    masks = {k: shard_video(m, ctx, frame_dim=0) for k, m in inp["masks"].items()}
    out = denoise_segment(
        unet, config, cn, controlnet_config(config), DiffusionSchedule(), 50, spec, 7.5, 1.0,
        shard_video(inp["lat"], ctx, branch_axis=True), inp["seg_ts"], inp["cond"],
        inp["uncond"], cond_emb, masks, shard_ctx=ctx)
    out = gather_video(out, ctx, branch_axis=True)
    if ctx.rank == 0:
        torch.save(out, os.path.join(out_dir, "out.pt"))


def stage1_step(ctx, out_dir):
    """One frame- and data-sharded stage-1 step on the given noise; every
    rank writes its loss and trainables, rank 0 also the unsharded step's."""
    import copy

    from motioneditor_tpu_torch.training import stage1
    from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state

    inp = _inputs(out_dir)
    config, unet = _tiny_unet(inp)
    draw = (inp["noise"], inp["timesteps"])
    stage1.draw_noise = lambda *a: draw  # the test's noise, at the global shape
    opt = make_optimizer(learning_rate=1e-3, eps=1e-4)
    runs = [("sharded", ctx)] + ([("unsharded", None)] if ctx.rank == 0 else [])
    for name, shard in runs:
        state = make_train_state(copy.deepcopy(unet), stage1.TRAINABLE_MODULES, opt)
        lat, enc = inp["lat"], inp["enc"]
        if shard is not None:
            lat = shard_video(lat, ctx)
            enc = enc[ctx.data_rank * (enc.shape[0] // ctx.dp):][:enc.shape[0] // ctx.dp]
        state, metrics = stage1.train_step_stage1(
            state, lat, enc, torch.Generator(), config, remat=False, shard_ctx=shard)
        torch.save({"loss": float(metrics["loss"]),
                    "trainable": {n: p.detach().clone() for n, p in state.trainable.items()}},
                   os.path.join(out_dir, f"{name}{ctx.rank}.pt"))



# ---------------------------------------------------------------------------
# inversion, null-text, the pipeline and the stage-2 step
# ---------------------------------------------------------------------------


def inversion(ctx, out_dir):
    """The frame-sharded DDIM inversion, video attention off and on; rank 0
    writes the gathered x_T and trajectories."""
    from motioneditor_tpu_torch.pipelines.editor import ddim_invert
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    inp = _inputs(out_dir)
    config, unet = _tiny_unet(inp)
    out = {}
    for normal_infer in (True, False):
        x_t, all_lat = ddim_invert(unet, config, DiffusionSchedule(), shard_video(inp["lat"], ctx),
                                   inp["cond"], inp["steps"], normal_infer=normal_infer,
                                   shard_ctx=ctx)
        out[normal_infer] = (gather_video(x_t, ctx),
                             gather_video(all_lat, ctx, branch_axis=True, frame_dim=2))
    if ctx.rank == 0:
        torch.save(out, os.path.join(out_dir, "out.pt"))


def null_text(ctx, out_dir):
    """Frame-sharded null-text: ``null_optimization`` along the given
    trajectory, then ``null_text_inversion`` from the latents. Every rank
    writes its embeddings, the timestep of each objective call (the inner
    steps taken) and the gathered x_T."""
    from motioneditor_tpu_torch.pipelines import editor
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    inp = _inputs(out_dir)
    config, unet = _tiny_unet(inp)
    calls = []
    loss_fn = editor.null_text_loss

    def counting_loss(*args, **kwargs):
        calls.append(args[8])  # the timestep
        return loss_fn(*args, **kwargs)

    editor.null_text_loss = counting_loss
    opt = inp["opt"]
    args = (unet, config, DiffusionSchedule())
    uncond = editor.null_optimization(
        *args, shard_video(inp["all_lat"], ctx, branch_axis=True, frame_dim=2), inp["cond"],
        inp["uncond0"], opt["num_steps"], opt["inner_steps"], opt["base_lr"],
        opt["guidance_scale"], early_stop_epsilon=opt["early_stop_epsilon"], shard_ctx=ctx)
    opt_calls = list(calls)
    calls.clear()
    x_t, inv_uncond = editor.null_text_inversion(
        *args, shard_video(inp["lat"], ctx), inp["cond"], inp["uncond0"], opt["num_steps"],
        opt["inner_steps"], opt["base_lr"], opt["guidance_scale"], null_normal_infer=False,
        early_stop_epsilon=opt["early_stop_epsilon"], shard_ctx=ctx)
    torch.save({"uncond": uncond, "calls": opt_calls, "inversion_uncond": inv_uncond,
                "inversion_calls": list(calls), "x_t": gather_video(x_t, ctx)},
               os.path.join(out_dir, f"rank{ctx.rank}.pt"))


class FixedTokenizer(StubTokenizer):
    """``StubTokenizer`` with ids from crc32 instead of Python's salted
    ``hash``: the same in every process, so a test's JAX pipeline and the
    ranks read the same prompts."""

    def encode(self, text):
        words = [w for w in text.lower().strip().split(" ") if w]
        return ([self.bos_token_id] + [zlib.crc32(w.encode()) % 49000 + 320 for w in words]
                + [self.eos_token_id])


def _tiny_pipeline(inp, shard, tokenizer=None):
    """The tiny MotionEditorPipeline of the inputs' weights over ``shard``
    (``FixedTokenizer`` unless another is given)."""
    from motioneditor_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from motioneditor_tpu_torch.models.controlnet import ControlNetModel, controlnet_config
    from motioneditor_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from motioneditor_tpu_torch.pipelines.editor import MotionEditorPipeline

    config, unet = _tiny_unet(inp)
    cn = ControlNetModel(controlnet_config(config)).eval()
    cn.load_state_dict(inp["controlnet"])
    vae_config, text_config = VAEConfig(**inp["vae_config"]), CLIPTextConfig(**inp["text_config"])
    vae = AutoencoderKL(vae_config).eval()
    vae.load_state_dict(inp["vae"])
    text = CLIPTextModel(text_config).eval()
    text.load_state_dict(inp["text"])
    return MotionEditorPipeline(unet=unet, vae=vae, text_encoder=text, controlnet=cn,
                                tokenizer=tokenizer or FixedTokenizer(), unet_config=config,
                                vae_config=vae_config, text_config=text_config,
                                shard_ctx=shard)


def pipeline(ctx, out_dir):
    """MotionEditorPipeline from frames to frames over ``ctx`` (and, on rank
    0, unsharded): a generator-sampled encode, null-text inversion, the edit
    with masks and the per-step embeddings, the decode. Each run writes its
    results; every rank also writes a prompt's embeddings through
    ``StubTokenizer``, whose ids differ between processes."""
    inp = _inputs(out_dir)
    kw = inp["run"]
    runs = [("sharded", ctx)] + ([("unsharded", None)] if ctx.rank == 0 else [])
    for name, shard in runs:
        pipe = _tiny_pipeline(inp, shard)
        lat = pipe.encode_video(inp["video"], generator=torch.Generator().manual_seed(kw["seed"]))
        x_t, uncond = pipe.null_text_inversion(lat, kw["prompts"][0], num_steps=kw["steps"],
                                               null_inner_steps=kw["inner_steps"])
        video = pipe(kw["prompts"], torch.cat([x_t, x_t]), inp["skeleton"],
                     source_masks=inp["masks"], uncond_embeddings=uncond,
                     num_inference_steps=kw["steps"], start_step=kw["start_step"])
        torch.save({"latents": lat, "x_t": x_t, "uncond": uncond, "video": video},
                   os.path.join(out_dir, f"{name}{ctx.rank}.pt"))
    stub = _tiny_pipeline(inp, ctx, StubTokenizer())
    torch.save(stub.encode_prompt(kw["prompts"]), os.path.join(out_dir, f"stub{ctx.rank}.pt"))


def stage2_step(ctx, out_dir):
    """One frame- and data-sharded stage-2 step on the given noise; every
    rank writes its loss and trainables, rank 0 also the unsharded step's."""
    import copy

    from motioneditor_tpu_torch.models.controlnet import ControlNetModel, controlnet_config
    from motioneditor_tpu_torch.training import stage2
    from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state

    inp = _inputs(out_dir)
    config, unet = _tiny_unet(inp)
    cn = ControlNetModel(controlnet_config(config)).eval()
    cn.load_state_dict(inp["controlnet"])
    cn.requires_grad_(False)
    draw = (inp["noise"], inp["timesteps"])
    stage2.draw_noise = lambda *a: draw  # the test's noise, at the global shape
    opt = make_optimizer(learning_rate=1e-3, eps=1e-4)
    runs = [("sharded", ctx)] + ([("unsharded", None)] if ctx.rank == 0 else [])
    for name, shard in runs:
        state = make_train_state(copy.deepcopy(unet), stage2.TRAINABLE_MODULES, opt)
        lat, skel, enc = inp["lat"], inp["skel"], inp["enc"]
        if shard is not None:
            lat, skel = shard_video(lat, ctx), shard_video(skel, ctx)
            enc = enc.chunk(ctx.dp)[ctx.data_rank]
        state, metrics = stage2.train_step_stage2(
            state, cn, lat, skel, enc, torch.Generator(), config, controlnet_config(config),
            remat=False, shard_ctx=shard)
        torch.save({"loss": float(metrics["loss"]),
                    "trainable": {n: p.detach().clone() for n, p in state.trainable.items()}},
                   os.path.join(out_dir, f"{name}{ctx.rank}.pt"))


def p2p_edit(ctx, out_dir):
    """The p2p edit over ``ctx`` (and, on rank 0, unsharded) from the
    inputs' x_T, for each case of ``inp["cases"]`` (kind, start_step, with
    masks): the controllers and LocalBlend from this process's
    ``StubTokenizer``, whose ids differ between processes. The LocalBlend
    threshold comes from chip_smoke.py's ``clear_threshold`` over the
    sharded run, reduced over the ranks so that every rank picks the same
    one. Writes each rank's controllers' arrays, the thresholds, the videos,
    and the distances of the compared runs' map values from the threshold."""
    import chip_smoke as cs
    from motioneditor_tpu_torch.control import p2p

    inp = _inputs(out_dir)

    def over_ranks(value, op):
        t = torch.tensor([float(value)])
        dist.all_reduce(t, op=dist.ReduceOp.MIN if op == "min" else dist.ReduceOp.MAX,
                        group=ctx.frame_group)
        return t.item()

    results = {"arrays": {}, "videos": {}, "thresholds": {}, "gaps": []}
    sharded = _tiny_pipeline(inp, ctx, StubTokenizer())
    for kind, start_step, with_masks in inp["cases"]:
        prompts = inp["prompts"][kind]
        kw = {"equalizer_words": ["man"], "equalizer_values": [3.0]} \
            if kind == "reweight" else {}
        ctl = p2p.make_controller(prompts, sharded.tokenizer, inp["steps"], **kw)
        alpha = p2p.make_local_blend(prompts, [["man"]] * 2, sharded.tokenizer).alpha_layers
        assert ctl.kind == kind
        results["arrays"][kind] = {k: getattr(ctl, k) for k in (
            "cross_alpha", "mapper", "refine_alphas", "equalizer")}
        results["arrays"][kind]["alpha_layers"] = alpha

        def run(pipe, blend):
            return pipe(prompts, torch.cat([inp["x_t"], inp["x_t"]]), inp["skeleton"],
                        source_masks=inp["masks"] if with_masks else None,
                        num_inference_steps=inp["steps"], start_step=start_step,
                        p2p_controller=ctl, local_blend=blend)

        threshold = cs.clear_threshold(alpha, lambda blend: run(sharded, blend), over_ranks)
        results["thresholds"][kind] = threshold
        runs = [("sharded", sharded)]
        if ctx.rank == 0:
            runs.append(("unsharded", _tiny_pipeline(inp, None, sharded.tokenizer)))
        for name, pipe in runs:
            blend = cs.recording_blend(alpha, threshold)
            results["videos"][(name, kind)] = run(pipe, blend)
            results["gaps"] += [c["gap"] for c in blend.calls]
    torch.save(results, os.path.join(out_dir, f"rank{ctx.rank}.pt"))
