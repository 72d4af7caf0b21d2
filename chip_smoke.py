"""Smoke test of the PyTorch/CUDA port (motioneditor_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device   require CUDA; print the card's name and power limit
  2. build    compile csrc/*.cu for sm_90a from this checkout; print the
              registers and spills ptxas reports for the tensor-core
              attention kernels and count the tensor-core instructions
              (HGMMA, HMMA) in their SASS when cuobjdump is on the host
  3. kernels  each forward CUDA kernel against its plain PyTorch version on
              the card, at the denoise step's shapes (B=2, F=8, (N, C) in
              {(4096, 320), (1024, 640)}, 8 heads) in bf16 and fp32 (TF32
              off), with CUDA-event times of both; the split-head kernels
              (K8 flash_attention, K9 fused_injection_attention) at the auto
              path's shapes (q [2, 8, 8, N, d], K/V over 2N keys, (N, d) in
              {(4096, 40), (1024, 80)}); one PyTorch library call where one
              computes the same function (scaled_dot_product_attention for
              K8, for K9 over split-head q against the 5N keys
              [K*m | K*(1-m) | K_tgt], and for K1 motion_frame on split-head
              views of q against the [f-1 | f] K/V built before the timing),
              timed as a yardstick; K3 and the other short kernels (K7,
              K10, K11, K14) are timed over KERNEL_REPS launches per event
              pair; in bf16, K1, K2, K8 and K9 run their
              tensor-core body (csrc/attention_tc.cu; K2 and K9 its injection
              instantiation), whose TFLOP/s and
              share of its bound are printed at every shape, and whose errors
              are also held to limits scaled to the reference
              (TC_ERR_LIMITS); K2 and K9 in bf16 also with a fractional and a
              mixed fg mask (INJECTION_MASKS), their CUDA-core bodies timed on
              the same inputs by a direct call, and SDPA over split-head views
              of q against the 5N keys [K*m | K*(1-m) | K_tgt] as their
              yardstick
  3a. temporal K3 (the TMA-staged body, csrc/temporal_attention_tma.cu)
              in bf16 at TEMPORAL_SHAPES against its plain version: its time,
              byte bound and share, the plain version's and SDPA
              is_causal's on [B*N, H, F, d] copies; then at the 16x16 sites
              (TEMPORAL_GATE_SHAPE) the attention layer through K3 against
              the eager path where ops/attention.py's N >= 512 gate keeps it
  3b. bwd     the backward kernels (K4 residual-saving forward, K5 dq, K6
              dk/dv partials, K7 temporal) against their plain versions and
              autograd of the plain forward, at the null-text shapes (B=1,
              F=8, the same (N, C), modes normal / sparse_causal /
              motion_frame), bf16 and fp32, with times, TFLOP/s and shares
              of the bound at both shapes; in bf16 K4, K5 and K6 run their
              tensor-core bodies (csrc/attention_tc.cu,
              csrc/attention_dq_tc.cu, csrc/attention_bwd_tc.cu): K4's
              output, K5's dQ (against the fp32 plain dQ) and K6's partials
              (made from the plain delta) are also held to TC_ERR_LIMITS,
              K4's lse to atol 1e-4 and K5's delta to the plain
              rowsum(dO o O)
  4. slice    the injected two-branch denoise segment at full SD-1.5 width
              (UNet + adapter + ControlNet, random init from a seed), bf16,
              512px, 8 frames, injection from block 10, 3 steps over
              timesteps[4:7]; asserts finite output and the per-step kernel
              launch counts (every K1 and K2 launch on the tensor-core body),
              prints ms per step; then one more step under torch.profiler:
              the device's busy share and kernel time per bucket
  5. check    a tiny fp32 segment whose level-0 attention reaches the
              kernels, kernel path against the plain path on the card
  5b. check   a tiny fp32 null-text inversion (32x32 latents, 2 steps, 2
              inner steps), kernel path against the plain path; every
              forward and backward kernel of the path must launch
  6. null     null-text inversion then the edit at full width, bf16, 512px,
              8 frames, batch 1, random [1, 77, 768] text embeddings, a
              5-step schedule: 5 inversion steps (motion_frame), 5 null-text
              steps (inner_steps 1, bf16 compute, fp32 masters), then the
              injected edit over the last 2 steps with the optimized
              per-step uncond embeddings; asserts finite outputs and the
              per-step launch counts, prints ms per step and peak memory
  7. pipe     MotionEditorPipeline from frames to frames at full width with
              the VAE and the CLIP text encoder (StubTokenizer), bf16, 512px,
              8 frames, random init from the seed: encode_video ->
              null_text_inversion -> the edit (mask mode) -> decode, on a
              5-step schedule with start_step 3 (3 vanilla steps, 2
              injected); asserts a finite [2, 8, 512, 512, 3] video in
              [0, 1] and the launch counts, prints the time of each part
  12. p2p     (run after phase 7, on its models and its inputs: x_T, the
              per-step null-text embeddings, the skeleton and masks) the
              edit under prompt-to-prompt control, P2P_PROMPTS through
              make_controller (replace) with a LocalBlend on "man", beside
              phase 7's edit of the same inputs and prompts, in turns
              (plain, p2p, p2p, plain); asserts the per-step launch counts
              (the mask edit's: the p2p hooks act below every kernel's
              gate), a finite [2, 8, 512, 512, 3] video in [0, 1] and that
              the edit moved; prints ms per step and peak memory of both,
              and one more injected step of each under torch.profiler
  13. eval    (run after phase 12) the edit-quality metrics of phase 12's
              video against phase 7's source frames: PSNR, SSIM and LPIPS
              (random AlexNet taps) of the reconstruction, the edit's
              temporal consistency, its CLIP score and frame consistency (a
              random ViT-L/14 image tower at full width, phase 7's text
              encoder); each finite, with its ms on the card; then each on
              2 frames in fp32 against the same function on the CPU, within
              1e-4 of |CPU|
  14. weights (run after phase 13, on phase 7's pipeline) phase 7's models
              written in the published checkpoints' layouts under
              build/phase14_weights (the UNet as .safetensors through
              write_safetensors, without temporal or adapter keys; the VAE
              .bin under to_q / to_out.0 names with 1x1-conv attention
              weights; the text encoder .bin with the text_model. prefix
              and position_ids; the ControlNet .bin; the adapter as the
              reference's .pth), fp32, read back through
              inference.build_pipeline in bf16: write, read and build
              seconds per model; every loaded parameter equal to phase 7's
              bitwise but attn_temp's q / k / v (fresh init, to_out zero);
              phase 7's edit on the loaded pipeline and again on phase 7's:
              the same launches as phase 7's, latents within the repeat's
              spread of phase 7's (0 when both are bitwise); the directory
              is deleted
  15. prep    OpenPose body, hand and face and MiDaS DPT-Hybrid at the
              published widths, random from the seed, written as the
              released files' layouts (prefix-stripped body and hand .pth,
              flat facenet.pth, the DPT checkpoint mirror's .pt) and read
              back through the loaders; on 8 frames of 512 x 512:
              render_skeleton_full with body + hand + face, the hand and
              face networks on a 128 px crop of each frame (random weights
              find no person, so no crop reaches them inside the render),
              estimate_depth, and align_frames on synthetic masks; ms per
              frame of each network (CUDA events, at the inputs the path
              gives it) apart from the host decoding; each network's fp32
              output on one input, card against CPU, within
              PREP_CARD_CPU_LIMIT of max |CPU|
  16. masks   (run after phase 15) GroundingDINO-SwinT and SAM ViT-H at the
              published widths, random from the seed in fp32, written as
              the released files (groundingdino_swint_ogc.pth as {"model":
              ...} under tests/fixtures/manifests/gdino_swint.txt's keys,
              a flat sam_vit_h_4b8939.pth under sam_vit_h.txt's) beside a
              synthetic 30,522-token BERT vocab; the masks CLI's native path
              (prep/masks.py main, --device cuda, box threshold 0) on 8
              PNGs of 512 x 512: 8 masks of 0 / 255 at 512 x 512; ms per
              frame of GroundingDINO, the SAM encoder and SAM's prompt +
              decoder (CUDA events) beside the host's parts (tokenization,
              PIL resizes, box decode, the mask resize, the PNG write);
              the phase's peak memory; one frame in fp32 card against CPU:
              boxes, finite logits, SAM's embedding and mask logits within
              PREP_CARD_CPU_LIMIT of max |CPU|, the top-k queries
              identical; no kernel launched
  8. auto     the denoise segment in auto-mask mode at full width, bf16, 3
              steps; asserts the per-step launch counts (every K1 and K8
              launch on the tensor-core body), prints ms per step, profiles
              one more step as phase 4 does
  8b. check   tiny fp32 checks, kernel path against plain path: an auto
              segment (K8 at its real call site) and the split-head branch
              of the mask injection at a head dim the packed kernels
              decline (d = 9), where K8 and K9 launch on their CUDA-core
              body (no ".tc" count)
  12b. check  (run after phase 8b) tiny fp32 p2p segments at 32x32
              latents, kernel path against plain path: replace, refine and
              reweight with LocalBlend in mask mode, replace with normal
              attention (the self-attention editor acts at the 16x16 sites)
              and replace in auto-mask mode (K8); each at a LocalBlend
              threshold that no map value of the plain run comes within
              P2P_MARGIN of, so both paths take the same mask
  3c. norm    (run after phase 3b) the GroupNorm pair statistics (K10) at
              [1, 32768, 320] (x, x) and (dy, x), [8, 4096, 320],
              [1, 512, 2560] and the 24-frame [1, 98304, 320], every launch
              on its 16-byte body and bit-identical twice, with times, byte
              bounds and shares and the launch plan, and the fused add +
              LayerNorm (K11) at [1, 8, 4096, 320] and [1, 8, 1024, 640],
              against their plain versions in bf16 and fp32; the GroupNorm
              Function's
              dx, dscale and dbias against autograd of the plain group_norm;
              F.group_norm and add + F.layer_norm timed as yardsticks
  9. train check  a tiny fp32 stage-1 step and stage-2 step with
              MOTIONEDITOR_FUSED_GN / _LN on and the kernels (K1, K3-K7, K10
              forward and backward, K11), against the plain path with both
              off: loss, the trainables' gradients, the parameters after one
              AdamW step
  10. train   stage 1 then stage 2 at full SD-1.5 width, random init from
              the seed, bf16 frozen weights with fp32 masters, 512 px, 8
              frames, batch 1, gradient checkpointing: a warm-up step and 3
              steps each with both knobs on, asserting finite losses, that
              only the trainables moved and the per-step launch counts; then
              the same steps with both knobs off; ms per step and peak memory;
              with the knobs on, K10's calls of one more step of each stage
              by shape (stage 1's forward shapes must be the UNet's
              GroupNorms, unet_group_norm_shapes), then one more step of
              each stage under torch.profiler: the device's busy share,
              kernel time and kernels per bucket (K4, K5, K6, K7, K10 and
              K11 each their own), one K10 kernel per K10 call, and K10's
              device ms beside its byte bound summed over the step
  3d. kv      (run after phase 3c) the frame-sharded path's kernels against
              their plain versions in bf16 and fp32: K12 (explicit-K/V
              attention) at q [2, 8, 4096, 320] over motion_frame K/V
              [2, 8, 8192, 320] and dense K/V [2, 1, 32768, 320], and at
              q [2, 8, 1024, 640] (d = 80) over [2, 8, 2048, 640] and
              [2, 1, 8192, 640], K13 (explicit-K/V injection) at the same
              q, K14 (global-offset temporal attention, on K3's TMA-staged
              body) at Fq = Fk = 8;
              then, at both sizes, each 2-frame shard of
              a 4-way frame split (K14 at offsets 0, 2, 4, 6; K12 / K13 on
              K/V sliced from the global tensors), also held to its slice of
              the one-rank output; SDPA timed as the yardstick of K12 and,
              with a boolean mask, of K14 at every case, whose byte bound
              and share are printed there too; in bf16 K12 runs the tensor-core
              body (csrc/attention_tc.cu), held also to TC_ERR_LIMITS, with
              its TFLOP/s and share of its bound, and its time is printed
              beside K1's on the same work; so does K13 (the injection
              instantiation), also with the fractional and mixed masks, its
              CUDA-core body timed by a direct call and SDPA over the 2M + N
              injected keys as its yardstick
  11. shard   the frame-sharded paths at full width in a one-rank NCCL
              process group, bf16: the injected denoise segment, 3 steps
              after a warm-up step; inversion and null-text on phase 6's
              schedule after a warm-up step; MotionEditorPipeline with a
              shard_ctx from frames to frames on phase 7's schedule (VAE
              encode, null-text inversion, the edit, VAE decode) and phase
              12's p2p edit of the same inputs; one stage-1
              and one stage-2 step, each after a warm-up step; asserts the
              per-step launch counts (K1, K4-K6, K12, K13, K14; derived on
              the CPU by tests/test_torch_sharding_phases_counts.py), prints
              ms per step, peak memory and, for the segment and the training
              steps, the device's busy share of one more step under
              torch.profiler
  11b. check  (run before phase 11) tiny fp32 checks in that group, each
              sharded path against the unsharded one: the segment, the
              segment under the p2p controller with LocalBlend (K12, K13,
              K14 launched), inversion, null-text with its early stop
              reached (the same inner steps, the same embeddings on every
              rank), the
              pipeline's edited latents, and a stage-1 and a stage-2 step
              (loss, gradients, parameters after one AdamW step; stage 2's
              gradients and parameters in fp64 on the plain path, its fp32
              kernel path by the loss: TRAIN_CHECKS)
Then one JSON line of per-kernel results, the nvidia-smi line, and the last
line {"ok": true, "device": {...}}. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import subprocess
import sys
import time

SEED = 0
FRAMES = 8
LATENT = 64  # 512 px
HEADS = 8
KERNEL_SHAPES = ((4096, 320), (1024, 640))  # (N, C) at 64x64 and 32x32 latents
MODES = ("normal", "sparse_causal", "motion_frame", "dense")
BWD_MODES = ("normal", "sparse_causal", "motion_frame")
NULL_STEPS = 5  # phase 6's schedule
LOGIT_CAP = 60.0  # the JAX bf16 kernels' score clamp (ops/video_flash.py _CAP)
# K1, K2, K8, K9, K12, K13 and K4 launches in bf16 take the tensor-core body
# (csrc/attention_tc.cu; K2, K9 and K13 its injection instantiation), K5's and
# K6's at d <= 80 their own (csrc/attention_dq_tc.cu,
# csrc/attention_bwd_tc.cu), and count again as "<name>.tc"; every
# full-width path below runs in bf16 at d = 40 and 80, so every launch of
# these kernels there takes the tensor-core body
TC_KERNELS = ("video_flash_attention", "video_injection_attention", "flash_attention",
              "fused_injection_attention", "video_flash_attention_kv",
              "video_injection_attention_kv",
              "video_flash_fwd_res", "video_flash_bwd_dq", "video_flash_bwd_dkv")
# K2's and K13's bf16 checks: the fg masks besides the pipeline's binary one
# (every binary mask gives the same output, so only masks whose min(m, 1 - m)
# varies by key show a mask read from the wrong frame or row): uniform in
# [0, 1], and mixed (``fg_mask``), so both softmax paths of the injection
# instantiation run within one launch. With
# those two the output is held to the plain version in fp32 on the same bf16
# inputs: the bf16 plain version rounds m and K*m to bf16, which the kernel
# does not, and reads up to ~2% of max |ref| off the fp32 one (PERF.md)
INJECTION_MASKS = ("binary", "fractional", "mixed")


def tc(per_step: dict) -> dict:
    """``per_step`` with the tensor-core sub-counts of a bf16 path: each K1,
    K2, K8, K12, K13, K4, K5 and K6 launch there must have taken the
    tensor-core body."""
    return {**per_step, **{f"{k}.tc": n for k, n in per_step.items() if k in TC_KERNELS}}


# per denoise step: UNet blocks 0-3 (4) + source rows of blocks 10-15 (6)
# + ControlNet blocks 0-3 (4) + adapter blocks 0-5 x (attn_temp, attn_pose) (12)
EXPECTED_PER_STEP = tc({
    "video_flash_attention": 26,
    "video_injection_attention": 6,  # edit rows of blocks 10-15
    "temporal_flash_attention": 16,  # UNet blocks 0-3, 10-15 (10) + adapter 0-5 (6)
})
# per inversion step (batch 1, no ControlNet or adapter): UNet blocks 0-3 and
# 10-15 (64x64 and 32x32); the 16x16 and 8x8 sites stay under the size gates
EXPECTED_PER_INVERSION_STEP = tc({"video_flash_attention": 10,
                                  "temporal_flash_attention": 10})
# per null-text step (inner_steps 1): 2 forwards without grad (eps_cond and the
# latent advance) + 1 forward under grad and its backward. In the grad forward
# block 0's attn1 precedes every cross-attention, so nothing there depends on
# the embedding and it launches K1; the other 9 attn1 sites and all 10
# attn_temp sites (each after a cross-attention) take the grad path.
EXPECTED_PER_NULL_STEP = tc({
    "video_flash_attention": 21,
    "video_flash_fwd_res": 9,
    "video_flash_bwd_dq": 9,
    "video_flash_bwd_dkv": 9,
    "temporal_flash_attention": 30,
    "temporal_flash_attention_bwd": 10,
})
# per auto-mode segment step: UNet blocks 0-3 (4) + ControlNet 0-3 (4) + adapter
# 0-5 x 2 (12); blocks 10-15 run K8 three times each (source rows, fg, bg)
EXPECTED_PER_AUTO_STEP = tc({
    "video_flash_attention": 20,
    "temporal_flash_attention": 16,
    "flash_attention": 18,
})
PIPE_STEPS, PIPE_START = 5, 3  # phase 7: 3 vanilla steps, then 2 injected
# a vanilla step launches what an injected one does, but for K2: blocks 10-15
# run K1 on all four rows instead of K1 on the source rows and K2 on the edit rows
EXPECTED_PER_VANILLA_STEP = tc({"video_flash_attention": 26, "temporal_flash_attention": 16})
AUTO_SHAPES = ((4096, 40), (1024, 80))  # (N, d) of the auto path's K8 / K9 calls
# K10 [B, S, C] at 512 px and 8 frames: a pooled level-0 resnet GroupNorm, the
# per-frame transformer one, the widest up-block input; the pooled level-0
# GroupNorm at 24 frames; K11 [B, F, N, C] at the two gated levels
PAIR_STATS_SHAPES = ((1, 32768, 320), (8, 4096, 320), (1, 512, 2560), (1, 98304, 320))
ADD_LN_SHAPES = ((1, 8, 4096, 320), (1, 8, 1024, 640))
TRAIN_STEPS = 3


def unet_group_norm_shapes(channels=(320, 640, 1280, 1280), layers: int = 2, batch: int = 1,
                           frames: int = FRAMES, latent: int = LATENT) -> list:
    """The [B, S, C] of every GroupNorm statistics call of one forward of the
    video UNet (models/unet.py ``unet_apply``; the SD-1.5 widths by
    default), in order: each resnet's norm1 and norm2 pool over the frames
    (B = batch, S = frames x H x W), each transformer's norm is per frame
    (B = batch x frames, S = H x W; none in the last down block and the
    first up block), then conv_norm_out. The up path's resnets take the
    skip connections' channels on top of their input's."""
    shapes = []
    side, cin, skips = latent, channels[0], [channels[0]]
    last = len(channels) - 1

    def resnet(c_in, c_out):
        shapes.extend([(batch, frames * side * side, c_in), (batch, frames * side * side, c_out)])

    for i, c in enumerate(channels):
        for _ in range(layers):
            resnet(cin, c)
            cin = c
            if i < last:
                shapes.append((batch * frames, side * side, c))
            skips.append(c)
        if i < last:
            side //= 2
            skips.append(c)
    resnet(cin, cin)
    shapes.append((batch * frames, side * side, cin))
    resnet(cin, cin)
    for i, c in enumerate(reversed(channels)):
        for _ in range(layers + 1):
            resnet(cin + skips.pop(), c)
            cin = c
            if i > 0:
                shapes.append((batch * frames, side * side, c))
        if i < last:
            side *= 2
    shapes.append((batch, frames * side * side, cin))
    return shapes


# per training step, gradient checkpointing on, both knobs on (derived in
# PERF.md): stage 1 trains attn1.to_q / attn2.to_q / attn_temp of every block,
# so the 10 gated attn1 sites take K4 (again in the recompute) and K5 / K6,
# the 10 gated attn_temp sites K3 (twice) and K7; K10 61 forward + 58
# recomputed + 58 backward, every launch on its 16-byte body (".vec": every
# SD-1.5 width is a multiple of 8); K11 30 forward + 30 recomputed
EXPECTED_PER_STAGE1_STEP = tc({
    "video_flash_fwd_res": 20, "video_flash_bwd_dq": 10, "video_flash_bwd_dkv": 10,
    "temporal_flash_attention": 20, "temporal_flash_attention_bwd": 10,
    "channel_pair_stats": 177, "channel_pair_stats.vec": 177, "add_layer_norm": 60,
})
# stage 2: the ControlNet (no grad) K1 4, K10 27, K11 8; the UNet's down path
# (no grad) K1 4, K3 4; the adapter (blocks 0-5 gated) K4 12, K3 6; the up
# path K4 6 + 6 recomputed, K3 6 + 6; backward K5 / K6 12 + 6, K7 6 + 6; K10
# 61 forward + 33 recomputed + 34 backward, all ".vec"; K11 30 forward + 18
# recomputed
EXPECTED_PER_STAGE2_STEP = tc({
    "video_flash_attention": 8, "video_flash_fwd_res": 24, "video_flash_bwd_dq": 18,
    "video_flash_bwd_dkv": 18, "temporal_flash_attention": 22,
    "temporal_flash_attention_bwd": 12, "channel_pair_stats": 155,
    "channel_pair_stats.vec": 155, "add_layer_norm": 56,
})
NORM_KERNELS = ("channel_pair_stats", "add_layer_norm")
KV_KERNELS = ("video_flash_attention_kv", "video_injection_attention_kv",
              "temporal_flash_attention_global")
SHARDED_KERNELS = ("video_flash_attention",) + KV_KERNELS  # a sharded edit's kernels
SPLIT = 4  # the frame split whose shard-local shapes phase 3d checks
# per sharded denoise step (one rank, mask mode): UNet blocks 0-3 K12 (4) +
# blocks 10-15 K12 on the source rows (6) and K13 on the edit rows (6); the
# adapter blocks 0-5 K12 (attn_temp, sparse_causal: 6), K1 (the per-frame
# cross attention: 6) and K14 (6); the ControlNet K1 (4); K14 at UNet blocks
# 0-3 and 10-15 (10). No K2 or K3.
EXPECTED_PER_SHARDED_STEP = tc({
    "video_flash_attention": 10, "video_flash_attention_kv": 16,
    "video_injection_attention_kv": 6, "temporal_flash_attention_global": 16,
})
# per sharded stage-1 step, gradient checkpointing on, knobs off: the 10 gated
# attn1 sites launch K12 in the forward and again in the recompute, the 10
# gated attn_temp sites K14 likewise; their gradients are the plain VJPs
SHARDED_STAGE1_LAUNCHES = {"video_flash_attention_kv": 20, "temporal_flash_attention_global": 20}
EXPECTED_PER_SHARDED_STAGE1_STEP = tc(SHARDED_STAGE1_LAUNCHES)
# The sharded phases below are derived on the CPU, on the meta device, by
# tests/test_torch_sharding_phases_counts.py. Per sharded inversion step
# (batch 1, motion_frame, no ControlNet or adapter): UNet blocks 0-3 and
# 10-15 K12 (10) and K14 (10)
EXPECTED_PER_SHARDED_INVERSION_STEP = tc({"video_flash_attention_kv": 10,
                                          "temporal_flash_attention_global": 10})
# per sharded null-text step (inner_steps 1): three forwards (eps_cond, the
# inner step's, the latent advance) of 10 K12 and 10 K14 each; the inner
# step's backward takes K12's and K14's plain VJPs, no kernel
EXPECTED_PER_SHARDED_NULL_STEP = tc({"video_flash_attention_kv": 30,
                                     "temporal_flash_attention_global": 30})
# a sharded vanilla edit step launches what an injected one does
# (EXPECTED_PER_SHARDED_STEP) but for K13: blocks 10-15 run K12 on all rows
EXPECTED_PER_SHARDED_VANILLA_STEP = tc({"video_flash_attention": 10,
                                        "video_flash_attention_kv": 16,
                                        "temporal_flash_attention_global": 16})
# per sharded stage-2 step, gradient checkpointing on, knobs off: the
# ControlNet (no grad) K1 4; the UNet's down path (no grad) K12 4, K14 4;
# the adapter K12 6 (attn_temp), K14 6 and, at its per-frame cross attention
# under grad, K4 6 with K5 / K6 6 in the backward; the up path K12 and K14
# 6 + 6 recomputed. K12's and K14's gradients are their plain VJPs
EXPECTED_PER_SHARDED_STAGE2_STEP = tc({
    "video_flash_attention": 4, "video_flash_attention_kv": 22,
    "temporal_flash_attention_global": 22, "video_flash_fwd_res": 6, "video_flash_bwd_dq": 6,
    "video_flash_bwd_dkv": 6})
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM dense (no tensor cores in fp32)
PEAK_BYTES = 3.35e12
KERNEL_INFO = {
    "video_flash_attention": ("motioneditor_tpu_torch/csrc/attention_tc.cu",
                              "motioneditor_tpu/ops/video_flash.py:248"),
    "video_injection_attention": ("motioneditor_tpu_torch/csrc/attention_tc.cu",
                                  "motioneditor_tpu/ops/video_flash.py:591"),
    "temporal_flash_attention": ("motioneditor_tpu_torch/csrc/temporal_attention_tma.cu",
                                 "motioneditor_tpu/ops/temporal_flash.py:208"),
    "video_flash_fwd_res": ("motioneditor_tpu_torch/csrc/attention_tc.cu",
                            "motioneditor_tpu/ops/video_flash_bwd.py:229"),
    "video_flash_bwd_dq": ("motioneditor_tpu_torch/csrc/attention_dq_tc.cu",
                           "motioneditor_tpu/ops/video_flash_bwd.py:403"),
    "video_flash_bwd_dkv": ("motioneditor_tpu_torch/csrc/attention_bwd_tc.cu",
                            "motioneditor_tpu/ops/video_flash_bwd.py:437"),
    "temporal_flash_attention_bwd": ("motioneditor_tpu_torch/csrc/temporal_attention_bwd_tma.cu",
                                     "motioneditor_tpu/ops/temporal_flash.py:190"),
    "flash_attention": ("motioneditor_tpu_torch/csrc/attention_tc.cu",
                        "motioneditor_tpu/ops/flash_attention.py:222"),
    "fused_injection_attention": ("motioneditor_tpu_torch/csrc/attention_tc.cu",
                                  "motioneditor_tpu/ops/injection_flash.py:268"),
    "channel_pair_stats": ("motioneditor_tpu_torch/csrc/norm_stats.cu",
                           "motioneditor_tpu/ops/gn_stats.py:78"),
    "add_layer_norm": ("motioneditor_tpu_torch/csrc/add_layer_norm.cu",
                       "motioneditor_tpu/ops/fused_norm.py:73"),
    "video_flash_attention_kv": ("motioneditor_tpu_torch/csrc/attention_tc.cu",
                                 "motioneditor_tpu/ops/video_flash.py:726"),
    "video_injection_attention_kv": ("motioneditor_tpu_torch/csrc/attention_tc.cu",
                                     "motioneditor_tpu/ops/video_flash.py:859"),
    "temporal_flash_attention_global": ("motioneditor_tpu_torch/csrc/temporal_attention_tma.cu",
                                        "motioneditor_tpu/ops/temporal_flash.py:361"),
}
SPLIT_KERNELS = ("flash_attention", "fused_injection_attention")
# K8's and K9's other body: fp32, head dims the tensor-core body declines
# (d = 9 at phase 8b's call site), misaligned views, and for K9 K/V
# broadcast over the lead dims
CUDA_CORE_SOURCE = {name: "motioneditor_tpu_torch/csrc/split_attention.cu"
                    for name in SPLIT_KERNELS}
FORWARD_KERNELS = ("video_flash_attention", "video_injection_attention",
                   "temporal_flash_attention")
AUTO_KERNELS = ("video_flash_attention", "flash_attention", "temporal_flash_attention")
BACKWARD_KERNELS = ("video_flash_fwd_res", "video_flash_bwd_dq", "video_flash_bwd_dkv",
                    "temporal_flash_attention_bwd")


def log(msg: str) -> None:
    print(msg, flush=True)


# launches per event pair for the kernels that take ~0.02-0.3 ms (K3, K7, K10,
# K11, K14): at 3 a timing of these reads the host's enqueue behind the
# Python wrapper and its ctypes call, not the kernel
KERNEL_REPS = 200
# K3 at the denoise step's sites (B = 2) and at the UNet's 64x64 and 32x32
# sites at batch 4, bf16, 8 heads
TEMPORAL_SHAPES = ((2, FRAMES, 4096, 320), (4, FRAMES, 4096, 320), (4, FRAMES, 1024, 640))
# the 16x16 sites that ops/attention.py _TEMPORAL_MIN_N = 512 keeps on the eager path
TEMPORAL_GATE_SHAPE = (4, FRAMES, 256, 1280)


def time_ms(fn, reps: int = 3) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tolerance(dtype):
    import torch

    # bf16: atol 3e-2 (tests/test_video_flash.py:47) plus torch's bf16 rtol,
    # since one bf16 ulp of an output of magnitude >= 4 is already 0.031
    return dict(atol=2e-5, rtol=0.0) if dtype == torch.float32 else dict(atol=3e-2, rtol=1.6e-2)


# The tensor-core bodies' bf16 outputs are also held to the scale of what is
# compared: on these inputs (logits ~N(0, 1)) an output's RMS is about
# sqrt(e / keys), 0.009-0.036 at the shapes here, under the atol of
# tolerance(). Limits on max |out - ref| / max |ref| and on
# ||out - ref|| / ||ref||: about 2.7x and 3.2x the largest readings of a
# right kernel on the H100 (PERF.md), while an output missing one 64-key
# tile per pass, or one frame of dense keys, exceeds both
# (tests/test_torch_attention_tolerance.py).
TC_ERR_LIMITS = {"max": 0.02, "rms": 0.01}


def scaled_of(out, ref) -> dict:
    """max |out - ref| / max |ref| and ||out - ref|| / ||ref||."""
    diff, ref = out.float() - ref.float(), ref.float()
    return {"max": (diff.abs().max() / ref.abs().max()).item(),
            "rms": (diff.norm() / ref.norm()).item()}


def scaled_error(out, ref) -> dict:
    """``scaled_of``; raises past ``TC_ERR_LIMITS``."""
    got = scaled_of(out, ref)
    for key, limit in TC_ERR_LIMITS.items():
        if not got[key] <= limit:
            raise AssertionError(f"{key} error {got[key]:.3e} of the reference's > {limit}")
    return got


def logit_bound(q, k, heads: int, scale: float) -> float:
    """Upper bound on |q.k| * scale over all head pairs (Cauchy-Schwarz) of
    packed [..., C] operands, whatever their token counts."""
    def top(x):
        return x.float().unflatten(-1, (heads, -1)).norm(dim=-1).amax().item()

    return top(q) * top(k) * scale


def bound(flops: float, moved: float, dtype) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak rate of their type and the bytes over the memory rate."""
    dt = str(dtype).replace("torch.", "")
    ops_ms = flops / PEAK_FLOPS[dt] * 1e3
    bytes_ms = moved / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "bytes": moved}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def video_work(name: str, variant: str, q) -> float:
    """Operations of the packed-head kernels on q [B, F, N, C]: two products
    (QK^T, PV) of 2*d flops per (query, key, head); the causal temporal
    kernel forms F(F+1)/2 frame pairs per site."""
    b, f, n, c = q.shape
    if name == "temporal_flash_attention":
        return 4.0 * b * n * c * f * (f + 1) / 2
    keys = {"normal": n, "sparse_causal": 2 * n, "motion_frame": 2 * n, "dense": f * n,
            "injection": 3 * n}[variant]  # injection: 2N source keys scored once, N target
    return 4.0 * b * f * n * keys * c


def fg_mask(kind: str, shape, device, gen):
    """An fp32 fg mask [..., keys]: binary, fractional (uniform in [0, 1]),
    all 0, all 1, or mixed: binary in even 64-key tiles, and in odd ones
    binary at even keys and fractional at odd keys."""
    import torch

    u = torch.rand(shape, generator=gen, device=device)
    if kind == "fractional":
        return u
    if kind in ("zeros", "ones"):
        return torch.full(shape, float(kind == "ones"), device=device)
    binary = (u > 0.5).float()
    if kind == "binary":
        return binary
    key = torch.arange(shape[-1], device=device)
    return torch.where(((key // 64) % 2 == 0) | (key % 2 == 0), binary, u)


def injection_keys(q, ks, vs, kt, vt, mask):
    """The keys and values one SDPA call needs for K2's or K13's function,
    as split-head [B*F, H, 2M + N, d] copies of [K*m | K*(1-m) | K_tgt] and
    [V | V | V_tgt] (ks, vs: the [B, F, M, C] source of each query frame,
    mask [F, M]), and the split-head view of q."""
    import torch

    def split(x):
        return x.view(-1, x.shape[2], HEADS, x.shape[3] // HEADS).transpose(1, 2)

    m = mask[None, :, :, None].to(ks.dtype)
    k_inj = torch.cat([ks * m, ks * (1.0 - m), kt], dim=2)
    v_inj = torch.cat([vs, vs, vt], dim=2)
    return split(q), split(k_inj), split(v_inj), split


def library_time(dtype, ref, fn) -> float:
    """The time of one PyTorch library call ``fn``, a yardstick only, after
    checking that it computes ``ref`` within the kernels' tolerance."""
    import torch

    torch.testing.assert_close(fn().float(), ref.float(), **tolerance(dtype))
    return time_ms(fn)


def scaled_line(r: dict, got: dict) -> str:
    """Keeps the largest scaled errors in ``r`` and returns them for the log."""
    for key, value in got.items():
        r[f"scaled_{key}_err"] = max(r.get(f"scaled_{key}_err", 0.0), value)
    return f", scaled errors max {got['max']:.3e} rms {got['rms']:.3e}"


def split_logit_bound(q, k, scale: float) -> float:
    """Upper bound on |q.k| * scale for split-head [..., H, N, d] operands."""
    return q.float().norm(dim=-1).amax().item() * k.float().norm(dim=-1).amax().item() * scale


def phase_kernels(device):
    """Each kernel against its plain version at the slice's shapes."""
    import torch

    from motioneditor_tpu_torch.ops.temporal_flash import (
        temporal_flash_attention,
        temporal_flash_attention_plain,
    )
    from motioneditor_tpu_torch.ops.video_flash import (
        video_flash_attention,
        video_flash_attention_plain,
        video_injection_attention,
        video_injection_attention_plain,
    )

    from torch.nn.functional import scaled_dot_product_attention as library_sdpa

    gen = torch.Generator(device=device).manual_seed(SEED)
    mask_gen = torch.Generator(device=device).manual_seed(SEED + 7)
    results = {name: {"max_abs_err": 0.0} for name in FORWARD_KERNELS}

    def split(x):  # [B, F, N, C] -> [B*F, H, N, d], a view
        b, f, n, c = x.shape
        return x.view(b * f, n, HEADS, c // HEADS).transpose(1, 2)

    for dtype in (torch.bfloat16, torch.float32):
        for n, c in KERNEL_SHAPES:
            shape = (2, FRAMES, n, c)
            q, k, v, k2, v2 = (torch.randn(shape, generator=gen, device=device).to(dtype)
                               for _ in range(5))
            mask = (torch.rand((FRAMES, n), generator=gen, device=device) > 0.5).float()
            scale = (c // HEADS) ** -0.5
            if dtype == torch.bfloat16:
                top = max(logit_bound(q, k, HEADS, scale), logit_bound(q, k2, HEADS, scale))
                if top >= LOGIT_CAP:
                    raise AssertionError(f"bf16 inputs reach logit {top} >= {LOGIT_CAP}")
            cases = [
                (("video_flash_attention", mode),
                 lambda m=mode: video_flash_attention(q, k, v, m, scale, HEADS),
                 lambda m=mode: video_flash_attention_plain(q, k, v, m, scale, HEADS))
                for mode in MODES
            ]
            masks = {"binary": mask}
            if dtype == torch.bfloat16:
                masks.update({kind: fg_mask(kind, (FRAMES, n), device, mask_gen)
                              for kind in INJECTION_MASKS if kind != "binary"})
            exact = {kind: tuple(t.float() if kind != "binary" else t for t in (q, k, v, k2, v2))
                     for kind in masks}  # see INJECTION_MASKS
            cases += [
                (("video_injection_attention",
                  "injection" + ("" if kind == "binary" else f" {kind}")),
                 lambda m=m: video_injection_attention(q, k, v, k2, v2, m, scale, HEADS),
                 lambda m=m, x=exact[kind]: video_injection_attention_plain(*x, m, scale, HEADS))
                for kind, m in masks.items()
            ]
            cases.append((("temporal_flash_attention", "causal"),
                          lambda: temporal_flash_attention(q, k, v, scale, HEADS, causal=True),
                          lambda: temporal_flash_attention_plain(q, k, v, scale, HEADS,
                                                                 causal=True)))
            for (name, variant), kernel_fn, plain_fn in cases:
                out = kernel_fn()
                torch.cuda.synchronize()
                ref = plain_fn()
                err = (out.float() - ref.float()).abs().max().item()
                torch.testing.assert_close(out.float(), ref.float(), **tolerance(dtype))
                dt = str(dtype).replace("torch.", "")
                r = results[name]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                main_bf16 = dtype == torch.bfloat16 and n == 4096
                bf16 = dtype == torch.bfloat16
                injection = name == "video_injection_attention"
                lib = ""
                if bf16 and (injection or name == "video_flash_attention"):  # tensor cores
                    lib = scaled_line(r, scaled_error(out, ref))
                if bf16 and ref.dtype == torch.float32:  # the bf16 plain version's own error
                    got = scaled_of(video_injection_attention_plain(
                        q, k, v, k2, v2, masks[variant.split()[1]], scale, HEADS), ref)
                    lib += (f", bf16 plain version vs fp32 max {got['max']:.3e} "
                            f"rms {got['rms']:.3e}")
                reps = KERNEL_REPS if name == "temporal_flash_attention" else 3
                ms, plain_ms = time_ms(kernel_fn, reps), time_ms(plain_fn)
                if bf16 and variant == "injection":
                    # the CUDA-core body on the same bf16 inputs, and SDPA on split-head
                    # views of q against the [K*m | K*(1-m) | K_tgt] keys of every frame
                    # (5N), made before the timing
                    cc_ms = time_ms(cuda_core_injection(q, k, v, k2, v2, mask, ref, scale))
                    m_mf = torch.cat([torch.cat([mask[:1], mask[:-1]]), mask], dim=1)
                    lq, lk, lv, split_ = injection_keys(q, motion_frame_kv(k),
                                                        motion_frame_kv(v), k2, v2, m_mf)
                    lib_ms = library_time(dtype, split_(ref), lambda: library_sdpa(
                        lq, lk, lv, scale=scale))
                    del lq, lk, lv
                    if main_bf16:
                        r.update(cuda_core_ms=cc_ms, library_ms=lib_ms,
                                 library_at=f"bf16 B=2 F={FRAMES} N={n} C={c} injection")
                    lib += f", CUDA-core body {cc_ms:.3f} ms, library {lib_ms:.3f} ms"
                if bf16 and variant == "motion_frame":
                    # the library call gets its layout for free: split-head views of
                    # q against the [f-1 | f] K/V of every frame (the same work: 2N
                    # keys per query frame), made before the timing
                    lq, lk, lv = split(q), split(motion_frame_kv(k)), split(motion_frame_kv(v))
                    lref = split(ref)
                    lib_fn = lambda: library_sdpa(lq, lk, lv, scale=scale)  # noqa: E731
                    lib_ms = library_time(dtype, lref, lib_fn)
                    del lq, lk, lv, lref
                    if main_bf16:
                        r["library_ms"] = lib_ms
                        r["library_at"] = f"bf16 B=2 F={FRAMES} N={n} C={c} {variant}"
                    lib += f", library {lib_ms:.3f} ms"
                if bf16 and (variant == "motion_frame" or injection):  # tensor-core rate
                    b_ = (bound(video_work(name, "injection", q),
                                nbytes(q, k, v, q, k2, v2, mask), dtype) if injection else
                          bound(video_work(name, variant, q), nbytes(q, k, v, q), dtype))
                    lib += (f", {b_['flops'] / ms / 1e9:.1f} TFLOP/s, "
                            f"{100 * b_['bound_ms'] / ms:.1f}% of its bound")
                del out, ref
                log(f"[kernels] {name} {variant} {dt} N={n} C={c}: max_abs_err={err:.3e} "
                    f"kernel {ms:.4f} ms ({reps} launches), plain {plain_ms:.3f} ms{lib}")
                if main_bf16 and variant in ("motion_frame", "injection"):
                    r["ms"], r["plain_ms"] = ms, plain_ms
                    r["at"] = f"bf16 B=2 F={FRAMES} N={n} C={c} {variant}"
                    extra = (k2, v2, mask) if variant == "injection" else ()
                    r.update(bound(video_work(name, variant, q), nbytes(q, k, v, q, *extra),
                                   dtype))
                torch.cuda.empty_cache()
    results.update(phase_split_kernels(device, gen))
    return results


def phase_temporal(device):
    """K3 (the TMA-staged body) at TEMPORAL_SHAPES in bf16 against its plain
    version, with its time, byte bound and share, the plain version's and
    SDPA's (is_causal on [B*N, H, F, d] copies made before the timing) on the
    same inputs; then at the 16x16 sites (TEMPORAL_GATE_SHAPE) the attention
    layer through the kernel against the eager path the gate keeps it on."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as library_sdpa

    from motioneditor_tpu_torch.models.layers import init_params, linear
    from motioneditor_tpu_torch.ops.attention import Attention, temporal_self_attention_video
    from motioneditor_tpu_torch.ops.temporal_flash import (
        temporal_flash_attention,
        temporal_flash_attention_plain,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    r = {}
    dtype = torch.bfloat16

    def temporal(x):  # [B, F, N, C] -> [B*N, H, F, d], a copy
        b, f, n, c = x.shape
        return x.view(b, f, n, HEADS, c // HEADS).permute(0, 2, 3, 1, 4).flatten(0, 1).contiguous()

    for shape in TEMPORAL_SHAPES:
        b, f, n, c = shape
        q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype) for _ in range(3))
        scale = (c // HEADS) ** -0.5
        kernel_fn = lambda: temporal_flash_attention(q, k, v, scale, HEADS)  # noqa: E731
        plain_fn = lambda: temporal_flash_attention_plain(q, k, v, scale, HEADS)  # noqa: E731
        out = kernel_fn()
        torch.cuda.synchronize()
        ref = plain_fn()
        torch.testing.assert_close(out.float(), ref.float(), **tolerance(dtype))
        err = (out.float() - ref.float()).abs().max().item()
        lq, lk, lv = temporal(q), temporal(k), temporal(v)
        lib_fn = lambda: library_sdpa(lq, lk, lv, is_causal=True, scale=scale)  # noqa: E731
        torch.testing.assert_close(lib_fn().float(), temporal(ref).float(), **tolerance(dtype))
        ms = time_ms(kernel_fn, KERNEL_REPS)
        plain_ms, lib_ms = time_ms(plain_fn, 20), time_ms(lib_fn, 20)
        b_ = bound(video_work("temporal_flash_attention", "causal", q), nbytes(q, k, v, q), dtype)
        at = f"bf16 B={b} F={f} N={n} C={c} causal"
        log(f"[temporal] K3 {at}: max_abs_err={err:.3e} kernel {ms:.4f} ms ({KERNEL_REPS} "
            f"launches), byte bound {b_['bound_ms']:.4f} ms, "
            f"{100 * b_['bound_ms'] / ms:.1f}% of it; plain {plain_ms:.3f} ms; "
            f"SDPA is_causal {lib_ms:.4f} ms")
        if shape == TEMPORAL_SHAPES[0]:
            r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, at=at,
                     library_at=f"{at}, SDPA is_causal on [B*N, H, F, d]", **b_)
        else:
            r[f"ms_{b}x{n}x{c}"] = ms
            r[f"bound_ms_{b}x{n}x{c}"] = b_["bound_ms"]
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        del q, k, v, out, ref, lq, lk, lv
        torch.cuda.empty_cache()

    # the 16x16 sites: projections + K3 + output projection against the eager
    # path (temporal_self_attention on [B, N, F, C]) that N < 512 takes
    b, f, n, c = TEMPORAL_GATE_SHAPE
    attn = Attention(c, heads=HEADS).to(device)
    init_params(attn, gen)
    attn = attn.to(dtype)
    x = torch.randn(TEMPORAL_GATE_SHAPE, generator=gen, device=device).to(dtype)

    def through_kernel():
        qkv = [linear(m, x) for m in (attn.to_q, attn.to_k, attn.to_v)]
        return linear(attn.to_out[0], temporal_flash_attention(*qkv, (c // HEADS) ** -0.5,
                                                               HEADS))

    def eager():
        return temporal_self_attention_video(attn, x, HEADS)

    with torch.no_grad():
        got = through_kernel()
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), eager().float(), **tolerance(dtype))
        kernel_ms, eager_ms = time_ms(through_kernel, 50), time_ms(eager, 50)
    at = f"bf16 B={b} F={f} N={n} C={c}"
    log(f"[temporal] the 16x16 sites' layer, {at}: through K3 {kernel_ms:.4f} ms, eager path "
        f"(the gate's choice at N < 512) {eager_ms:.4f} ms (50 launches each)")
    r["gate_16x16"] = {"at": at, "through_kernel_ms": kernel_ms, "eager_ms": eager_ms}
    return r


def cuda_core_injection(q, k, v, k2, v2, mask, ref, scale, m=None):
    """A launch of K2's CUDA-core body (K13's with ``m``, the source
    tokens per frame) on the given inputs, called directly for its time
    beside the tensor-core body's; its output is first held to ``ref``."""
    import torch

    from motioneditor_tpu_torch import _build

    lib, stream = _build.kernels(), _build.stream_handle(q.device)
    out = torch.empty_like(q)
    b, f, n, c = q.shape
    ptrs = [t.data_ptr() for t in (q, k, v, k2, v2, mask, out)]
    dtype = _build.DTYPE_CODES[q.dtype]

    def launch():
        if m is None:
            code = lib.me_video_attention(*ptrs, b, f, n, HEADS, c // HEADS, float(scale), 4,
                                          dtype, stream)
        else:
            code = lib.me_video_attention_kv(*ptrs, b, f, n, f, m, HEADS, c // HEADS,
                                             float(scale), 1, dtype, stream)
        _build.check_status("CUDA-core injection", code)

    launch()
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **tolerance(q.dtype))
    return launch


def cuda_core_split_injection(q, k, v, mask, kt, vt, ref, scale):
    """A launch of K9's CUDA-core body (csrc/split_attention.cu, mode 1) on
    the given [B, F, H, N, d] inputs, called directly for its time beside the
    tensor-core body's; its output is first held to ``ref``."""
    import ctypes

    import torch

    from motioneditor_tpu_torch import _build

    lib, stream = _build.kernels(), _build.stream_handle(q.device)
    views = [t.flatten(0, 1) for t in (q, k, v, kt, vt)]
    out = torch.empty_like(views[0])
    strides = (ctypes.c_longlong * 18)(*(s for x in (*views, out) for s in x.stride()[:3]))
    g, h, nq, d = views[0].shape
    ptrs = [*(t.data_ptr() for t in views), mask.data_ptr(), out.data_ptr()]

    def launch():
        code = lib.me_split_attention(*ptrs, strides, g, h, nq, k.shape[-2], kt.shape[-2],
                                      q.shape[1], d, float(scale), 1,
                                      _build.DTYPE_CODES[q.dtype], stream)
        _build.check_status("CUDA-core split-head injection", code)

    launch()
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.flatten(0, 1).float(), **tolerance(q.dtype))
    return launch


def phase_split_kernels(device, gen):
    """K8 and K9 against their plain versions at the auto path's shapes; in
    bf16 both take the tensor-core body (K9 its injection instantiation,
    also with the fractional and mixed fg masks of INJECTION_MASKS, held to
    the plain version in fp32), and K9's CUDA-core body is timed on the
    same inputs by a direct call."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as library_sdpa

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from motioneditor_tpu_torch.ops.injection_flash import (
        fused_injection_attention,
        fused_injection_attention_plain,
    )

    mask_gen = torch.Generator(device=device).manual_seed(SEED + 9)
    results = {name: {"max_abs_err": 0.0} for name in SPLIT_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        bf16 = dtype == torch.bfloat16
        for n, d in AUTO_SHAPES:
            lead = (2, FRAMES, HEADS)
            q, kt, vt = (torch.randn((*lead, n, d), generator=gen, device=device).to(dtype)
                         for _ in range(3))
            k, v = (torch.randn((*lead, 2 * n, d), generator=gen, device=device).to(dtype)
                    for _ in range(2))
            mask = (torch.rand((FRAMES, 2 * n), generator=gen, device=device) > 0.5).float()
            scale = d ** -0.5
            if bf16:
                b_ = max(split_logit_bound(q, k, scale), split_logit_bound(q, kt, scale))
                if b_ >= LOGIT_CAP:
                    raise AssertionError(f"bf16 inputs reach logit {b_} >= {LOGIT_CAP}")
            main = bf16 and n == 4096
            at = f"{dt} q [2, {FRAMES}, {HEADS}, {n}, {d}], 2N source keys"
            masks = {"binary": mask}
            if bf16:
                masks.update({kind: fg_mask(kind, (FRAMES, 2 * n), device, mask_gen)
                              for kind in INJECTION_MASKS if kind != "binary"})
            cases = [("flash_attention", "", lambda: flash_attention(q, k, v, scale),
                      lambda: flash_attention_plain(q, k, v, scale),
                      4.0 * q.numel() * 2 * n, nbytes(q, k, v, q))]
            for kind, m in masks.items():
                # see INJECTION_MASKS: the fractional and mixed masks against fp32
                x = (q, k, v, kt, vt) if kind == "binary" else tuple(
                    t.float() for t in (q, k, v, kt, vt))
                cases.append((
                    "fused_injection_attention", kind,
                    lambda m=m: fused_injection_attention(q, k, v, m, kt, vt, scale),
                    lambda m=m, x=x: fused_injection_attention_plain(*x[:3], m, *x[3:], scale),
                    4.0 * q.numel() * 3 * n, nbytes(q, k, v, m, kt, vt, q)))
            for name, kind, kernel_fn, plain_fn, flops, moved in cases:
                tc_before = _build.launch_counts[f"{name}.tc"]
                out = kernel_fn()
                torch.cuda.synchronize()
                if _build.launch_counts[f"{name}.tc"] != tc_before + int(bf16):
                    raise AssertionError(f"{name} in {dt}: tensor-core launches "
                                         f"{_build.launch_counts[f'{name}.tc'] - tc_before}, "
                                         f"expected {int(bf16)}")
                ref = plain_fn()
                err = (out.float() - ref.float()).abs().max().item()
                torch.testing.assert_close(out.float(), ref.float(), **tolerance(dtype))
                r = results[name]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                lib = scaled_line(r, scaled_error(out, ref)) if bf16 else ""  # tensor cores
                if bf16 and ref.dtype == torch.float32:  # the bf16 plain version's own error
                    got = scaled_of(fused_injection_attention_plain(
                        q, k, v, masks[kind], kt, vt, scale), ref)
                    lib += (f", bf16 plain version vs fp32 max {got['max']:.3e} "
                            f"rms {got['rms']:.3e}")
                ms, plain_ms = time_ms(kernel_fn), time_ms(plain_fn)
                if kind in ("", "binary"):
                    if name == "flash_attention":
                        lib_fn = lambda: library_sdpa(  # noqa: E731
                            q.flatten(0, 1), k.flatten(0, 1), v.flatten(0, 1), scale=scale)
                    else:
                        # SDPA over the 5N injected keys [K*m | K*(1-m) | K_tgt] against
                        # [V | V | V_tgt] of each (batch, frame), built before the timing
                        # (the mask is binary, so K*m is exact in bf16)
                        m5 = mask[None, :, None, :, None].to(dtype)
                        k_inj = torch.cat([k * m5, k * (1.0 - m5), kt], dim=-2).flatten(0, 1)
                        v_inj = torch.cat([v, v, vt], dim=-2).flatten(0, 1)
                        lib_fn = lambda: library_sdpa(  # noqa: E731
                            q.flatten(0, 1), k_inj, v_inj, scale=scale)
                    lib_ms = library_time(dtype, ref.flatten(0, 1), lib_fn)
                    lib += f", library {lib_ms:.3f} ms"
                    del lib_fn
                    if main:
                        r["library_ms"] = lib_ms
                        r["library_at"] = at if name == "flash_attention" else (
                            f"{at}; SDPA over the 5N keys [K*m | K*(1-m) | K_tgt]")
                    elif bf16:
                        r["library_ms_32x32"] = lib_ms
                if bf16 and kind == "binary":
                    cc_ms = time_ms(cuda_core_split_injection(q, k, v, mask, kt, vt, ref, scale))
                    lib += f", CUDA-core body {cc_ms:.3f} ms"
                    r["cuda_core_ms" if main else "cuda_core_ms_32x32"] = cc_ms
                if bf16:  # tensor-core rate
                    b_ = bound(flops, moved, dtype)
                    lib += (f", {flops / ms / 1e9:.1f} TFLOP/s, "
                            f"{100 * b_['bound_ms'] / ms:.1f}% of its bound")
                del out, ref
                log(f"[kernels] {name}{' ' + kind if kind else ''} {at}: max_abs_err={err:.3e} "
                    f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{lib}")
                if main and kind in ("", "binary"):
                    r.update(ms=ms, plain_ms=plain_ms, at=at, **bound(flops, moved, dtype))
                elif main:
                    r[f"ms_{kind}"] = ms
                elif bf16 and kind in ("", "binary"):
                    r["ms_32x32"] = ms
                torch.cuda.empty_cache()
            del q, k, v, kt, vt, mask, masks, cases
            torch.cuda.empty_cache()
    return results


def grad_error(got, ref, dtype) -> float:
    """Max |got - ref| over gradients; raises beyond the tolerance of
    tests/test_video_flash_bwd.py: fp32 rtol 1e-4, atol 1e-3; bf16 max error
    relative to the max |ref| < 0.06."""
    import torch

    err = 0.0
    for a, b in zip(got, ref):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            raise AssertionError("gradient is not finite")
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
        elif (a - b).abs().max() / (b.abs().max() + 1e-6) >= 0.06:
            raise AssertionError(f"bf16 gradient off by {(a - b).abs().max().item()}")
        err = max(err, (a - b).abs().max().item())
    return err


def plain_autograd(fn, xs, do):
    """Gradients of the plain forward ``fn`` for the output gradient ``do``."""
    import torch

    xs = [x.detach().requires_grad_() for x in xs]
    return torch.autograd.grad(fn(*xs), xs, do)


def phase_bwd_kernels(device):
    """The backward kernels against their plain versions at the null-text
    shapes."""
    import torch

    from motioneditor_tpu_torch.ops.temporal_flash import (
        temporal_flash_attention_bwd,
        temporal_flash_attention_bwd_plain,
        temporal_flash_attention_plain,
    )
    from motioneditor_tpu_torch.ops.video_flash import video_flash_attention_plain
    from motioneditor_tpu_torch.ops.video_flash_bwd import (
        _delta,
        combine_partials,
        video_flash_bwd_dkv,
        video_flash_bwd_dkv_plain,
        video_flash_bwd_dq,
        video_flash_bwd_plain,
        video_flash_fwd_res,
        video_flash_fwd_res_plain,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    results = {name: {"max_abs_err": 0.0} for name in BACKWARD_KERNELS}

    def record(name, err, ms, plain_ms, main_case, at, flops, moved, small_case=False):
        """Keeps the largest error and the numbers of the main case (and of
        the 32x32 sites' case, ``small_case``); returns the rate and the
        share of the bound for the log."""
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        b = bound(flops, moved, dtype)
        if main_case:
            r.update(ms=ms, plain_ms=plain_ms, at=at, **b)
        if small_case:
            r.update(ms_32x32=ms, bound_ms_32x32=b["bound_ms"], at_32x32=at)
        return (f", {name.removeprefix('video_flash_')} {b['flops'] / ms / 1e9:.1f} TFLOP/s, "
                f"{100 * b['bound_ms'] / ms:.1f}% of its bound")

    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        for n, c in KERNEL_SHAPES:
            q, k, v, do = (torch.randn((1, FRAMES, n, c), generator=gen, device=device).to(dtype)
                           for _ in range(4))
            scale = (c // HEADS) ** -0.5
            if dtype == torch.bfloat16 and logit_bound(q, k, HEADS, scale) >= LOGIT_CAP:
                raise AssertionError(f"bf16 inputs reach logit >= {LOGIT_CAP}")
            for mode in BWD_MODES:
                main_case = dtype == torch.bfloat16 and n == 4096 and mode == "motion_frame"
                small_case = dtype == torch.bfloat16 and n == 1024 and mode == "motion_frame"
                at = f"{dt} B=1 F={FRAMES} N={n} C={c} {mode}"
                fwd = lambda: video_flash_fwd_res(q, k, v, mode, scale, HEADS)  # noqa: E731
                fwd_plain = lambda: video_flash_fwd_res_plain(  # noqa: E731
                    q, k, v, mode, scale, HEADS)
                out, lse = fwd()
                torch.cuda.synchronize()
                out_ref, lse_ref = fwd_plain()
                torch.testing.assert_close(out.float(), out_ref.float(), **tolerance(dtype))
                torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
                err = max((out.float() - out_ref.float()).abs().max().item(),
                          (lse - lse_ref).abs().max().item())
                tc_line = ""
                if dtype == torch.bfloat16:  # K4's tensor-core body: its output, scaled
                    tc_line = scaled_line(results["video_flash_fwd_res"],
                                          scaled_error(out, out_ref))
                del out, lse
                ms_fwd, plain_fwd_ms = time_ms(fwd), time_ms(fwd_plain)
                # the forward's 2 products per (query, key, head); dq recomputes S and
                # forms dP and dQ (3), dk/dv form S, dP, dV and dK (4)
                work = video_work("video_flash_attention", mode, q)
                lse_bytes = nbytes(lse_ref)
                tc_line += record("video_flash_fwd_res", err, ms_fwd, plain_fwd_ms, main_case, at,
                                  work, nbytes(q, k, v, q) + lse_bytes, small_case)

                dq_fn = lambda: video_flash_bwd_dq(  # noqa: E731
                    q, k, v, out_ref, lse_ref, do, mode, scale, HEADS)
                dq, delta = dq_fn()
                dkv_fn = lambda: video_flash_bwd_dkv(  # noqa: E731
                    q, k, v, lse_ref, delta, do, mode, scale, HEADS)
                dkp, dvp = dkv_fn()
                torch.cuda.synchronize()
                if dtype == torch.bfloat16:
                    # K5's tensor-core body: dQ against the fp32 plain dQ of the same bf16
                    # residuals, and its delta against the plain rowsum(dO o O)
                    plain_delta = _delta(out_ref, do, HEADS)
                    torch.testing.assert_close(delta, plain_delta, atol=1e-5, rtol=1e-5)
                    dq_ref = video_flash_bwd_plain(*(t.float() for t in (q, k, v, out_ref)),
                                                   lse_ref, do.float(), mode, scale, HEADS)[0]
                    tc_line += scaled_line(results["video_flash_bwd_dq"],
                                           scaled_error(dq, dq_ref))
                    del dq_ref
                    # K6's tensor-core body: its partials as they are, against partials
                    # from the plain delta
                    refs = video_flash_bwd_dkv_plain(q, k, v, lse_ref, plain_delta,
                                                     do, mode, scale, HEADS)
                    worst = {"max": 0.0, "rms": 0.0}
                    for part, ref_part in zip((dkp, dvp), refs):
                        for key, value in scaled_error(part, ref_part).items():
                            worst[key] = max(worst[key], value)
                    tc_line += scaled_line(results["video_flash_bwd_dkv"], worst)
                    del refs, plain_delta
                got = (dq, combine_partials(dkp, mode).to(dtype),
                       combine_partials(dvp, mode).to(dtype))
                del dkp, dvp
                bwd_plain = lambda: video_flash_bwd_plain(  # noqa: E731
                    q, k, v, out_ref, lse_ref, do, mode, scale, HEADS)
                err_plain = grad_error(got, bwd_plain(), dtype)
                err_auto = grad_error(got, plain_autograd(
                    lambda *t: video_flash_attention_plain(*t, mode, scale, HEADS), (q, k, v), do),
                    dtype)
                del got, dq
                torch.cuda.empty_cache()
                ms_dq, ms_dkv, plain_ms = time_ms(dq_fn), time_ms(dkv_fn), time_ms(bwd_plain)
                auto_ms = time_ms(lambda: plain_autograd(
                    lambda *t: video_flash_attention_plain(*t, mode, scale, HEADS), (q, k, v), do))
                tc_line += record("video_flash_bwd_dq", max(err_plain, err_auto), ms_dq,
                                  plain_ms, main_case, at, 1.5 * work,
                                  nbytes(q, k, v, q, do, q) + 2 * lse_bytes, small_case)
                slots = 1 if mode == "normal" else 2  # fp32 dk / dv partials per source slot
                tc_line += record("video_flash_bwd_dkv", max(err_plain, err_auto), ms_dkv,
                                  plain_ms, main_case, at, 2.0 * work,
                                  nbytes(q, k, v, do) + 2 * lse_bytes
                                  + 2 * slots * q.numel() * 4, small_case)
                log(f"[bwd] {at}: max_abs_err fwd_res {err:.3e}, bwd vs plain {err_plain:.3e}, "
                    f"vs autograd {err_auto:.3e}; fwd_res {ms_fwd:.3f} ms (plain "
                    f"{plain_fwd_ms:.3f}), dq {ms_dq:.3f} ms, dkv {ms_dkv:.3f} ms, plain bwd "
                    f"{plain_ms:.3f} ms, plain fwd+bwd by autograd {auto_ms:.3f} ms{tc_line}")
                del out_ref, lse_ref, delta
                torch.cuda.empty_cache()

            at = f"{dt} B=1 F={FRAMES} N={n} C={c} causal"
            k7 = lambda: temporal_flash_attention_bwd(q, k, v, do, scale, HEADS)  # noqa: E731
            k7_plain = lambda: temporal_flash_attention_bwd_plain(  # noqa: E731
                q, k, v, do, scale, HEADS)
            got = k7()
            torch.cuda.synchronize()
            err = max(grad_error(got, k7_plain(), dtype), grad_error(got, plain_autograd(
                lambda *t: temporal_flash_attention_plain(*t, scale, HEADS), (q, k, v), do),
                dtype))
            del got
            ms, plain_ms = time_ms(k7, KERNEL_REPS), time_ms(k7_plain, 20)
            share = record("temporal_flash_attention_bwd", err, ms, plain_ms,
                           dtype == torch.bfloat16 and n == 4096, at,
                           2.5 * video_work("temporal_flash_attention", "causal", q),
                           7 * nbytes(q))
            log(f"[bwd] temporal {at}: max_abs_err {err:.3e}; kernel {ms:.4f} ms "
                f"({KERNEL_REPS} launches), plain {plain_ms:.3f} ms, byte bound "
                f"{7 * nbytes(q) / PEAK_BYTES * 1e3:.4f} ms{share}")
            del q, k, v, do
            torch.cuda.empty_cache()
    return results


def build_models(config, cn_config, device, dtype, seed: int):
    import torch

    from motioneditor_tpu_torch.models.controlnet import ControlNetModel
    from motioneditor_tpu_torch.models.layers import init_params
    from motioneditor_tpu_torch.models.unet import UNet3DConditionModel

    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        unet = UNet3DConditionModel(config)
        cn = ControlNetModel(cn_config)
    init_params(unet, gen)
    init_params(cn, gen)
    return unet.to(dtype).eval(), cn.to(dtype).eval()


def phase_slice(device):
    """The full-width injected denoise segment, bf16, with launch counts."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.control.injection import (
        InjectionSpec,
        prepare_injection_masks,
    )
    from motioneditor_tpu_torch.models.controlnet import (
        controlnet_config,
        precompute_cond_embedding,
    )
    from motioneditor_tpu_torch.models.unet import UNetConfig
    from motioneditor_tpu_torch.pipelines.editor import denoise_segment
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    dtype = torch.bfloat16
    config, cn_config = UNetConfig(), controlnet_config()
    t0 = time.perf_counter()
    unet, cn = build_models(config, cn_config, device, dtype, SEED)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    lat = torch.randn((2, FRAMES, LATENT, LATENT, 4), generator=gen, device=device).to(dtype)
    cond = torch.randn((2, 77, 768), generator=gen, device=device).to(dtype)
    uncond = torch.randn((2, 77, 768), generator=gen, device=device).to(dtype)
    image = torch.rand((2, FRAMES, 8 * LATENT, 8 * LATENT, 3), generator=gen,
                       device=device).to(dtype)
    with torch.no_grad():
        cond_emb = precompute_cond_embedding(cn, image)
    masks = {k: m.to(dtype) for k, m in prepare_injection_masks(
        torch.ones((FRAMES, LATENT, LATENT), device=device), FRAMES).items()}
    schedule = DiffusionSchedule()
    all_ts = schedule.inference_timesteps(50)
    spec = InjectionSpec.from_start_layer(10)
    torch.cuda.synchronize()
    log(f"[slice] models + inputs ready in {time.perf_counter() - t0:.1f} s")

    def run(ts):
        return denoise_segment(unet, config, cn, cn_config, schedule, 50, spec, 7.5, 1.0,
                               lat, ts, cond, uncond, cond_emb, masks)

    run(all_ts[4:5])  # warm-up step (cuDNN / cuBLAS plans, allocator)
    torch.cuda.synchronize()
    steps = all_ts[4:7]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = run(steps)
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) * 1e3 / len(steps)
    launches = dict(_build.launch_counts)
    log(f"[slice] {len(steps)} steps, {ms_per_step:.1f} ms/step, launches {launches}")
    if out.shape != lat.shape or out.dtype != dtype:
        raise AssertionError(f"slice output {tuple(out.shape)} {out.dtype}")
    if not torch.isfinite(out).all():
        raise AssertionError("slice output is not finite")
    for name, per_step in EXPECTED_PER_STEP.items():
        if launches.get(name, 0) != per_step * len(steps):
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches, expected "
                                 f"{per_step} per step x {len(steps)}")
    prof = profile_step(lambda: run(all_ts[4:5]))
    log(f"[slice] one more step under torch.profiler: {json.dumps(prof)}")
    del unet, cn, out
    torch.cuda.empty_cache()
    return launches, ms_per_step, prof


def build_tiny_models(device, seed: int):
    """A tiny fp32 UNet + ControlNet whose 32x32 level-0 attention (N = 1024)
    reaches the kernels, all weights random (zero-init modules too, so they
    take part)."""
    import torch
    from torch import nn

    from motioneditor_tpu_torch.models.controlnet import controlnet_config
    from motioneditor_tpu_torch.models.unet import UNetConfig

    config = UNetConfig(block_out_channels=(32, 64, 64, 64), norm_num_groups=8,
                        attention_heads=4, cross_attention_dim=16)
    cn_config = controlnet_config(config)
    unet, cn = build_models(config, cn_config, device, torch.float32, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    with torch.no_grad():
        for m in list(unet.modules()) + list(cn.modules()):
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                bound = m.weight[0].numel() ** -0.5
                for p in m.parameters(recurse=False):
                    p.uniform_(-bound, bound, generator=gen)
    return config, cn_config, unet, cn, gen


def phase_check(device):
    """Tiny fp32 segment (32x32 latents: level-0 attention at N = 1024 reaches
    the kernels), kernel path against the plain path, all weights random."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.control.injection import InjectionSpec
    from motioneditor_tpu_torch.models.controlnet import precompute_cond_embedding
    from motioneditor_tpu_torch.pipelines.editor import denoise_segment
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    config, cn_config, unet, cn, gen = build_tiny_models(device, SEED + 2)
    f, hw = 3, 32
    lat = 0.3 * torch.randn((2, f, hw, hw, 4), generator=gen, device=device)
    cond = 0.3 * torch.randn((2, 7, 16), generator=gen, device=device)
    uncond = 0.3 * torch.randn((2, 7, 16), generator=gen, device=device)
    image = torch.rand((2, f, 8 * hw, 8 * hw, 3), generator=gen, device=device)
    masks = {(s, s): (torch.rand((f, s * s, 1), generator=gen, device=device) > 0.5).float()
             for s in (32, 16, 8, 4)}
    with torch.no_grad():
        cond_emb = precompute_cond_embedding(cn, image)
    schedule = DiffusionSchedule()
    ts = schedule.inference_timesteps(50)[4:6]
    outs = {}
    for use_flash in (True, False):
        _build.reset_launch_counts()
        outs[use_flash] = denoise_segment(
            unet, config, cn, cn_config, schedule, 50, InjectionSpec.from_start_layer(10),
            7.5, 1.0, lat, ts, cond, uncond, cond_emb, masks, use_flash=use_flash)
        torch.cuda.synchronize()
        if use_flash and not all(_build.launch_counts[k] for k in FORWARD_KERNELS):
            raise AssertionError(f"kernel path skipped a kernel: {_build.launch_counts}")
    err = (outs[True] - outs[False]).abs().max().item()
    log(f"[check] 2-step fp32 segment, kernel vs plain path: max_abs_err={err:.3e}")
    if not torch.isfinite(outs[True]).all() or err > 2e-3:
        raise AssertionError(f"kernel path disagrees with the plain path: {err}")


def phase_null_check(device):
    """Tiny fp32 null-text inversion (2 steps, 2 inner steps, the early stop
    off so both run), kernel path against the plain path."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.pipelines.editor import null_text_inversion
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    config, _, unet, _, gen = build_tiny_models(device, SEED + 6)
    lat = 0.3 * torch.randn((1, 3, 32, 32, 4), generator=gen, device=device)
    cond = 0.3 * torch.randn((1, 7, 16), generator=gen, device=device)
    uncond0 = 0.3 * torch.randn((1, 7, 16), generator=gen, device=device)
    outs = {}
    for use_flash in (True, False):
        _build.reset_launch_counts()
        outs[use_flash] = null_text_inversion(
            unet, config, DiffusionSchedule(), lat, cond, uncond0, num_steps=2, inner_steps=2,
            early_stop_epsilon=-1.0, use_flash=use_flash)
        torch.cuda.synchronize()
        launched = dict(_build.launch_counts)
        if use_flash:
            needed = ("video_flash_attention", "temporal_flash_attention") + BACKWARD_KERNELS
            if not all(launched.get(k) for k in needed):
                raise AssertionError(f"kernel path skipped a kernel: {launched}")
            log(f"[null-check] kernel path launches {launched}")
        elif launched:
            raise AssertionError(f"plain path launched kernels: {launched}")
    (x_k, u_k), (x_p, u_p) = outs[True], outs[False]
    err_x = (x_k - x_p).abs().max().item()
    err_u = (u_k - u_p).abs().max().item()
    log(f"[null-check] 2-step fp32 null-text, kernel vs plain path: x_T max_abs_err="
        f"{err_x:.3e}, uncond max_abs_err={err_u:.3e}")
    finite = torch.isfinite(x_k).all() and torch.isfinite(u_k).all()
    if not finite or err_x > 2e-3 or err_u > 2e-3:
        raise AssertionError(f"kernel path disagrees with the plain path: {err_x}, {err_u}")


def expect_counts(phase: str, launches: dict, per_step: dict, steps: int) -> None:
    """The launches of a run must be ``per_step`` x steps, and no other."""
    want = {k: n * steps for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches}, expected {want}")


def phase_null_text(device):
    """Null-text inversion and the edit with per-step uncond embeddings at
    full width, bf16, batch 1, with launch counts per step."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.control.injection import (
        InjectionSpec,
        prepare_injection_masks,
    )
    from motioneditor_tpu_torch.models.controlnet import (
        controlnet_config,
        precompute_cond_embedding,
    )
    from motioneditor_tpu_torch.models.unet import UNetConfig
    from motioneditor_tpu_torch.pipelines.editor import (
        ddim_invert,
        denoise_segment,
        null_optimization,
        null_text_inversion,
    )
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    dtype = torch.bfloat16
    config, cn_config = UNetConfig(), controlnet_config()
    unet, cn = build_models(config, cn_config, device, dtype, SEED)
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    lat = torch.randn((1, FRAMES, LATENT, LATENT, 4), generator=gen, device=device).to(dtype)
    cond = torch.randn((1, 77, 768), generator=gen, device=device)
    uncond0 = torch.randn((1, 77, 768), generator=gen, device=device)
    image = torch.rand((2, FRAMES, 8 * LATENT, 8 * LATENT, 3), generator=gen,
                       device=device).to(dtype)
    with torch.no_grad():
        cond_emb = precompute_cond_embedding(cn, image)
    masks = {k: m.to(dtype) for k, m in prepare_injection_masks(
        torch.ones((FRAMES, LATENT, LATENT), device=device), FRAMES).items()}
    schedule = DiffusionSchedule()
    opt = dict(inner_steps=1, base_lr=1e-2, guidance_scale=7.5, compute_dtype="bfloat16")
    # warm-up through the entry point: one inversion and one null-text step
    null_text_inversion(unet, config, schedule, lat, cond, uncond0, num_steps=1, **opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings, paths = {}, {}

    def timed(phase, steps, fn):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        timings[phase] = (time.perf_counter() - t0) * 1e3 / steps
        paths[phase] = dict(_build.launch_counts)
        log(f"[null] {phase}: {steps} steps, {timings[phase]:.1f} ms/step, "
            f"launches {paths[phase]}")
        return out

    x_t, all_lat = timed("inversion", NULL_STEPS, lambda: ddim_invert(
        unet, config, schedule, lat, cond, NULL_STEPS, normal_infer=False))
    uncond = timed("null_text", NULL_STEPS, lambda: null_optimization(
        unet, config, schedule, all_lat, cond, uncond0, NULL_STEPS, opt["inner_steps"],
        opt["base_lr"], opt["guidance_scale"], compute_dtype=opt["compute_dtype"]))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    ts = schedule.inference_timesteps(NULL_STEPS)

    def edit(lo, hi):
        return denoise_segment(
            unet, config, cn, cn_config, schedule, NULL_STEPS, InjectionSpec.from_start_layer(10),
            7.5, 1.0, torch.cat([x_t, x_t]), ts[lo:hi], cond.to(dtype).expand(2, -1, -1), None,
            cond_emb, masks, seg_uncond=uncond[lo:hi])

    edit(NULL_STEPS - 2, NULL_STEPS - 1)  # warm-up step of the batch-4 edit
    out = timed("edit", 2, lambda: edit(NULL_STEPS - 2, NULL_STEPS))
    log(f"[null] peak memory of inversion + null-text: {peak_gb:.2f} GiB")
    if x_t.shape != lat.shape or uncond.shape != (NULL_STEPS, 1, 77, 768):
        raise AssertionError(f"shapes {tuple(x_t.shape)}, {tuple(uncond.shape)}")
    if uncond.dtype != torch.float32 or out.shape != (2, *lat.shape[1:]):
        raise AssertionError(f"uncond {uncond.dtype}, edit {tuple(out.shape)}")
    for name, t in (("x_T", x_t), ("uncond", uncond), ("edit", out)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name} is not finite")
    if torch.equal(uncond[0], uncond0[0]):
        raise AssertionError("null-text optimization left the embedding unchanged")
    expect_counts("inversion", paths["inversion"], EXPECTED_PER_INVERSION_STEP, NULL_STEPS)
    expect_counts("null_text", paths["null_text"], EXPECTED_PER_NULL_STEP, NULL_STEPS)
    expect_counts("edit", paths["edit"], EXPECTED_PER_STEP, 2)
    del unet, cn, out
    torch.cuda.empty_cache()
    return paths, {"inversion_ms_per_step": timings["inversion"],
                   "null_text_ms_per_step": timings["null_text"],
                   "edit_ms_per_step": timings["edit"], "null_text_peak_gib": peak_gb}


def scaled(counts: dict, steps: int) -> dict:
    return {k: n * steps for k, n in counts.items()}


def add_counts(*counts: dict) -> dict:
    out: dict = {}
    for c in counts:
        for k, n in c.items():
            out[k] = out.get(k, 0) + n
    return out


def pipeline_models(device, dtype, gen):
    """The VAE and the CLIP text encoder at full width, random from ``gen``."""
    import torch

    from motioneditor_tpu_torch.models.clip_text import CLIPTextModel
    from motioneditor_tpu_torch.models.layers import init_params
    from motioneditor_tpu_torch.models.vae import AutoencoderKL

    with torch.device(device):
        vae, text = AutoencoderKL(), CLIPTextModel()
    for m in (vae, text):
        init_params(m, gen)
        m.to(dtype).eval()
    return vae, text


PIPE_PROMPTS = ["a man is dancing", "a man is jumping"]


def run_pipeline(pipe, gen, seed: int, tag: str, barrier=lambda: None):
    """MotionEditorPipeline from frames to frames at full width on a clip
    drawn from ``gen``: encode_video -> null_text_inversion -> the edit (mask
    mode) -> decode on PIPE_STEPS steps from PIPE_START, each part timed
    (every rank starting and ending together) and its launches read. Checks
    a finite video in [0, 1]; returns (metrics, launches by part, the run's
    inputs and outputs: the source video in [-1, 1], skeleton, masks, x_T,
    the null-text embeddings, the edited latents and the decoded video)."""
    import torch

    from motioneditor_tpu_torch import _build

    device, dtype = pipe.device, pipe.dtype
    size = 8 * LATENT
    video = (torch.rand((1, FRAMES, size, size, 3), generator=gen, device=device) * 2 - 1)
    skeleton = torch.rand((FRAMES, size, size, 3), generator=gen, device=device)
    masks = torch.zeros((FRAMES, size, size), device=device)
    masks[:, size // 4: 3 * size // 4, size // 3: 2 * size // 3] = 1.0  # the protagonist's box
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, paths = {}, {}

    def timed(part, fn, path=None):
        _build.reset_launch_counts()
        ms, out = timed_steps(fn, 1, barrier)
        times[part] = ms
        if path is not None:
            paths[path] = dict(_build.launch_counts)
        return out

    t_run = time.perf_counter()
    timed("prompt_encode_ms", lambda: pipe.encode_prompt(PIPE_PROMPTS))
    latents = timed("vae_encode_ms", lambda: pipe.encode_video(
        video.to(dtype), generator=torch.Generator(device=device).manual_seed(seed)))
    x_t, uncond = timed("null_text_inversion_ms", lambda: pipe.null_text_inversion(
        latents, PIPE_PROMPTS[0], num_steps=PIPE_STEPS), f"{tag}_inversion")
    lat = timed("edit_ms", lambda: pipe(
        PIPE_PROMPTS, torch.cat([x_t, x_t]), skeleton, source_masks=masks,
        uncond_embeddings=uncond, num_inference_steps=PIPE_STEPS, start_step=PIPE_START,
        decode=False), f"{tag}_edit")
    out = timed("vae_decode_ms", lambda: pipe.decode_latents(lat))
    metrics = {k: v for k, v in times.items() if k.endswith("ms")}
    metrics.update(
        inversion_null_text_ms_per_step=times["null_text_inversion_ms"] / PIPE_STEPS,
        edit_ms_per_step=times["edit_ms"] / PIPE_STEPS, run_s=time.perf_counter() - t_run,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if out.shape != (2, FRAMES, size, size, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"{tag} output {tuple(out.shape)} is not a finite video")
    if out.min() < 0 or out.max() > 1:
        raise AssertionError(f"{tag} output leaves [0, 1]")
    state = dict(video=video, skeleton=skeleton, masks=masks, x_t=x_t, uncond=uncond, lat=lat,
                 out=out)
    return metrics, paths, state


P2P_PROMPTS = ["a girl is dancing", "a man is dancing"]  # make_controller picks replace
P2P_WORDS = ["man"]  # LocalBlend's words


def p2p_control(tokenizer, steps: int = PIPE_STEPS):
    """The replace controller and the LocalBlend of phase 12 for P2P_PROMPTS."""
    from motioneditor_tpu_torch.control.p2p import make_controller, make_local_blend

    controller = make_controller(P2P_PROMPTS, tokenizer, steps)
    if controller.kind != "replace":
        raise AssertionError(f"make_controller picked {controller.kind} for {P2P_PROMPTS}")
    return controller, make_local_blend(P2P_PROMPTS, [P2P_WORDS] * 2, tokenizer)


def run_edit(pipe, state, p2p: bool, barrier=lambda: None):
    """The edit of run_pipeline's inputs (x_T, the null-text embeddings, the
    skeleton and masks) with P2P_PROMPTS, under the p2p controller and
    LocalBlend when ``p2p``: (ms per step, its launches, the latents)."""
    import torch

    from motioneditor_tpu_torch import _build

    control = {}
    if p2p:
        control = dict(zip(("p2p_controller", "local_blend"), p2p_control(pipe.tokenizer)))
    _build.reset_launch_counts()
    ms, lat = timed_steps(lambda: pipe(
        P2P_PROMPTS, torch.cat([state["x_t"], state["x_t"]]), state["skeleton"],
        source_masks=state["masks"], uncond_embeddings=state["uncond"],
        num_inference_steps=PIPE_STEPS, start_step=PIPE_START, decode=False, **control),
        PIPE_STEPS, barrier)
    return ms, dict(_build.launch_counts), lat


def phase_pipeline(device):
    """MotionEditorPipeline from frames to frames at full width, bf16:
    encode_video -> null_text_inversion -> the edit -> decode. Returns the
    pipeline, the launches, the metrics and run_pipeline's state."""
    import torch

    from motioneditor_tpu_torch.models.clip_text import StubTokenizer
    from motioneditor_tpu_torch.pipelines.editor import MotionEditorPipeline

    dtype = torch.bfloat16
    t_all = time.perf_counter()
    unet, cn = build_models(*pipeline_configs(), device, dtype, SEED + 10)
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    vae, text = pipeline_models(device, dtype, gen)
    pipe = MotionEditorPipeline(unet=unet, vae=vae, text_encoder=text, controlnet=cn,
                                tokenizer=StubTokenizer(), unet_config=pipeline_configs()[0])
    metrics, paths, state = run_pipeline(pipe, gen, SEED + 12, "pipeline")
    metrics["total_s"] = time.perf_counter() - t_all
    log(f"[pipe] {json.dumps(metrics)}")
    log(f"[pipe] launches {paths}")
    expect_counts("pipeline_inversion", paths["pipeline_inversion"], add_counts(
        scaled(EXPECTED_PER_INVERSION_STEP, PIPE_STEPS),
        scaled(EXPECTED_PER_NULL_STEP, PIPE_STEPS)), 1)
    expect_counts("pipeline_edit", paths["pipeline_edit"], add_counts(
        scaled(EXPECTED_PER_VANILLA_STEP, PIPE_START),
        scaled(EXPECTED_PER_STEP, PIPE_STEPS - PIPE_START)), 1)
    return pipe, paths, metrics, state


def pipeline_configs():
    from motioneditor_tpu_torch.models.controlnet import controlnet_config
    from motioneditor_tpu_torch.models.unet import UNetConfig

    return UNetConfig(), controlnet_config()


P2P_MARGIN = 1e-5  # the least distance of a LocalBlend map value from its threshold in a check
# the text embeddings' scale in the tiny p2p checks: 10x the other checks',
# so that the random models' cross-attention sharpens and the LocalBlend
# maps spread (at 0.3 the edit row's first map spans 0.95-1.0 at 8 frames
# of 32x32 latents, at 3.0 0.44-1.0: a CPU run of the tiny models), and a
# threshold inside their range keeps P2P_MARGIN from 16k values
P2P_TEXT_SCALE = 3.0


def recording_blend(alpha_layers, threshold: float):
    """A LocalBlend that records, for each call, the least distance of a
    normalized map value from its threshold (a value closer than float noise
    could flip between two runs being compared), the edit row's range and
    its share above the threshold."""
    import dataclasses

    from motioneditor_tpu_torch.control.p2p import LocalBlend

    @dataclasses.dataclass(frozen=True, eq=False)
    class RecordingBlend(LocalBlend):
        calls: list = dataclasses.field(default_factory=list)

        def selection(self, *args):
            sel = super().selection(*args)
            edit = sel[1]
            self.calls.append(dict(gap=(sel - self.threshold).abs().min().item(),
                                   lo=edit.min().item(), hi=edit.max().item(),
                                   share=(edit > self.threshold).float().mean().item()))
            return sel

    return RecordingBlend(alpha_layers=alpha_layers, threshold=threshold)


def clear_threshold(alpha_layers, run, reduce=lambda value, op: value) -> float:
    """A LocalBlend threshold for a check that compares two runs: at random
    weights the maps are nearly flat and every edit-row value clears 0.3,
    so the threshold is placed inside the range of the edit row's first map
    (a probe ``run(blend)`` at 0.3 reads it), at the first fraction of it
    whose run leaves every value more than P2P_MARGIN from it with an edit
    mask of both sides. ``reduce(value, "min" | "max")``: over the ranks of
    a sharded run, so that every rank picks the same threshold."""
    probe = recording_blend(alpha_layers, 0.3)
    run(probe)
    lo, hi = reduce(probe.calls[0]["lo"], "min"), reduce(probe.calls[0]["hi"], "max")
    for q in (0.5, 0.4, 0.6, 0.3, 0.7, 0.45, 0.55, 0.35, 0.65, 0.25, 0.75, 0.42, 0.58):
        blend = recording_blend(alpha_layers, lo + q * (hi - lo))
        run(blend)
        if reduce(float(all(c["gap"] > P2P_MARGIN and 0 < c["share"] < 1
                            for c in blend.calls)), "min"):
            return blend.threshold
    raise AssertionError("no LocalBlend threshold inside the maps' range clears P2P_MARGIN")


def phase_p2p(device, pipe, state):
    """Phase 12: the p2p edit (replace + LocalBlend) of phase 7's inputs at
    full width, beside phase 7's edit of the same inputs, in turns; the
    decoded video; one more step of each under torch.profiler."""
    import torch

    from motioneditor_tpu_torch.control.injection import InjectionSpec, prepare_injection_masks
    from motioneditor_tpu_torch.models.controlnet import precompute_cond_embedding
    from motioneditor_tpu_torch.pipelines.editor import _count_16x16_sites, denoise_segment

    run_edit(pipe, state, True)  # warm-up: the explicit cross-attention shapes
    times, peaks, runs = {True: [], False: []}, {True: 0.0, False: 0.0}, {}
    for p2p in (False, True, True, False):
        torch.cuda.reset_peak_memory_stats()
        ms, launches, lat = run_edit(pipe, state, p2p)
        times[p2p].append(ms)
        peaks[p2p] = max(peaks[p2p], torch.cuda.max_memory_allocated() / 2**30)
        runs[p2p] = (launches, lat)
    (launches, lat), (_, plain) = runs[True], runs[False]
    expect_counts("p2p_edit", launches, add_counts(
        scaled(EXPECTED_PER_VANILLA_STEP, PIPE_START),
        scaled(EXPECTED_PER_STEP, PIPE_STEPS - PIPE_START)), 1)
    video = pipe.decode_latents(lat)
    size = 8 * LATENT
    if video.shape != (2, FRAMES, size, size, 3) or not torch.isfinite(video).all():
        raise AssertionError(f"p2p output {tuple(video.shape)} is not a finite video")
    if video.min() < 0 or video.max() > 1:
        raise AssertionError("p2p output leaves [0, 1]")
    edit_moved = (lat[1].float() - plain[1].float()).abs().max().item()
    recon_moved = (lat[0].float() - plain[0].float()).abs().max().item()
    if not edit_moved > 1e-2:
        raise AssertionError(f"the controller left the edit as it was: {edit_moved}")

    # one more injected step of each edit, as __call__ builds its inputs
    f, h = FRAMES, LATENT
    cond = pipe.encode_prompt(P2P_PROMPTS)
    masks = prepare_injection_masks(state["masks"], f, tuple((h >> i, h >> i) for i in range(4)))
    skeleton = state["skeleton"].to(pipe.dtype)
    with torch.no_grad():
        cond_emb = precompute_cond_embedding(pipe.controlnet, skeleton[None].expand(2, *skeleton.shape))
    ts = pipe.schedule.inference_timesteps(PIPE_STEPS)
    controller, blend = p2p_control(pipe.tokenizer)
    maps = torch.zeros((_count_16x16_sites(h, h), 4 * f, 256, 77), device=device)

    def step(p2p):
        control = dict(p2p_controller=controller, local_blend=blend, seg_lo=PIPE_START,
                       maps_sum=maps) if p2p else {}
        return denoise_segment(
            pipe.unet, pipe.unet_config, pipe.controlnet, pipe.controlnet_config, pipe.schedule,
            PIPE_STEPS, InjectionSpec.from_start_layer(10), 7.5, 1.0,
            torch.cat([state["x_t"], state["x_t"]]), ts[PIPE_START:PIPE_START + 1], cond, None,
            cond_emb, masks, seg_uncond=state["uncond"][PIPE_START:PIPE_START + 1], **control)

    profiles = {"p2p": profile_step(lambda: step(True)), "plain": profile_step(lambda: step(False))}
    metrics = {"p2p_edit_ms_per_step": sum(times[True]) / 2,
               "plain_edit_ms_per_step": sum(times[False]) / 2,
               "p2p_edit_ms_per_step_runs": times[True], "plain_edit_ms_per_step_runs": times[False],
               "p2p_peak_gib": peaks[True], "plain_peak_gib": peaks[False],
               "edit_latents_moved": edit_moved, "recon_latents_moved": recon_moved}
    log(f"[p2p] {json.dumps(metrics)}; launches {launches}")
    log(f"[p2p] one more step under torch.profiler: {json.dumps(profiles)}")
    return launches, metrics, profiles, video


def phase_p2p_check(device):
    """Phase 12b: tiny fp32 p2p segments (2 steps inside the self window),
    kernel path against plain path, at 32x32 latents so that level 0
    reaches the kernels: replace, refine and reweight with LocalBlend in
    mask mode, replace in normal attention (the self-attention editor acts at
    the 16x16 sites) and replace in auto-mask mode (K8)."""
    import dataclasses

    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.control.injection import InjectionSpec
    from motioneditor_tpu_torch.control.p2p import make_controller, make_local_blend
    from motioneditor_tpu_torch.models.clip_text import StubTokenizer
    from motioneditor_tpu_torch.models.controlnet import precompute_cond_embedding
    from motioneditor_tpu_torch.pipelines.editor import _count_16x16_sites, denoise_segment
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    config, cn_config, unet, cn, gen = build_tiny_models(device, SEED + 15)
    f, hw = 2, 32
    lat = 0.3 * torch.randn((2, f, hw, hw, 4), generator=gen, device=device)
    cond, uncond = (P2P_TEXT_SCALE * torch.randn((2, 77, 16), generator=gen, device=device)
                    for _ in range(2))
    image = torch.rand((2, f, 8 * hw, 8 * hw, 3), generator=gen, device=device)
    masks = {(s, s): (torch.rand((f, s * s, 1), generator=gen, device=device) > 0.5).float()
             for s in (32, 16, 8, 4)}
    with torch.no_grad():
        cond_emb = precompute_cond_embedding(cn, image)
    schedule, tokenizer = DiffusionSchedule(), StubTokenizer()
    prompts = {"replace": P2P_PROMPTS, "refine": ["a girl is dancing", "a man is dancing outside"],
               "reweight": P2P_PROMPTS}
    auto = dict(mask_mode="auto", auto_token_idx=(1, 2), auto_thres=0.3)
    cases = (("replace", True, {}, FORWARD_KERNELS), ("refine", True, {}, FORWARD_KERNELS),
             ("reweight", True, {}, FORWARD_KERNELS), ("replace", False, {}, FORWARD_KERNELS),
             ("replace", True, auto, AUTO_KERNELS))
    launched = {}
    for kind, sc_attn, spec_kw, need in cases:
        kw = dict(equalizer_words=["man"], equalizer_values=[3.0]) if kind == "reweight" else {}
        controller = make_controller(prompts[kind], tokenizer, 50, **kw)
        alpha = make_local_blend(prompts[kind], [P2P_WORDS] * 2, tokenizer).alpha_layers
        cfg = dataclasses.replace(config, use_sc_attn=sc_attn)
        spec = InjectionSpec.from_start_layer(10, **spec_kw)

        def run(blend, use_flash=False):
            maps = torch.zeros((_count_16x16_sites(hw, hw), 4 * f, 256, 77), device=device)
            out = denoise_segment(unet, cfg, cn, cn_config, schedule, 50, spec, 7.5, 1.0, lat,
                                  schedule.inference_timesteps(50)[4:6], cond, uncond, cond_emb,
                                  masks, use_flash=use_flash, p2p_controller=controller,
                                  local_blend=blend, seg_lo=4, maps_sum=maps)
            torch.cuda.synchronize()
            return out, maps

        threshold = clear_threshold(alpha, run)
        outs, gaps = {}, []
        for use_flash in (True, False):
            blend = recording_blend(alpha, threshold)
            _build.reset_launch_counts()
            outs[use_flash] = run(blend, use_flash)
            gaps += [c["gap"] for c in blend.calls]
            if use_flash:
                got = dict(_build.launch_counts)
                if not all(got.get(k) for k in need):
                    raise AssertionError(f"the p2p {kind} check skipped a kernel: {got}")
            elif _build.launch_counts:
                raise AssertionError(f"plain path launched kernels: {_build.launch_counts}")
        name = f"{kind}_{'auto' if spec_kw else 'mask'}{'' if sc_attn else '_normal'}"
        launched[name] = got
        err = (outs[True][0] - outs[False][0]).abs().max().item()
        err_maps = (outs[True][1] - outs[False][1]).abs().max().item()
        log(f"[p2p-check] {name}: 2-step fp32 segment with LocalBlend at threshold "
            f"{threshold:.6f}, "
            f"kernel vs plain path: max_abs_err={err:.3e}, map sum max_abs_err={err_maps:.3e}, "
            f"least gap to the threshold {min(gaps):.2e}; launches {got}")
        if not torch.isfinite(outs[True][0]).all() or err > 2e-3 or err_maps > 2e-3:
            raise AssertionError(f"the p2p {name} kernel path disagrees with the plain path: "
                                 f"{err}, {err_maps}")
        if min(gaps) <= P2P_MARGIN:
            raise AssertionError(f"a LocalBlend map value of {name} lies {min(gaps)} from the "
                                 "threshold")
    return {"p2p_check": add_counts(*launched.values())}


def phase_eval(device, pipe, state, video):
    """Phase 13: the edit-quality metrics of phase 12's video against phase
    7's source frames on the card (psnr and ssim of the reconstruction,
    temporal consistency of the edit, LPIPS with random AlexNet taps, CLIP
    score and frame consistency with a random ViT-L/14 image tower at full
    width and phase 7's text encoder), each finite and timed; then each on
    2 frames in fp32 against the same function on the CPU."""
    import copy

    import torch

    from motioneditor_tpu_torch.eval.lpips import LPIPS, init_lpips, lpips
    from motioneditor_tpu_torch.eval.metrics import (
        clip_score,
        frame_clip_consistency,
        psnr,
        ssim,
        temporal_consistency,
    )
    from motioneditor_tpu_torch.models.clip_image import CLIPVisionModel, init_clip_image

    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    with torch.device(device):
        image_model, lpips_model = CLIPVisionModel().eval(), LPIPS().eval()
    init_clip_image(image_model, gen)
    init_lpips(lpips_model, gen)
    source = (state["video"][0].float() + 1) / 2  # [F, H, W, 3] in [0, 1]
    prompt = P2P_PROMPTS[1]

    def metrics(recon, src, edit, image, text, lp, tokenizer):
        return {
            "recon_psnr": lambda: psnr(recon, src),
            "recon_ssim": lambda: ssim(recon, src),
            "recon_lpips": lambda: lpips(lp, recon, src),
            "edit_temporal_consistency": lambda: temporal_consistency(edit),
            "edit_clip_score": lambda: clip_score(edit, prompt, image, text, tokenizer),
            "edit_frame_clip_consistency": lambda: frame_clip_consistency(edit, image),
        }

    values, ms = {}, {}
    with torch.no_grad():
        for name, fn in metrics(video[0], source, video[1], image_model, pipe.text_encoder,
                                lpips_model, pipe.tokenizer).items():
            fn()  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            values[name] = float(fn())
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
        bad = {k: v for k, v in values.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"metrics not finite: {bad}")
        # 2 frames in fp32, on the card and on the CPU
        text32 = copy.deepcopy(pipe.text_encoder).float()
        frames = (video[0, :2].float(), source[:2], video[1, :2].float())
        card = {k: float(fn()) for k, fn in metrics(
            *frames, image_model, text32, lpips_model, pipe.tokenizer).items()}
        cpu_models = [copy.deepcopy(m).cpu() for m in (image_model, text32, lpips_model)]
        cpu = {k: float(fn()) for k, fn in metrics(
            *(x.cpu() for x in frames), cpu_models[0], cpu_models[1], cpu_models[2],
            pipe.tokenizer).items()}
    errs = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu}
    log(f"[eval] 8 frames on the card: {json.dumps(values)}; ms {json.dumps(ms)}")
    log(f"[eval] 2 frames fp32, card vs CPU, error over |CPU|: {json.dumps(errs)}")
    if any(e > 1e-4 for e in errs.values()):
        raise AssertionError(f"metrics on the card disagree with the CPU: {errs}")
    del image_model, lpips_model, text32, cpu_models
    torch.cuda.empty_cache()
    return {"values": values, "ms": ms, "card_vs_cpu_2_frames": errs}


REPO = os.path.dirname(os.path.abspath(__file__))


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def write_safetensors(sd: dict, path: str) -> None:
    """A ``.safetensors`` file of fp32 CPU tensors: the 8-byte little-endian
    header length, the JSON header (dtype, shape, data_offsets), the raw
    buffer."""
    import torch

    header, offset = {}, 0
    for name, t in sd.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}; this writer takes fp32 only")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in sd.values():
            f.write(t.contiguous().view(-1).view(torch.uint8).numpy().tobytes())


VIDEO_ONLY = ("temp_conv1.", "temp_conv2.", ".attn_temp.", ".norm_temp.", "controlnet_adapter.")
VAE_NEW_NAMES = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def write_sd15_directory(root: str, pipe) -> dict:
    """Phase 7's models as a diffusers SD-1.5 directory, a ControlNet
    directory and the reference's adapter .pth, fp32, in the layouts the
    loaders must accept: the UNet as .safetensors without temporal or
    adapter keys, the VAE with to_q / to_out.0 names and 1x1-conv attention
    weights, the text encoder with the text_model. prefix and position_ids.
    Returns the seconds and bytes written per model."""
    import torch

    def cpu32(sd):
        return {k: (v.detach().float() if v.is_floating_point() else v.detach()).cpu()
                for k, v in sd.items()}

    out = {}
    for d in ("unet", "vae", "text_encoder", "controlnet"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    t0 = time.perf_counter()
    unet = {k: v for k, v in cpu32(pipe.unet.state_dict()).items()
            if not any(tag in k for tag in VIDEO_ONLY)}
    write_safetensors(unet, os.path.join(root, "unet", "diffusion_pytorch_model.safetensors"))
    out["unet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vae = {}
    for k, v in cpu32(pipe.vae.state_dict()).items():
        parts = k.split(".")
        if ".mid_block.attentions.0." in k and parts[-2] in VAE_NEW_NAMES:
            k = ".".join(parts[:-2] + [VAE_NEW_NAMES[parts[-2]], parts[-1]])
            v = v[:, :, None, None].contiguous() if v.ndim == 2 else v
        vae[k] = v
    torch.save(vae, os.path.join(root, "vae", "diffusion_pytorch_model.bin"))
    out["vae"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    text = cpu32(pipe.text_encoder.state_dict())
    if "text_model.embeddings.position_ids" not in text:
        raise AssertionError("the text encoder has no position_ids buffer to write")
    torch.save(text, os.path.join(root, "text_encoder", "pytorch_model.bin"))
    out["text_encoder"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.save(cpu32(pipe.controlnet.state_dict()),
               os.path.join(root, "controlnet", "diffusion_pytorch_model.bin"))
    out["controlnet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.save(cpu32(pipe.unet.controlnet_adapter.state_dict()), os.path.join(root, "adapter.pth"))
    out["adapter"] = time.perf_counter() - t0
    sizes = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            sizes[os.path.relpath(os.path.join(dirpath, f), root)] = os.path.getsize(
                os.path.join(dirpath, f))
    return {"write_s": out, "bytes": sizes}


def phase_weights(device, pipe, state, pipe_launches):
    """Phase 14: phase 7's models written as the published checkpoints'
    layouts (write_sd15_directory), read back through
    inference.build_pipeline (bf16, StubTokenizer); every loaded parameter
    equal to phase 7's bitwise but attn_temp's q / k / v (fresh init; their
    to_out is zero); phase 7's edit of its own inputs on the loaded pipeline
    beside a repeat on phase 7's: the same launches, the same latents
    (bitwise, or within the repeat's spread)."""
    import shutil

    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.configs import RunConfig
    from motioneditor_tpu_torch.inference import build_pipeline
    from motioneditor_tpu_torch.models import weights as W
    from motioneditor_tpu_torch.models.clip_text import StubTokenizer

    root = os.path.join(REPO, "build", "phase14_weights")
    shutil.rmtree(root, ignore_errors=True)
    try:
        written = write_sd15_directory(root, pipe)
        log(f"[weights] {card()}: wrote {json.dumps(written)}")
        try:  # models/weights.py reads .safetensors without it
            import safetensors

            log(f"[weights] the safetensors package is importable here ({safetensors.__version__})")
        except ImportError:
            log("[weights] the safetensors package is not importable here")
        cfg = RunConfig(pretrained_model_path=root,
                        controlnet_path=os.path.join(root, "controlnet"),
                        adapter_weight_path=os.path.join(root, "adapter.pth"), seed=SEED + 18)
        timings, current = {}, []

        def timed(name, fn):
            def wrapper(*a, **kw):
                current.append(name)
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    timings.setdefault(name, {})["total_s"] = time.perf_counter() - t0
                    current.pop()
            return wrapper

        def timed_read(fn):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                entry = timings.setdefault(current[-1] if current else "?", {})
                entry["read_s"] = entry.get("read_s", 0.0) + time.perf_counter() - t0
                return out
            return wrapper

        names = ("load_sd15_unet", "load_sd15_vae", "load_sd15_text_encoder", "load_controlnet",
                 "load_adapter_checkpoint", "load_state_dict")
        saved = {n: getattr(W, n) for n in names}
        for n in names[:-1]:
            setattr(W, n, timed(n[len("load_"):], saved[n]))
        W.load_state_dict = timed_read(saved["load_state_dict"])
        try:
            t0 = time.perf_counter()
            loaded = build_pipeline(cfg, device, dtype=pipe.dtype,
                                    unet_config=pipeline_configs()[0], tokenizer=StubTokenizer())
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
        finally:
            for n, fn in saved.items():
                setattr(W, n, fn)
        for entry in timings.values():
            entry["build_s"] = entry["total_s"] - entry.get("read_s", 0.0)
        log(f"[weights] {card()}: build_pipeline {build_s:.2f} s; read and build seconds per "
            f"model {json.dumps(timings)}")

        differ = []
        for name in ("unet", "vae", "text_encoder", "controlnet"):
            ref = dict(getattr(pipe, name).named_parameters())
            got = dict(getattr(loaded, name).named_parameters())
            if got.keys() != ref.keys():
                raise AssertionError(f"{name}: the loaded parameters have other names")
            for k, v in got.items():
                if v.dtype != ref[k].dtype or not torch.equal(v, ref[k]):
                    differ.append(f"{name}.{k}")
        allowed = [k for k in differ if ".attn_temp.to_" in k and ".to_out." not in k]
        if differ != allowed or not allowed:
            raise AssertionError(f"loaded parameters differ from phase 7's: "
                                 f"{[k for k in differ if k not in allowed][:5]}")
        log(f"[weights] every loaded parameter equals phase 7's bitwise but the "
            f"{len(allowed)} attn_temp q / k / v tensors, which keep fresh init")

        def edit(p):
            _build.reset_launch_counts()
            ms, lat = timed_steps(lambda: p(
                PIPE_PROMPTS, torch.cat([state["x_t"], state["x_t"]]), state["skeleton"],
                source_masks=state["masks"], uncond_embeddings=state["uncond"],
                num_inference_steps=PIPE_STEPS, start_step=PIPE_START, decode=False),
                PIPE_STEPS, lambda: None)
            return ms, dict(_build.launch_counts), lat

        ms_loaded, launches, lat_loaded = edit(loaded)
        ms_repeat, launches_repeat, lat_repeat = edit(pipe)
        for tag, got in (("loaded", launches), ("repeat", launches_repeat)):
            if got != pipe_launches:
                raise AssertionError(f"the {tag} edit launched {got}, phase 7's {pipe_launches}")
        spread = (lat_repeat.float() - state["lat"].float()).abs().max().item()
        err = (lat_loaded.float() - state["lat"].float()).abs().max().item()
        log(f"[weights] phase 7's edit ({PIPE_STEPS} steps from {PIPE_START}) on the loaded "
            f"pipeline: {ms_loaded:.1f} ms/step, max |latents - phase 7's| {err:.3e}; a repeat "
            f"on phase 7's pipeline {ms_repeat:.1f} ms/step, {spread:.3e}; launches {launches}; "
            f"{card()}")
        if not err <= spread:
            raise AssertionError(f"the loaded pipeline's edit is {err} from phase 7's, past the "
                                 f"repeat's spread {spread}")
        del loaded
        torch.cuda.empty_cache()
        return launches, {"written": written, "build_pipeline_s": build_s, "per_model": timings,
                          "edit_ms_per_step": ms_loaded, "repeat_ms_per_step": ms_repeat,
                          "max_abs_err": err, "repeat_spread": spread,
                          "fresh_attn_temp_tensors": len(allowed)}
    finally:
        shutil.rmtree(root, ignore_errors=True)


PREP_FRAMES = 8
PREP_CROP = 128  # the hand and face crops timed on their own
PREP_CARD_CPU_LIMIT = 1e-3  # max |card - CPU| / max |CPU| of a network's fp32 maps


def stripped(sd: dict) -> dict:
    """pytorch-openpose's released layout: the module prefix dropped."""
    return {k.split(".", 1)[1]: v for k, v in sd.items()}


def phase_prep(device):
    """Phase 15: the skeleton side of data preparation at the published
    widths, random weights from the seed written as the released files'
    layouts (prefix-stripped body / hand .pth, flat face .pth, MiDaS in the
    checkpoint mirror's layout) and read back through the loaders: on
    PREP_FRAMES frames of 512 x 512, render_skeleton_full with body, hand
    and face models, estimate_depth and align_frames on synthetic masks;
    ms per frame of each network (CUDA events) apart from the host's
    decoding; then one input of each network on the card against the CPU,
    fp32 (TF32 off)."""
    import copy
    import shutil

    import numpy as np
    import torch

    from motioneditor_tpu_torch.models import midas as M
    from motioneditor_tpu_torch.models import openpose as O
    from motioneditor_tpu_torch.models.layers import init_params
    from motioneditor_tpu_torch.prep.alignment import align_frames

    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    with torch.device(device):
        nets = {"body": O.BodyPoseModel(), "hand": O.HandPoseModel(), "face": O.FaceModel(),
                "midas": M.DPTHybrid()}
    for m in nets.values():
        init_params(m, gen)
    vit = nets["midas"].pretrained.model
    with torch.no_grad():
        vit.pos_embed.normal_(0.0, 0.02, generator=gen)
        vit.cls_token.normal_(0.0, 0.02, generator=gen)
        # at these weights the head's last ReLU zeroes every depth value;
        # a positive last bias keeps a depth map to normalize and compare
        getattr(nets["midas"].scratch.output_conv, "4").bias.fill_(0.5)
    root = os.path.join(REPO, "build", "phase15_weights")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        files = {"body": "body_pose_model.pth", "hand": "hand_pose_model.pth",
                 "face": "facenet.pth", "midas": "dpt_hybrid-midas-501f0c75.pt"}
        for name, m in nets.items():
            sd = {k: v.cpu() for k, v in m.state_dict().items()}
            torch.save(stripped(sd) if name in ("body", "hand") else sd,
                       os.path.join(root, files[name]))
        load = {"body": O.load_body_params, "hand": O.load_hand_params,
                "face": O.load_face_params, "midas": M.load_dpt_params}
        models, load_s = {}, {}
        for name in nets:
            t0 = time.perf_counter()
            models[name] = load[name](os.path.join(root, files[name]), device)
            torch.cuda.synchronize()
            load_s[name] = time.perf_counter() - t0
            for k, v in nets[name].state_dict().items():
                if not torch.equal(models[name].state_dict()[k], v):
                    raise AssertionError(f"{files[name]}: {k} did not load back")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    body, hand, face, dpt = (models[k] for k in ("body", "hand", "face", "midas"))

    size = 8 * LATENT
    frames = torch.randint(0, 256, (PREP_FRAMES, size, size, 3), generator=gen, device=device,
                           dtype=torch.uint8).cpu().numpy()
    skeletons, depths, host = [], [], {"body_decode": 0.0, "hand_decode": 0.0,
                                       "face_decode": 0.0, "depth_post": 0.0}
    found = {"people": 0, "hands": 0, "faces": 0}
    t_all = time.perf_counter()
    for img in frames:
        skeletons.append(O.render_skeleton_full(body, img, hand_model=hand, face_model=face))
        heat, paf = O.body_maps(body, img)
        t0 = time.perf_counter()
        cand, subset = O.decode_body(heat, paf)
        host["body_decode"] += time.perf_counter() - t0
        found["people"] += len(subset)
        found["hands"] += len(O.hand_detect(cand, subset, size, size))
        found["faces"] += len(O.face_detect(cand, subset, size, size))
        crop = img[:PREP_CROP, :PREP_CROP]
        hand_heat = O.hand_maps(hand, crop)
        t0 = time.perf_counter()
        O.hand_peaks(hand_heat)
        host["hand_decode"] += time.perf_counter() - t0
        face_heat = O.face_maps(face, crop)
        t0 = time.perf_counter()
        O.face_peaks(face_heat)
        host["face_decode"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        depths.append(M.estimate_depth(dpt, img))
        host["depth_total"] = host.get("depth_total", 0.0) + time.perf_counter() - t0
    prep_s = time.perf_counter() - t_all
    masks = np.zeros((PREP_FRAMES, size, size), np.float32)
    target = np.zeros_like(masks)
    u = size // 64  # the source person walks down, the target one left
    for i in range(PREP_FRAMES):
        masks[i, (12 + i) * u:56 * u, 20 * u:40 * u] = 1.0
        target[i, 16 * u:60 * u, (32 - i) * u:50 * u] = 1.0
    # the skeletons with vertical bars, so the aligned poses are not empty
    poses = np.stack([np.where(np.arange(size)[None, :, None] % (8 * u) < u, 255, s)
                      .astype(np.uint8) for s in skeletons])
    t0 = time.perf_counter()
    aligned = align_frames(masks, target, poses, canvas_hw=(size, size))
    align_s = time.perf_counter() - t0
    for what, arr in (("skeletons", np.stack(skeletons)), ("depth", np.stack(depths)),
                      ("aligned", aligned)):
        if arr.shape != (PREP_FRAMES, size, size, 3) or arr.dtype != np.uint8:
            raise AssertionError(f"{what}: {arr.shape} {arr.dtype}")
    if not aligned.any():
        raise AssertionError("the aligned poses are empty")

    # each network alone, CUDA events, at the inputs the path gives it
    body_in = round(size * 0.5 * 368 / size)
    hand_ins = [round(PREP_CROP * s * 368 / PREP_CROP) for s in (0.5, 1.0, 1.5, 2.0)]
    inputs = {
        "body": [torch.rand((1, body_in, body_in, 3), generator=gen, device=device) - 0.5],
        "hand": [torch.rand((1, n, n, 3), generator=gen, device=device) - 0.5
                 for n in hand_ins],
        "face": [torch.rand((1, 384, 384, 3), generator=gen, device=device) - 0.5],
        "midas": [torch.rand((1, size, size, 3), generator=gen, device=device) * 2 - 1],
    }
    forward = {"body": O.body_forward, "hand": O.hand_forward, "face": O.face_forward,
               "midas": M.dpt_forward}
    ms = {}
    with torch.no_grad():
        for name, xs in inputs.items():
            ms[name] = sum(time_ms(lambda: forward[name](models[name], x), reps=5) for x in xs)
    per_frame = {
        "body_network_ms": ms["body"],
        "body_decode_ms": host["body_decode"] * 1e3 / PREP_FRAMES,
        "hand_network_ms_per_crop_4_scales": ms["hand"],
        "hand_decode_ms_per_crop": host["hand_decode"] * 1e3 / PREP_FRAMES,
        "face_network_ms_per_crop": ms["face"],
        "face_decode_ms_per_crop": host["face_decode"] * 1e3 / PREP_FRAMES,
        "midas_network_ms": ms["midas"],
        "estimate_depth_ms": host["depth_total"] * 1e3 / PREP_FRAMES,
        "align_ms": align_s * 1e3 / PREP_FRAMES,
    }

    # one input of each network, card against CPU, fp32
    errs = {}
    with torch.no_grad():
        for name, xs in inputs.items():
            x = xs[0]
            on_card = forward[name](models[name], x)
            cpu = forward[name](copy.deepcopy(models[name]).cpu(), x.cpu())
            pairs = zip(on_card, cpu) if isinstance(on_card, tuple) else ((on_card, cpu),)
            errs[name] = max((a.cpu() - b).abs().max().item() / b.abs().max().item()
                             for a, b in pairs)
    log(f"[prep] {card()}: {PREP_FRAMES} frames of {size} px in {prep_s:.1f} s "
        f"(render_skeleton_full "
        f"with body + hand + face, the hand and face crops alone, estimate_depth), found "
        f"{json.dumps(found)}; ms per frame {json.dumps(per_frame)}; load s {json.dumps(load_s)}")
    log(f"[prep] card vs CPU, fp32, max |card - CPU| / max |CPU| (limit "
        f"{PREP_CARD_CPU_LIMIT}): {json.dumps(errs)}")
    if any(not e <= PREP_CARD_CPU_LIMIT for e in errs.values()):
        raise AssertionError(f"a network on the card disagrees with the CPU: {errs}")
    del models, body, hand, face, dpt, nets
    torch.cuda.empty_cache()
    return {"ms_per_frame": per_frame, "found": found, "load_s": load_s, "prep_s": prep_s,
            "card_vs_cpu": errs, "inputs": {"body": body_in, "hand": hand_ins, "face": 384,
                                            "midas": size}}


MASK_FRAMES = 8
MASK_CAPTION = "person"
BERT_VOCAB = 30522
BERT_IDS = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102, "[MASK]": 103, ".": 1012,
            "person": 2711}  # bert-base-uncased's ids
# max |card - CPU| / max |CPU| of GroundingDINO's encoder scores in fp32
# (1.93e-6 measured on an H100 at 700 W): the 900 queries are the top 900
# of ~12,700 of them, so two scores whose CPU gap is within twice this of
# max |CPU| may trade places between the devices, and no others can
TOPK_SCORE_LIMIT = 1e-5


def write_bert_vocab(path: str) -> None:
    """A synthetic vocab.txt of bert-base-uncased's size, with its special
    tokens, "." and "person" at their ids there."""
    lines = [f"[unused{i}]" if i < 1000 else f"w{i}" for i in range(BERT_VOCAB)]
    for token, i in BERT_IDS.items():
        lines[i] = token
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def manifest_shapes(name: str) -> dict:
    with open(os.path.join(REPO, "tests", "fixtures", "manifests", name + ".txt")) as f:
        return {k: tuple(int(d) for d in s.split(",")) for k, s in (ln.split() for ln in f)}


def masks_work() -> dict:
    """GFLOP of GroundingDINO-SwinT at 800 px with the caption, of the SAM
    ViT-H encoder and of its prompt + decoder for one box, counted by
    FlopCounterMode on the meta device, and the modules' parameters."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from motioneditor_tpu_torch.models import grounding_dino as G
    from motioneditor_tpu_torch.models import sam as S

    meta = torch.device("meta")
    with meta:
        gdino, sam = G.GroundingDINO(G.GDINO_SWINT), S.Sam(S.SAM_VIT_H)
    ids = np.array([[BERT_IDS["[CLS]"], BERT_IDS[MASK_CAPTION], BERT_IDS["."],
                     BERT_IDS["[SEP]"]]])
    attn, pos = G.build_text_masks(ids, [BERT_IDS[t] for t in ("[CLS]", "[SEP]", ".")])
    ids_t = torch.as_tensor(ids, device=meta)
    gflop = {}
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            G.grounding_dino_apply(gdino, torch.zeros((1, 800, 800, 3), device=meta), ids_t,
                                   torch.as_tensor(attn, device=meta),
                                   torch.as_tensor(pos, device=meta),
                                   torch.ones_like(ids_t, dtype=torch.bool))
        gflop["grounding_dino"] = fc.get_total_flops() / 1e9
        s = sam.config.img_size
        with FlopCounterMode(display=False) as fc:
            emb = S.sam_encode_image(sam, torch.zeros((1, s, s, 3), device=meta))
        gflop["sam_encoder"] = fc.get_total_flops() / 1e9
        with FlopCounterMode(display=False) as fc:
            S.sam_decode_masks(sam, emb, torch.zeros((1, 4), device=meta))
        gflop["sam_prompt_decoder"] = fc.get_total_flops() / 1e9
    return {"gflop": gflop, "params_m": {
        "grounding_dino": sum(p.numel() for p in gdino.parameters()) / 1e6,
        "sam": sum(p.numel() for p in sam.parameters()) / 1e6}}


def phase_masks(device):
    """Phase 16: the mask side of data preparation at the published widths.
    GroundingDINO-SwinT and SAM ViT-H, random from the seed in fp32, written
    as the released files (``{"model": ...}`` under gdino_swint.txt's keys,
    a flat state dict under sam_vit_h.txt's) beside a synthetic BERT vocab;
    the masks CLI's native path (``--device cuda``) on MASK_FRAMES PNGs of
    512 x 512 at box threshold 0 (random weights find no person, so a real
    threshold would leave SAM idle): MASK_FRAMES masks of 0 / 255. Then ms
    per frame of each network (CUDA events) beside the host's parts, the
    peak memory, and one frame in fp32 on the card against the CPU: the
    boxes, finite logits, SAM's embedding and mask logits within
    PREP_CARD_CPU_LIMIT of max |CPU|; the encoder's scores within
    TOPK_SCORE_LIMIT, and the top-k queries identical but for near ties
    that the scores' error allows to trade places."""
    import copy
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from motioneditor_tpu_torch.models import gdino_weights as W
    from motioneditor_tpu_torch.models import grounding_dino as G
    from motioneditor_tpu_torch.models import sam as S
    from motioneditor_tpu_torch.prep import masks as K
    from motioneditor_tpu_torch.prep.tokenizer import WordPieceTokenizer

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(SEED + 23)
    with torch.device(device):
        gdino, sam = G.GroundingDINO(G.GDINO_SWINT), S.Sam(S.SAM_VIT_H)
    G.init_grounding_dino(gdino, gen)
    S.init_sam(sam, gen)
    with torch.no_grad():  # JAX's init leaves these zero; random, they take part
        sam.image_encoder.pos_embed.normal_(0.0, 0.02, generator=gen)
        for blk in sam.image_encoder.blocks:
            blk.attn.rel_pos_h.normal_(0.0, 0.02, generator=gen)
            blk.attn.rel_pos_w.normal_(0.0, 0.02, generator=gen)
    gdino.eval()
    sam.eval()
    size = 8 * LATENT
    root = os.path.join(REPO, "build", "phase16_masks")
    shutil.rmtree(root, ignore_errors=True)
    frames_dir, out_dir = os.path.join(root, "frames"), os.path.join(root, "masks")
    os.makedirs(frames_dir)
    files = {"dino": os.path.join(root, "groundingdino_swint_ogc.pth"),
             "sam": os.path.join(root, "sam_vit_h_4b8939.pth"),
             "vocab": os.path.join(root, "bert-base-uncased-vocab.txt")}
    frames = torch.randint(0, 256, (MASK_FRAMES, size, size, 3), generator=gen, device=device,
                           dtype=torch.uint8).cpu().numpy()
    try:
        t0 = time.perf_counter()
        released = {"dino": {k: v.cpu() for k, v in W.released_state_dict(gdino).items()},
                    "sam": {k: v.cpu() for k, v in S.released_state_dict(sam).items()}}
        for name, manifest in (("dino", "gdino_swint"), ("sam", "sam_vit_h")):
            got = {k: tuple(v.shape) for k, v in released[name].items()}
            if got != manifest_shapes(manifest):
                raise AssertionError(f"the {name} file's keys are not {manifest}.txt's")
        torch.save({"model": released["dino"]}, files["dino"])
        torch.save(released["sam"], files["sam"])
        del released
        write_bert_vocab(files["vocab"])
        tokenizer = WordPieceTokenizer(files["vocab"])
        for i, img in enumerate(frames):
            Image.fromarray(img).save(os.path.join(frames_dir, f"{i:05d}.png"))
        write_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        K.main(["--data", frames_dir, "--save_dir", out_dir, "--text_prompt", MASK_CAPTION,
                "--dino_backend", "native", "--dino_ckpt", files["dino"], "--bert_vocab",
                files["vocab"], "--sam_path", files["sam"], "--box_threshold", "0.0",
                "--device", "cuda"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        names = sorted(os.listdir(out_dir))
        if names != [f"{i:05d}.png" for i in range(MASK_FRAMES)]:
            raise AssertionError(f"the CLI wrote {names}")
        fg = []
        for n in names:
            m = np.asarray(Image.open(os.path.join(out_dir, n)))
            if m.shape != (size, size) or m.dtype != np.uint8 or not np.isin(m, (0, 255)).all():
                raise AssertionError(f"{n}: {m.shape} {m.dtype} {np.unique(m)[:4]}")
            fg.append(float((m == 255).mean()))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # each network alone (CUDA events) and the host's parts of one frame
    image = Image.fromarray(frames[0])
    host = {}
    t0 = time.perf_counter()
    ids = np.asarray(tokenizer(MASK_CAPTION + ".")["input_ids"], np.int32)[None]
    host["tokenize"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    im, ids, attn, pos = K.dino_inputs(image, MASK_CAPTION, tokenizer)
    host["dino_inputs"] = time.perf_counter() - t0  # tokenize, masks, PIL resize to 800
    out = K.dino_network(gdino, im, ids, attn, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xyxy, scores = K.decode_boxes(out, size, size, 0.0)
    host["box_decode"] = time.perf_counter() - t0
    box = xyxy[int(scores.argmax())]
    t0 = time.perf_counter()
    x, (nh, nw) = S.sam_preprocess(frames[0], sam.config)
    host["sam_preprocess"] = time.perf_counter() - t0  # PIL resize to 1024, pad
    x = torch.from_numpy(x).to(device)
    box_in = torch.as_tensor(box * (sam.config.img_size / size), dtype=torch.float32,
                             device=device)[None]
    ms = {}
    with torch.no_grad():
        ms["grounding_dino"] = time_ms(lambda: K.dino_network(gdino, im, ids, attn, pos))
        ms["sam_encoder"] = time_ms(lambda: S.sam_encode_image(sam, x))
        emb = S.sam_encode_image(sam, x)
        ms["sam_prompt_decoder"] = time_ms(lambda: S.sam_decode_masks(sam, emb, box_in))
        masks, _ = S.sam_decode_masks(sam, emb, box_in)
        ms["mask_resize"] = time_ms(lambda: S._resize2d(S._resize2d(
            masks[0, 0], 1024, 1024)[:nh, :nw], size, size))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mask = (S.sam_predict_box(sam, frames[0], box) * 255).astype(np.uint8)
    host["sam_predict_box"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    Image.fromarray(mask).save(os.path.join(REPO, "build", "phase16_mask.png"))
    host["png_write"] = time.perf_counter() - t0
    os.remove(os.path.join(REPO, "build", "phase16_mask.png"))
    peak = torch.cuda.max_memory_allocated()
    host_ms = {k: v * 1e3 for k, v in host.items()}

    log(f"[masks] {card()}: the masks CLI (native, --device cuda) on {MASK_FRAMES} frames of "
        f"{size} px in {cli_s:.1f} s (files written in {write_s:.1f} s), foreground shares "
        f"{json.dumps([round(f, 4) for f in fg])}; ms per frame {json.dumps(ms)}; host ms "
        f"{json.dumps(host_ms)}; peak {(peak - base) / 2**30:.2f} GiB over the "
        f"{base / 2**30:.2f} GiB held before the phase")
    work = masks_work()
    rates = {k: work["gflop"][k] / ms[k] for k in work["gflop"]}  # TFLOP/s
    log(f"[masks] work {json.dumps(work)}; TFLOP/s {json.dumps(rates)}")
    profiles = {"grounding_dino": profile_step(lambda: K.dino_network(gdino, im, ids, attn, pos),
                                               top=8),
                "sam_encoder": profile_step(lambda: S.sam_encode_image(sam, x), top=8)}
    log(f"[masks] profiled: {json.dumps(profiles)}")

    # one frame, card against CPU, fp32. The encoder's scores compare within
    # TOPK_SCORE_LIMIT; the queries are the top 900 of ~12,700 scores whose
    # closest neighbours lie nearer than fp32 on two devices can hold them.
    # With each score within TOPK_SCORE_LIMIT * max |CPU| of the CPU's, only
    # two scores whose CPU gap is within the band of twice that can trade
    # places, so a query the card ranks where the CPU ranks another must be
    # such a near tie, and at most two ranks differ for each gap within the
    # band among the CPU's top 901. The card's selection of the CPU's scores
    # must be the CPU's. The CPU's decoder then runs from the card's
    # queries, so boxes and logits compare query for query
    def dino_halves(model, topk_idx=None):
        dev = next(model.parameters()).device
        args = [torch.as_tensor(a, device=dev) for a in (im, ids, attn, pos)]
        token_mask = torch.ones_like(args[1], dtype=torch.bool)
        enc = G.grounding_dino_encode(model, *args, token_mask)
        if topk_idx is None:
            topk_idx = G.top_k_indices(enc["scores"], model.config.num_queries)
        out = G.grounding_dino_decode(model, enc, topk_idx.to(dev), token_mask)
        return {"enc_scores": enc["scores"].cpu(), "topk_idx": topk_idx.cpu(),
                **{k: v.cpu() for k, v in out.items()}}

    with torch.no_grad():
        on_card = dino_halves(gdino)
        gdino_cpu = copy.deepcopy(gdino).cpu()
        cpu = dino_halves(gdino_cpu)
        cpu_same = dino_halves(gdino_cpu, on_card["topk_idx"])
        picked = G.top_k_indices(cpu["enc_scores"].to(device), gdino.config.num_queries).cpu()
        card_sam = {k: v.cpu() for k, v in S.sam_mask_logits(sam, frames[0], box).items()}
        cpu_sam = S.sam_mask_logits(copy.deepcopy(sam).cpu(), frames[0], box)

    def rel(a, b):
        return (a - b).abs().max().item() / b.abs().max().item()

    valid = torch.isfinite(cpu["enc_scores"])
    if not torch.equal(torch.isfinite(on_card["enc_scores"]), valid):
        raise AssertionError("the invalid proposals differ between card and CPU")
    finite = torch.isfinite(cpu_same["pred_logits"])
    if not torch.equal(torch.isfinite(on_card["pred_logits"]), finite):
        raise AssertionError("the -inf pattern of pred_logits differs between card and CPU")
    errs = {"enc_scores": rel(on_card["enc_scores"][valid], cpu["enc_scores"][valid]),
            "pred_boxes": rel(on_card["pred_boxes"], cpu_same["pred_boxes"]),
            "pred_logits": rel(on_card["pred_logits"][finite], cpu_same["pred_logits"][finite]),
            "sam_image_emb": rel(card_sam["image_emb"], cpu_sam["image_emb"]),
            "sam_mask_logits": rel(card_sam["masks"], cpu_sam["masks"])}
    score_err = (on_card["enc_scores"][valid] - cpu["enc_scores"][valid]).abs().max().item()
    ranked = cpu["enc_scores"][valid].sort(descending=True).values
    k = gdino.config.num_queries
    band = 2 * TOPK_SCORE_LIMIT * ranked.abs().max().item()
    gaps = ranked[:k] - ranked[1:k + 1]
    cpu_scores = cpu["enc_scores"][0]
    swapped = (on_card["topk_idx"] != cpu["topk_idx"])[0]
    tie = (cpu_scores[on_card["topk_idx"][0]] - cpu_scores[cpu["topk_idx"][0]]).abs()
    topk = {"selection_of_cpu_scores_identical": torch.equal(picked, cpu["topk_idx"]),
            "identical": not bool(swapped.any()), "ranks_differing": int(swapped.sum()),
            "ranks_differing_limit": 2 * int((gaps <= band).sum()), "tie_band": band,
            "max_score_gap_at_differing_ranks": tie[swapped].max().item() if swapped.any()
            else 0.0, "max_score_err": score_err, "min_gap_top_k_plus_1": gaps.min().item(),
            "max_abs_score": ranked.abs().max().item(), "valid_proposals": int(valid.sum())}
    log(f"[masks] card vs CPU, fp32, max |card - CPU| / max |CPU| (limit "
        f"{PREP_CARD_CPU_LIMIT}, enc_scores {TOPK_SCORE_LIMIT}; boxes and logits from the "
        f"card's queries): {json.dumps(errs)}; the top-k queries: {json.dumps(topk)}")
    if any(not e <= PREP_CARD_CPU_LIMIT for e in errs.values()):
        raise AssertionError(f"a network on the card disagrees with the CPU: {errs}")
    if not errs["enc_scores"] <= TOPK_SCORE_LIMIT:
        raise AssertionError(f"the encoder's scores disagree beyond {TOPK_SCORE_LIMIT}: "
                             f"{errs['enc_scores']}")
    if not topk["selection_of_cpu_scores_identical"]:
        raise AssertionError("the card's top-k of the CPU's scores is not the CPU's")
    if not topk["max_score_gap_at_differing_ranks"] <= band:
        raise AssertionError(f"the card picks a query the CPU's scores rank apart: {topk}")
    if not topk["ranks_differing"] <= topk["ranks_differing_limit"]:
        raise AssertionError(f"more queries trade places than near ties allow: {topk}")
    del gdino, sam, emb, masks, x, gdino_cpu
    torch.cuda.empty_cache()
    return {"ms_per_frame": ms, "host_ms_per_frame": host_ms, "cli_s": cli_s,
            "write_s": write_s, "peak_gib": (peak - base) / 2**30, "held_gib": base / 2**30,
            "foreground": fg, "card_vs_cpu": errs, "topk": topk, **work, "tflops": rates,
            "profiles": profiles}


def phase_auto(device, unet, cn):
    """The denoise segment in auto-mask mode at full width, bf16, 3 steps."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.control.injection import (
        InjectionSpec,
        prepare_injection_masks,
    )
    from motioneditor_tpu_torch.models.controlnet import precompute_cond_embedding
    from motioneditor_tpu_torch.pipelines.editor import denoise_segment
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    dtype = torch.bfloat16
    config, cn_config = pipeline_configs()
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    lat = torch.randn((2, FRAMES, LATENT, LATENT, 4), generator=gen, device=device).to(dtype)
    cond, uncond = (torch.randn((2, 77, 768), generator=gen, device=device).to(dtype)
                    for _ in range(2))
    image = torch.rand((2, FRAMES, 8 * LATENT, 8 * LATENT, 3), generator=gen,
                       device=device).to(dtype)
    src = torch.zeros((FRAMES, LATENT, LATENT), device=device)
    src[:, 16:48, 20:44] = 1.0
    masks = {k: m.to(dtype) for k, m in prepare_injection_masks(src, FRAMES).items()}
    with torch.no_grad():
        cond_emb = precompute_cond_embedding(cn, image)
    schedule = DiffusionSchedule()
    all_ts = schedule.inference_timesteps(50)
    spec = InjectionSpec.from_start_layer(10, mask_mode="auto", auto_token_idx=(1,))

    def run(ts):
        return denoise_segment(unet, config, cn, cn_config, schedule, 50, spec, 7.5, 1.0, lat,
                               ts, cond, uncond, cond_emb, masks)

    run(all_ts[4:5])  # warm-up step
    torch.cuda.synchronize()
    steps = all_ts[4:7]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = run(steps)
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) * 1e3 / len(steps)
    launches = dict(_build.launch_counts)
    log(f"[auto] {len(steps)} steps, {ms_per_step:.1f} ms/step, launches {launches}")
    if out.shape != lat.shape or not torch.isfinite(out).all():
        raise AssertionError("auto segment output is not finite")
    expect_counts("auto", launches, EXPECTED_PER_AUTO_STEP, len(steps))
    prof = profile_step(lambda: run(all_ts[4:5]))
    log(f"[auto] one more step under torch.profiler: {json.dumps(prof)}")
    return launches, ms_per_step, prof


def phase_split_check(device):
    """Tiny fp32 checks of K8 and K9 at their call sites, kernel path
    against plain path: an auto segment, and the mask injection at a head
    dim the packed kernels decline."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.control.injection import (
        InjectionSpec,
        injected_spatial_attention,
    )
    from motioneditor_tpu_torch.models.controlnet import precompute_cond_embedding
    from motioneditor_tpu_torch.ops.attention import Attention
    from motioneditor_tpu_torch.ops.video_flash import video_flash_supported
    from motioneditor_tpu_torch.pipelines.editor import denoise_segment
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    config, cn_config, unet, cn, gen = build_tiny_models(device, SEED + 14)
    f, hw = 3, 32
    lat = 0.3 * torch.randn((2, f, hw, hw, 4), generator=gen, device=device)
    cond, uncond = (0.3 * torch.randn((2, 7, 16), generator=gen, device=device)
                    for _ in range(2))
    image = torch.rand((2, f, 8 * hw, 8 * hw, 3), generator=gen, device=device)
    masks = {(s, s): (torch.rand((f, s * s, 1), generator=gen, device=device) > 0.5).float()
             for s in (32, 16, 8, 4)}
    with torch.no_grad():
        cond_emb = precompute_cond_embedding(cn, image)
    schedule = DiffusionSchedule()
    spec = InjectionSpec.from_start_layer(10, mask_mode="auto", auto_token_idx=(1, 2),
                                          auto_thres=0.3)
    outs = {}
    for use_flash in (True, False):
        _build.reset_launch_counts()
        outs[use_flash] = denoise_segment(
            unet, config, cn, cn_config, schedule, 50, spec, 7.5, 1.0, lat,
            schedule.inference_timesteps(50)[4:6], cond, uncond, cond_emb, masks,
            use_flash=use_flash)
        torch.cuda.synchronize()
        if use_flash and not _build.launch_counts["flash_attention"]:
            raise AssertionError(f"the auto segment skipped K8: {_build.launch_counts}")
    err = (outs[True] - outs[False]).abs().max().item()
    log(f"[split-check] 2-step fp32 auto segment, kernel vs plain path: max_abs_err={err:.3e}")
    if not torch.isfinite(outs[True]).all() or err > 2e-3:
        raise AssertionError(f"auto kernel path disagrees with the plain path: {err}")

    c, heads, n = 36, 4, 1024  # d = 9
    if video_flash_supported(c, heads):
        raise AssertionError("the packed kernels were meant to decline d = 9")
    with torch.device(device):
        attn = Attention(c, heads=heads)
    with torch.no_grad():
        for prm in attn.parameters():
            prm.uniform_(-c ** -0.5, c ** -0.5, generator=gen)
        x = 0.5 * torch.randn((4, f, n, c), generator=gen, device=device)
        mask = (torch.rand((f, n, 1), generator=gen, device=device) > 0.5).float()
        _build.reset_launch_counts()
        got = injected_spatial_attention(attn, x, heads, mask)
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        want = injected_spatial_attention(attn, x, heads, mask, use_flash=False)
    err = (got - want).abs().max().item()
    log(f"[split-check] split-head mask injection, C={c} heads={heads} N={n}: launches "
        f"{launches}, kernel vs plain path max_abs_err={err:.3e}")
    # exactly these: fp32 at d = 9, so neither K8 nor K9 took a tensor-core body (no ".tc")
    expect_counts("split_head", launches, {"flash_attention": 1,
                                           "fused_injection_attention": 1}, 1)
    if err > 2e-5:
        raise AssertionError(f"split-head kernels disagree with the plain path: {err}")
    return launches


@contextlib.contextmanager
def norm_knobs(on: bool):
    """MOTIONEDITOR_FUSED_GN and MOTIONEDITOR_FUSED_LN set to ``on`` inside."""
    keys = ("MOTIONEDITOR_FUSED_GN", "MOTIONEDITOR_FUSED_LN")
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: "1" if on else "0" for k in keys})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def sum_tolerance(terms, got, ref, what: str) -> float:
    """fp32 sums in two orders: |got - ref| <= 1e-4 x the sum of the terms'
    magnitudes per channel (the summation error bound of either order at
    these lengths is a few 1e-5 of it). Returns the max abs error."""
    err = (got - ref).abs()
    if (err > 1e-4 * terms).any():
        raise AssertionError(f"{what}: off by {(err / terms).max().item():.3e} of |terms|")
    return err.max().item()


def phase_norm_kernels(device):
    """K10 and K11 against their plain versions at the training path's
    shapes; the GroupNorm Function's gradients against autograd of the plain
    group_norm; F.group_norm and add + F.layer_norm as yardsticks."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.models.layers import group_norm
    from motioneditor_tpu_torch.ops.fused_norm import add_layer_norm, add_layer_norm_plain
    from motioneditor_tpu_torch.ops.gn_stats import (
        channel_pair_stats,
        channel_pair_stats_plain,
        pair_stats_plan,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    results = {name: {"max_abs_err": 0.0, "library_ms": None} for name in NORM_KERNELS}
    yardsticks = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        for shape in PAIR_STATS_SHAPES:
            x = (torch.randn(shape, generator=gen, device=device) * 2 + 0.5).to(dtype)
            dy = torch.randn(shape, generator=gen, device=device).to(dtype)
            for pair, (a, b) in (("x,x", (x, x)), ("dy,x", (dy, x))):
                fn = lambda: channel_pair_stats(a, b)  # noqa: E731
                plain = lambda: channel_pair_stats_plain(a, b)  # noqa: E731
                vec = _build.launch_counts["channel_pair_stats.vec"]
                got = fn()
                torch.cuda.synchronize()
                if _build.launch_counts["channel_pair_stats.vec"] != vec + 1:
                    raise AssertionError(f"K10 {shape} did not take its 16-byte body")
                ref = plain()
                af, bf = a.float(), b.float()
                err = max(sum_tolerance(af.abs().sum(1), got[0], ref[0], f"K10 s1 {shape}"),
                          sum_tolerance((af * bf).abs().sum(1), got[1], ref[1], f"K10 s2 {shape}"))
                del af, bf
                again = fn()
                if not all(torch.equal(g, h) for g, h in zip(got, again)):
                    raise AssertionError("K10 is not deterministic")
                ms, plain_ms = time_ms(fn, reps=KERNEL_REPS), time_ms(plain, reps=20)
                r = results["channel_pair_stats"]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                at = f"{dt} {list(shape)} ({pair})"
                # each input read once (a once when b is a), both [B, C] fp32 sums written
                moved = nbytes(a) + (0 if b is a else nbytes(b)) + 2 * got[0].numel() * 4
                bd = bound(3.0 * a.numel(), moved, dtype)
                log(f"[norm] channel_pair_stats {at}: max_abs_err={err:.3e} kernel {ms:.4f} ms "
                    f"({KERNEL_REPS} launches), {100 * bd['bound_ms'] / ms:.1f}% of the "
                    f"{bd['bound_ms']:.4f} ms byte bound, plain {plain_ms:.4f} ms; plan "
                    f"{tuple(pair_stats_plan(*shape, dtype, sm_count, True, b is a))}")
                if dtype == torch.bfloat16:
                    tag = "x".join(map(str, shape)) + ("" if b is a else "_dyx")
                    r[f"ms_{tag}"], r[f"bound_ms_{tag}"] = ms, bd["bound_ms"]
                if dtype == torch.bfloat16 and shape == PAIR_STATS_SHAPES[0] and pair == "x,x":
                    r.update(ms=ms, plain_ms=plain_ms, at=at, **bd)
                    # yardstick: one GroupNorm, statistics and normalization, on a
                    # channels-first copy made before the timing
                    xc = a.transpose(1, 2).contiguous()
                    w = torch.ones(shape[-1], device=device, dtype=dtype)
                    yardsticks["F.group_norm_ms"] = time_ms(
                        lambda: F.group_norm(xc, 32, w, w, 1e-5), reps=20)
                    yardsticks["F.group_norm_at"] = at
                    del xc
            del x, dy
            torch.cuda.empty_cache()
        for shape in ADD_LN_SHAPES:
            t = torch.randn(shape, generator=gen, device=device).to(dtype)
            d = (torch.randn(shape, generator=gen, device=device) * 0.5 + 0.2).to(dtype)
            norm = nn.LayerNorm(shape[-1], device=device)
            with torch.no_grad():
                norm.weight.normal_(1.0, 0.3, generator=gen)
                norm.bias.normal_(0.0, 0.2, generator=gen)
            fn = lambda: add_layer_norm(norm, t, d)  # noqa: E731
            plain = lambda: add_layer_norm_plain(t, d, norm.weight, norm.bias)  # noqa: E731
            with torch.no_grad():
                got = fn()
                torch.cuda.synchronize()
                ref = plain()
                tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else tolerance(dtype)
                for g, h in zip(got, ref):
                    torch.testing.assert_close(g.float(), h.float(), **tol)
                err = max((g.float() - h.float()).abs().max().item() for g, h in zip(got, ref))
                ms, plain_ms = time_ms(fn, reps=KERNEL_REPS), time_ms(plain, reps=20)
            r = results["add_layer_norm"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            at = f"{dt} {list(shape)}"
            log(f"[norm] add_layer_norm {at}: max_abs_err={err:.3e} kernel {ms:.4f} ms "
                f"({KERNEL_REPS} launches), plain {plain_ms:.4f} ms")
            if dtype == torch.bfloat16 and shape == ADD_LN_SHAPES[0]:
                r.update(ms=ms, plain_ms=plain_ms, at=at,
                         **bound(10.0 * t.numel(), nbytes(t, d, t, d), dtype))
                with torch.no_grad():
                    yardsticks["add+F.layer_norm_ms"] = time_ms(lambda: F.layer_norm(
                        t + d, (shape[-1],), norm.weight.to(dtype), norm.bias.to(dtype)), reps=20)
                yardsticks["add+F.layer_norm_at"] = at
            del t, d, got, ref
            torch.cuda.empty_cache()

    # the GroupNorm Function (K10 both ways) against autograd of the plain GroupNorm
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn((1, FRAMES, LATENT, LATENT, 320), generator=gen, device=device) * 2
             + 0.5).to(dtype)
        dy = torch.randn(x.shape, generator=gen, device=device).to(dtype)
        p = nn.GroupNorm(32, 320, device=device)
        with torch.no_grad():
            p.weight.normal_(1.0, 0.3, generator=gen)
            p.bias.normal_(0.0, 0.2, generator=gen)
        grads = {}
        for on in (True, False):
            with norm_knobs(on):
                xi = x.detach().requires_grad_()
                p.zero_grad()
                y = group_norm(p, xi, 32, 1e-5)
                y.backward(dy)
                grads[on] = (y.detach(), xi.grad, p.weight.grad.clone(), p.bias.grad.clone())
        torch.testing.assert_close(grads[True][0].float(), grads[False][0].float(),
                                   **(dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32
                                      else tolerance(dtype)))
        err = grad_error(grads[True][1:], grads[False][1:], dtype)
        log(f"[norm] GroupNorm Function {str(dtype)[6:]} [1, {FRAMES}, {LATENT}, {LATENT}, 320]: "
            f"dx, dscale, dbias vs plain autograd max_abs_err={err:.3e}")
        del x, dy, grads
        torch.cuda.empty_cache()
    log(f"[norm] yardsticks {json.dumps(yardsticks)}")
    return results, yardsticks


def train_step(stage: str, state, cn, config, cn_config, lat, enc, skel, generator, **kw):
    """One train step of ``stage`` through the training modules' entry."""
    from motioneditor_tpu_torch.training import stage1, stage2

    if stage == "stage1":
        return stage1.train_step_stage1(state, lat, enc, generator, config, **kw)
    return stage2.train_step_stage2(state, cn, lat, skel, enc, generator, config, cn_config, **kw)


def phase_train_check(device):
    """A tiny fp32 stage-1 step and stage-2 step, the kernel path (flash on,
    both knobs on) against the plain path (flash off, both knobs off), on
    the same noise (one seed): loss, the trainables' gradients and the
    parameters after one step (Adam eps 1e-4, as tests/test_torch_training.py
    takes it, so that the parameters' agreement follows from the
    gradients')."""
    import copy

    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.training import stage1, stage2
    from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state

    config, cn_config, unet, cn, gen = build_tiny_models(device, SEED + 21)
    cn.requires_grad_(False)
    f, hw = 3, 32  # level-0 attention at N = 1024 reaches every gate
    lat = 0.5 * torch.randn((1, f, hw, hw, 4), generator=gen, device=device)
    enc = 0.5 * torch.randn((1, 7, 16), generator=gen, device=device)
    skel = torch.rand((1, f, 8 * hw, 8 * hw, 3), generator=gen, device=device)
    t = torch.tensor([437], device=device)
    launched = {}
    for stage, modules in (("stage1", stage1.TRAINABLE_MODULES),
                           ("stage2", stage2.TRAINABLE_MODULES)):
        out = {}
        for kernels in (True, False):
            state = make_train_state(copy.deepcopy(unet), modules,
                                     make_optimizer(learning_rate=1e-3, eps=1e-4))
            with norm_knobs(kernels):
                _build.reset_launch_counts()
                with torch.no_grad():  # the forward alone, for K10's backward count
                    if stage == "stage1":
                        stage1.stage1_loss(state.model, config, lat, enc, lat, t,
                                           use_flash=kernels, remat=False)
                    else:
                        stage2.stage2_loss(state.model, cn, config, cn_config, lat, skel, enc,
                                           lat, t, use_flash=kernels, remat=False)
                fwd_pair_stats = _build.launch_counts["channel_pair_stats"]
                _build.reset_launch_counts()
                gen_step = torch.Generator(device=device).manual_seed(SEED + 22)
                state, metrics = train_step(stage, state, cn, config, cn_config, lat, enc, skel,
                                            gen_step, remat=False, use_flash=kernels)
                torch.cuda.synchronize()
                counts = dict(_build.launch_counts)
            out[kernels] = (float(metrics["loss"]),
                            {n: p.grad.clone() for n, p in state.trainable.items()},
                            {n: p.detach().clone() for n, p in state.trainable.items()})
            if kernels:
                launched[stage] = counts
                if counts.get("channel_pair_stats", 0) <= fwd_pair_stats:
                    raise AssertionError(f"{stage}: K10's backward never launched: {counts}")
            elif counts:
                raise AssertionError(f"{stage}: the plain path launched kernels: {counts}")
        (lk, gk, pk), (lp, gp, pp) = out[True], out[False]
        top = max(g.abs().max().item() for g in gp.values())
        gerr = max((gk[n] - gp[n]).abs().max().item() for n in gp) / top
        perr = max((pk[n] - pp[n]).abs().max().item() for n in pp)
        log(f"[train-check] {stage} tiny fp32 step, kernel vs plain path: loss {lk:.7f} vs "
            f"{lp:.7f}, grad max err {gerr:.3e} of max |g|, param max err {perr:.3e}; "
            f"launches {launched[stage]}")
        if abs(lk - lp) > 1e-5 * abs(lp) or gerr > 1e-4 or perr > 1e-6:
            raise AssertionError(f"{stage}: the kernel path disagrees with the plain path")
    needed = ("video_flash_attention", "temporal_flash_attention") + BACKWARD_KERNELS + NORM_KERNELS
    together = add_counts(*launched.values())
    if not all(together.get(k) for k in needed):
        raise AssertionError(f"the tiny training steps skipped a kernel: {together}")
    return together


def phase_train(device):
    """Stage 1 then stage 2 at full width, bf16 frozen weights with fp32
    masters, gradient checkpointing: both knobs on, then off; one more
    stage-1 step with the knobs on under torch.profiler."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.models.controlnet import ControlNetModel
    from motioneditor_tpu_torch.models.layers import init_params
    from motioneditor_tpu_torch.models.unet import UNet3DConditionModel
    from motioneditor_tpu_torch.training import stage1, stage2
    from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state

    dtype = torch.bfloat16
    config, cn_config = pipeline_configs()
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    lat = 0.18215 * torch.randn((1, FRAMES, LATENT, LATENT, 4), generator=gen, device=device)
    enc = torch.randn((1, 77, 768), generator=gen, device=device)
    skel = torch.rand((1, FRAMES, 8 * LATENT, 8 * LATENT, 3), generator=gen, device=device)
    with torch.device(device):
        cn = ControlNetModel(cn_config)
    init_params(cn, gen)
    cn.to(dtype).requires_grad_(False)
    metrics, paths, histograms, profiles = {}, {}, {}, {}
    for stage, modules, expected in (
            ("stage1", stage1.TRAINABLE_MODULES, EXPECTED_PER_STAGE1_STEP),
            ("stage2", stage2.TRAINABLE_MODULES, EXPECTED_PER_STAGE2_STEP)):
        for on in (True, False):
            key = "on" if on else "off"
            with torch.device(device):
                unet = UNet3DConditionModel(config)
            init_params(unet, torch.Generator(device=device).manual_seed(SEED + 31))
            state = make_train_state(unet, modules, make_optimizer(3e-5), frozen_dtype=dtype)
            before = {n: p.detach().clone() for n, p in unet.named_parameters()}

            def step(i):
                g = torch.Generator(device=device).manual_seed(SEED + 40 + i)
                return train_step(stage, state, cn, config, cn_config, lat, enc, skel, g,
                                  remat=True, compute_dtype=dtype)[1]["loss"]

            with norm_knobs(on):
                step(0)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _build.reset_launch_counts()
                t0 = time.perf_counter()
                losses = [step(i + 1) for i in range(TRAIN_STEPS)]
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
                launches = dict(_build.launch_counts)
                if on:  # K10's calls of one more step by [B, S, C], dtype and pair
                    with recorded_pair_stats() as calls:
                        step(TRAIN_STEPS + 1)
                    histograms[stage] = pair_stats_histogram(calls)
                    log(f"[train] {stage} K10 calls of one step by shape: "
                        f"{json.dumps(histograms[stage])}")
            losses = [float(x) for x in losses]
            peak = torch.cuda.max_memory_allocated() / 2**30
            metrics[f"{stage}_ms_per_step_knobs_{key}"] = ms
            metrics[f"{stage}_peak_gib_knobs_{key}"] = peak
            log(f"[train] {stage} knobs {key}: {TRAIN_STEPS} steps, {ms:.1f} ms/step, peak "
                f"{peak:.2f} GiB, losses {losses}, launches {launches}")
            if on:  # one more step under torch.profiler
                calls = expected["channel_pair_stats"]
                for attempt in range(3):  # the profiler at times drops kernel records
                    with norm_knobs(on):
                        _build.reset_launch_counts()
                        profiles[stage] = profile_step(lambda: step(TRAIN_STEPS + 2 + attempt))
                    k10 = k10_in_step(profiles[stage], histograms[stage])
                    # each K10 call is one device kernel
                    if (_build.launch_counts["channel_pair_stats"] != calls
                            or k10["launches"] > calls):
                        raise AssertionError(f"the profiled {stage} step ran {k10['launches']} "
                                             f"K10 kernels for {dict(_build.launch_counts)}")
                    if k10["launches"] == calls:
                        break
                    log(f"[train] the profiler returned {k10['launches']} of {calls} K10 "
                        f"kernels; profiling another {stage} step")
                else:
                    raise AssertionError(f"the profiler never returned {calls} K10 kernels")
                log(f"[train] profiled {stage.replace('stage', 'stage-')} step: "
                    f"{json.dumps(profiles[stage])}")
                metrics[f"{stage}_k10"] = k10
                log(f"[train] K10 in the profiled {stage} step: {json.dumps(k10)}")
            if stage == "stage1" and on:
                forward = {(b, s, c) for b, s, c, dt, pair, n in histograms[stage]
                           if pair == "x,x"}
                if forward != set(unet_group_norm_shapes()):
                    raise AssertionError(f"stage-1 K10 shapes {sorted(forward)} are not the "
                                         "UNet's GroupNorms")
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{stage}: losses are not finite: {losses}")
            moved = {n for n, p in unet.named_parameters() if not torch.equal(p, before[n])}
            if not moved or not moved <= set(state.trainable):
                raise AssertionError(f"{stage}: frozen parameters moved: "
                                     f"{sorted(moved - set(state.trainable))[:5]}")
            want = expected if on else {k: v for k, v in expected.items()
                                        if k.split(".")[0] not in NORM_KERNELS}
            expect_counts(f"{stage} knobs {key}", launches, want, TRAIN_STEPS)
            if on:
                paths[stage] = launches
            del state, unet, before
            torch.cuda.empty_cache()
    del cn
    torch.cuda.empty_cache()
    metrics["k10_calls_per_step"] = histograms
    metrics["stage2_profile"] = profiles["stage2"]
    return paths, metrics, profiles["stage1"]


def k10_in_step(profile: dict, histogram: list) -> dict:
    """K10's kernels in a profiled step: launches and device ms, beside the
    byte bound summed over the step's calls (``histogram``, recorded on
    another step of the same shapes)."""
    moved = sum(n * (b * s * c * (2 if dt == "bfloat16" else 4) * (1 if pair == "x,x" else 2)
                     + 2 * b * c * 4) for b, s, c, dt, pair, n in histogram)
    ms = profile["buckets_ms"].get(K10_BUCKET, 0.0)
    bound_ms = moved / PEAK_BYTES * 1e3
    return {"launches": profile["launches"].get(K10_BUCKET, 0), "calls": sum(
        row[-1] for row in histogram), "device_ms": ms, "bound_ms": bound_ms,
        "share": bound_ms / ms if ms else None}


@contextlib.contextmanager
def recorded_pair_stats():
    """Records (B, S, C, dtype, pair) of every K10 call inside, through the
    module attribute that the GroupNorm Function calls."""
    from motioneditor_tpu_torch.ops import gn_stats

    calls, real = [], gn_stats.channel_pair_stats

    def record(a, b):
        calls.append((*a.shape, str(a.dtype)[6:], "x,x" if b is a else "dy,x"))
        return real(a, b)

    gn_stats.channel_pair_stats = record
    try:
        yield calls
    finally:
        gn_stats.channel_pair_stats = real


def pair_stats_histogram(calls) -> list:
    """[B, S, C, dtype, pair, calls] rows, the most bytes first."""
    counts: dict = {}
    for call in calls:
        counts[call] = counts.get(call, 0) + 1
    return [[*k, n] for k, n in sorted(counts.items(),
                                       key=lambda kv: (-kv[0][0] * kv[0][1] * kv[0][2], kv[0]))]


def motion_frame_kv(x):
    """[B, F, N, C] -> [B, F, 2N, C] = [prev | cur], frame 0's prev itself:
    the K/V the halo builds, here from the whole clip."""
    import torch

    prev = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    return torch.cat([prev, x], dim=2).contiguous()


def temporal_pairs(fq: int, fk: int, causal: bool, off: int) -> int:
    """The (query frame, key frame) pairs K14 computes per site."""
    return sum(min(f + off + 1, fk) if causal else fk for f in range(fq))


def phase_kv_kernels(device):
    """K12-K14 against their plain versions at the one-rank shapes and at
    the shard-local shapes of a 4-way frame split, at both latent sizes
    (d = 40 and 80)."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as library_sdpa

    from motioneditor_tpu_torch.ops.temporal_flash import (
        temporal_flash_attention_global,
        temporal_flash_attention_global_plain,
    )
    from motioneditor_tpu_torch.ops.video_flash import (
        video_flash_attention_kv,
        video_flash_attention_kv_plain,
        video_injection_attention_kv,
        video_injection_attention_kv_plain,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 50)
    mask_gen = torch.Generator(device=device).manual_seed(SEED + 57)
    results = {name: {"max_abs_err": 0.0} for name in KV_KERNELS}
    b, f = 2, FRAMES
    fl = f // SPLIT
    for dtype, (n, c) in itertools.product((torch.bfloat16, torch.float32), KERNEL_SHAPES):
        dt = str(dtype).replace("torch.", "")
        d = c // HEADS
        scale = d ** -0.5
        q, k, v, kt, vt = (torch.randn((b, f, n, c), generator=gen, device=device).to(dtype)
                           for _ in range(5))
        mask = (torch.rand((f, n), generator=gen, device=device) > 0.5).float()
        if dtype == torch.bfloat16:
            top = max(logit_bound(q, k, HEADS, scale), logit_bound(q, kt, HEADS, scale))
            if top >= LOGIT_CAP:
                raise AssertionError(f"bf16 inputs reach logit {top} >= {LOGIT_CAP}")
        k_mf, v_mf = motion_frame_kv(k), motion_frame_kv(v)
        m_mf = torch.cat([torch.cat([mask[:1], mask[:-1]]), mask], dim=1).contiguous()
        kd, vd = k.reshape(b, 1, f * n, c), v.reshape(b, 1, f * n, c)

        def kv_case(lo, hi, kk, vv):
            qs = q[:, lo:hi].contiguous()
            kk = kk if kk.shape[1] == 1 else kk[:, lo:hi].contiguous()
            vv = vv if vv.shape[1] == 1 else vv[:, lo:hi].contiguous()
            return ((lambda: video_flash_attention_kv(qs, kk, vv, scale, HEADS)),
                    (lambda: video_flash_attention_kv_plain(qs, kk, vv, scale, HEADS)),
                    4.0 * qs.numel() * kk.shape[2], nbytes(qs, kk, vv, qs))

        def inj_case(lo, hi, mm=m_mf, exact=False):
            """``exact``: the plain version in fp32 (see INJECTION_MASKS)."""
            args = [x[:, lo:hi].contiguous() for x in (q, k_mf, v_mf, kt, vt)]
            ms = mm[lo:hi].contiguous()
            plain_args = [x.float() for x in args] if exact else args
            return ((lambda: video_injection_attention_kv(*args, ms, scale, HEADS)),
                    (lambda: video_injection_attention_kv_plain(*plain_args, ms, scale, HEADS)),
                    4.0 * args[0].numel() * (2 * n + n), nbytes(*args, ms, args[0]))

        def temporal_case(lo, hi):
            qs = q[:, lo:hi].contiguous()
            # the bytes it must move: q, out, and the K/V frames its causal queries read (< hi)
            return ((lambda: temporal_flash_attention_global(qs, k, v, scale, HEADS, True, lo)),
                    (lambda: temporal_flash_attention_global_plain(qs, k, v, scale, HEADS, True,
                                                                   lo)),
                    4.0 * b * n * c * temporal_pairs(hi - lo, f, True, lo),
                    nbytes(qs, k[:, :hi], v[:, :hi], qs))

        one_rank = {}
        cases = [("video_flash_attention_kv", "motion_frame", 0, f, kv_case(0, f, k_mf, v_mf)),
                 ("video_flash_attention_kv", "dense", 0, f, kv_case(0, f, kd, vd)),
                 ("video_injection_attention_kv", "injection", 0, f, inj_case(0, f)),
                 ("temporal_flash_attention_global", "causal", 0, f, temporal_case(0, f))]
        if dtype == torch.bfloat16:  # K13 with the other fg masks, the [F, 2N] of [prev | cur]
            cases += [("video_injection_attention_kv", f"injection {kind}", 0, f,
                       inj_case(0, f, fg_mask(kind, (f, 2 * n), device, mask_gen), True))
                      for kind in INJECTION_MASKS if kind != "binary"]
        for r in range(SPLIT):
            lo, hi = r * fl, (r + 1) * fl
            cases += [("video_flash_attention_kv", "motion_frame", lo, hi,
                       kv_case(lo, hi, k_mf, v_mf)),
                      ("video_flash_attention_kv", "dense", lo, hi, kv_case(lo, hi, kd, vd)),
                      ("video_injection_attention_kv", "injection", lo, hi, inj_case(lo, hi)),
                      ("temporal_flash_attention_global", "causal", lo, hi,
                       temporal_case(lo, hi))]
        for name, variant, lo, hi, (kernel_fn, plain_fn, flops, moved) in cases:
            out = kernel_fn()
            torch.cuda.synchronize()
            ref = plain_fn()
            err = (out.float() - ref.float()).abs().max().item()
            torch.testing.assert_close(out.float(), ref.float(), **tolerance(dtype))
            whole = hi - lo == f
            if whole:
                one_rank[(name, variant)] = out
            else:  # a shard gives its slice of the one-rank output
                torch.testing.assert_close(out.float(), one_rank[(name, variant)][:, lo:hi].float(),
                                           **tolerance(dtype))
            r = results[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            at = (f"{dt} q [{b}, {hi - lo}, {n}, {c}] {variant}"
                  + ("" if whole else f", shard {lo // fl} of {SPLIT}"))
            main = (dtype == torch.bfloat16 and whole and n == 4096
                    and variant in ("motion_frame", "injection", "causal"))
            timing = ""
            temporal_ = name == "temporal_flash_attention_global"
            if whole or dtype == torch.bfloat16 or temporal_:
                reps = KERNEL_REPS if temporal_ else 3
                ms, plain_ms = time_ms(kernel_fn, reps), time_ms(plain_fn)
                timing = f" kernel {ms:.4f} ms ({reps} launches), plain {plain_ms:.3f} ms"
                if main:
                    r.update(ms=ms, plain_ms=plain_ms, at=at, library_ms=None,
                             **bound(flops, moved, dtype))
            if temporal_:  # K14: its bound (bytes at these shapes) and its share of it
                b_ = bound(flops, moved, dtype)
                timing += (f", {b_['bound_by']} bound {b_['bound_ms']:.4f} ms, "
                           f"{100 * b_['bound_ms'] / ms:.1f}% of it")
            if dtype == torch.bfloat16 and not temporal_:  # K12, K13
                b_ = bound(flops, moved, dtype)
                timing += (scaled_line(r, scaled_error(out, ref))
                           + f", {flops / ms / 1e9:.1f} TFLOP/s, "
                           f"{100 * b_['bound_ms'] / ms:.1f}% of its bound")
            lib = ""
            if dtype == torch.bfloat16 and whole and variant == "injection":
                # the CUDA-core body on the same bf16 inputs, called directly
                cc_ms = time_ms(cuda_core_injection(q, k_mf, v_mf, kt, vt, m_mf, ref, scale,
                                                    2 * n))
                lib += f", CUDA-core body {cc_ms:.3f} ms"
                if main:
                    r["cuda_core_ms"] = cc_ms
            if temporal_:
                # SDPA with a boolean (query frame, key frame) mask, g <= f + lo, on
                # [B*N, H, F, d] copies made before the timing
                def temporal(x):
                    return x.view(b, -1, n, HEADS, d).permute(0, 2, 3, 1, 4).flatten(0, 1)

                lq, lk, lv, lref = temporal(q[:, lo:hi]), temporal(k), temporal(v), temporal(ref)
                keep = (torch.arange(f, device=device)[None, :]
                        <= torch.arange(lo, hi, device=device)[:, None])
                lib_ms = library_time(dtype, lref, lambda: library_sdpa(
                    lq, lk, lv, attn_mask=keep, scale=scale))
                lib += f", SDPA with a boolean mask {lib_ms:.4f} ms"
                if main:
                    r["library_ms"], r["library_at"] = lib_ms, at
                del lq, lk, lv, lref
            elif main:
                if name == "video_injection_attention_kv":
                    # SDPA on split-head views of q against the 2M + N keys
                    # [K*m | K*(1-m) | K_tgt] of every frame, made before the timing
                    lq, lk, lv, split_ = injection_keys(q, k_mf, v_mf, kt, vt, m_mf)
                    lref = split_(ref)
                    lib_fn = lambda: library_sdpa(lq, lk, lv, scale=scale)  # noqa: E731
                else:  # K12: SDPA on [B*F, H, N, d] against [B*F, H, 2N, d], split-head views
                    def split(x):
                        return x.view(-1, x.shape[2], HEADS, d).transpose(1, 2)

                    lq, lk, lv, lref = split(q), split(k_mf), split(v_mf), split(ref)
                    lib_fn = lambda: library_sdpa(lq, lk, lv, scale=scale)  # noqa: E731
                r["library_ms"] = library_time(dtype, lref, lib_fn)
                r["library_at"] = at
                lib += f", library {r['library_ms']:.3f} ms"
                del lq, lk, lv, lref
            log(f"[kv] {name} {at}: max_abs_err={err:.3e}{timing}{lib}")
            del out, ref
            torch.cuda.empty_cache()
        del q, k, v, kt, vt, k_mf, v_mf, kd, vd, one_rank
        torch.cuda.empty_cache()
    return results


def timed_steps(fn, steps: int, barrier):
    """ms per step of ``fn()`` (one call of ``steps`` steps) and its result,
    every rank starting and ending together."""
    import torch

    torch.cuda.synchronize()
    barrier()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    barrier()
    return (time.perf_counter() - t0) * 1e3 / steps, out


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals given in microseconds."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e6


def device_busy_share(fn) -> dict:
    """The shares of the wall time of one call of ``fn`` (which ends in a
    synchronize) in which the device ran a compute kernel, and an NCCL
    kernel (those include waiting for peers): unions of the kernels'
    intervals from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    nccl = [(e.time_range.start, e.time_range.end) for e in kernels if "nccl" in e.name.lower()]
    compute = [(e.time_range.start, e.time_range.end) for e in kernels
               if "nccl" not in e.name.lower()]
    return {"compute": union_seconds(compute) / wall, "nccl": union_seconds(nccl) / wall}


# device-time buckets of a profiled step: the first whose substrings the
# kernel's name contains (lower case)
K10_BUCKET = "K10 GroupNorm pair statistics (pair_stats)"
PROFILE_BUCKETS = (
    ("K4 forward with lse (attention_tc_lse)", ("attention_tc_lse",)),
    ("K5 dq (attention_tc_dq)", ("attention_tc_dq",)),
    ("K6 dk/dv (attention_tc_dkv)", ("attention_tc_dkv",)),
    ("K7 temporal backward (temporal_bwd)", ("temporal_bwd",)),
    ("K2/K13 injection (attention_tc_inj)", ("attention_tc_inj",)),
    ("tensor-core attention, K1/K8/K12 (attention_tc)", ("attention_tc",)),
    ("CUDA-core K1/K2/K4/K12/K13, fp32 (video_attention_kernel)", ("video_attention_kernel",)),
    ("K3/K14 temporal forward (temporal_attention_tma)", ("temporal_attention",)),
    ("K8/K9 CUDA-core body (split_attention_kernel)", ("split_attention",)),
    ("cuBLAS / CUTLASS matmuls", ("gemm", "xmma", "cutlass", "nvjet", "matmul")),
    ("cuDNN convs (+ layout kernels)", ("conv", "cudnn", "implicit", "nchw", "nhwc")),
    ("copies / cat / index", ("copy", "cat", "index", "gather", "scatter")),
    (K10_BUCKET, ("pair_stats",)),
    ("K11 add + LayerNorm (add_layer_norm)", ("add_layer_norm",)),
    ("norm and other reductions", ("norm", "welford", "reduce")),
    ("softmax", ("softmax",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
)


def profile_step(fn, top: int = 0) -> dict:
    """One call of ``fn`` (one step, ending in a synchronize) under
    torch.profiler: wall ms, the device's busy share (the union of kernel
    intervals over the wall time), kernel time in ms and kernels per bucket;
    with ``top``, the ``top`` kernels by total time (ms, launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    buckets: dict = {}
    launches: dict = {}
    for e in kernels:
        name = e.name.lower()
        bucket = next((b for b, keys in PROFILE_BUCKETS if any(k in name for k in keys)),
                      "other")
        buckets[bucket] = buckets.get(bucket, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
        launches[bucket] = launches.get(bucket, 0) + 1
    busy = union_seconds([(e.time_range.start, e.time_range.end) for e in kernels]) / wall
    out = {"wall_ms": wall * 1e3, "busy_share": busy, "kernel_ms": sum(buckets.values()),
           "buckets_ms": dict(sorted(buckets.items(), key=lambda kv: -kv[1])),
           "launches": launches}
    if top:
        by_name: dict = {}
        for e in kernels:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
        out["top_kernels"] = {name[:80]: v for name, v in
                              sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]}
    return out


def sass_mma_counts(library) -> dict:
    """Tensor-core instructions (HGMMA: wgmma; HMMA: mma.sync) in the SASS of
    each tensor-core attention kernel of ``library``; empty when the host
    has no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          timeout=300).stdout
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
        elif fn and "attention_tc" in fn:
            for op in ("HGMMA", "HMMA"):
                if op in line:
                    counts.setdefault(fn, {"HGMMA": 0, "HMMA": 0})[op] += 1
    return counts


def ptxas_usage(build_log: str, kernel: str = "attention_tc") -> dict:
    """Registers and spilled bytes of each kernel whose name holds ``kernel``
    (by default the tensor-core attention kernels), from the ``-Xptxas -v``
    lines of the build log."""
    import re

    usage: dict = {}
    fn = None
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\S+?)'?$", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
        elif fn and (m := re.search(r"(\d+) bytes spill stores", line)):
            usage.setdefault(fn, {})["spill_bytes"] = int(m.group(1))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            usage.setdefault(fn, {})["registers"] = int(m.group(1))
    return usage


def shard_or_keep(ctx):
    """``shard_video`` over ``ctx``, or the identity when ``ctx`` is None."""
    from motioneditor_tpu_torch.parallel.mesh import shard_video

    return (lambda x, **kw: shard_video(x, ctx, **kw)) if ctx else (lambda x, **kw: x)


def phase_sharded(device, ctx, barrier=lambda: None, reference=False):
    """The frame-sharded paths at full width over ``ctx`` (one rank here,
    several in chip_sharded.py): the injected denoise segment, inversion and
    null-text on phase 6's schedule, the pipeline from frames to frames on
    phase 7's, then a stage-1 and a stage-2 step; with ``reference`` this
    rank then times the same runs unsharded."""
    import torch

    dtype = torch.bfloat16
    config, cn_config = pipeline_configs()
    unet, cn = build_models(config, cn_config, device, dtype, SEED)
    paths, metrics = {}, {}
    for part in (sharded_segment, sharded_null_text, sharded_pipeline):
        got_paths, got = part(device, ctx, unet, cn, barrier, reference)
        paths.update(got_paths)
        metrics.update(got)
        barrier()
    del unet
    torch.cuda.empty_cache()
    for stage in (1, 2):
        got_paths, got = sharded_train(device, ctx, cn, stage, barrier, reference)
        paths.update(got_paths)
        metrics.update(got)
        barrier()
    del cn
    torch.cuda.empty_cache()
    return paths, metrics


def sharded_segment(device, ctx, unet, cn, barrier, reference):
    """The injected denoise segment, 3 steps after a warm-up step, and the
    device's busy share of one more."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.control.injection import (
        InjectionSpec,
        prepare_injection_masks,
    )
    from motioneditor_tpu_torch.models.controlnet import precompute_cond_embedding
    from motioneditor_tpu_torch.parallel.mesh import gather_video
    from motioneditor_tpu_torch.pipelines.editor import denoise_segment
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    dtype = torch.bfloat16
    config, cn_config = pipeline_configs()
    gen = torch.Generator(device=device).manual_seed(SEED + 60)
    lat = torch.randn((2, FRAMES, LATENT, LATENT, 4), generator=gen, device=device).to(dtype)
    cond, uncond = (torch.randn((2, 77, 768), generator=gen, device=device).to(dtype)
                    for _ in range(2))
    image = torch.rand((2, FRAMES, 8 * LATENT, 8 * LATENT, 3), generator=gen,
                       device=device).to(dtype)
    src = torch.zeros((FRAMES, LATENT, LATENT), device=device)
    src[:, 16:48, 20:44] = 1.0
    masks = {key: m.to(dtype) for key, m in prepare_injection_masks(src, FRAMES).items()}
    schedule = DiffusionSchedule()
    all_ts = schedule.inference_timesteps(50)
    spec = InjectionSpec.from_start_layer(10)
    steps = all_ts[4:7]

    def segment(ts, shard):
        cut = shard_or_keep(shard)
        with torch.no_grad():
            emb = precompute_cond_embedding(cn, cut(image, branch_axis=True))
        return denoise_segment(
            unet, config, cn, cn_config, schedule, 50, spec, 7.5, 1.0, cut(lat, branch_axis=True),
            ts, cond, uncond, emb, {k: cut(m, frame_dim=0) for k, m in masks.items()},
            shard_ctx=shard)

    segment(all_ts[4:5], ctx)  # warm-up step
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    ms, out = timed_steps(lambda: segment(steps, ctx), len(steps), barrier)
    paths = {"sharded_denoise": dict(_build.launch_counts)}
    metrics = {"denoise_ms_per_step": ms,
               "denoise_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    out = gather_video(out, ctx, branch_axis=True)  # a NCCL all-gather
    metrics["denoise_device_busy"] = device_busy_share(lambda: segment(all_ts[7:8], ctx))
    log(f"[shard] denoise over (1, {ctx.fp}): {len(steps)} steps, {ms:.1f} ms/step, peak "
        f"{metrics['denoise_peak_gib']:.2f} GiB, device busy {metrics['denoise_device_busy']} "
        f"of a profiled step, launches {paths['sharded_denoise']}")
    if out.shape != lat.shape or not torch.isfinite(out).all():
        raise AssertionError("the sharded segment's output is not finite")
    expect_counts("sharded_denoise", paths["sharded_denoise"], EXPECTED_PER_SHARDED_STEP,
                  len(steps))
    if reference:
        segment(all_ts[4:5], None)  # warm-up of the unsharded run
        ms1, ref = timed_steps(lambda: segment(steps, None), len(steps), lambda: None)
        metrics.update(unsharded_denoise_ms_per_step=ms1,
                       denoise_bf16_max_abs_diff=(out.float() - ref.float()).abs().max().item(),
                       unsharded_denoise_device_busy=device_busy_share(
                           lambda: segment(all_ts[7:8], None)))
        log(f"[shard] the same segment unsharded on one card: {ms1:.1f} ms/step, device busy "
            f"{metrics['unsharded_denoise_device_busy']}; bf16 max |sharded - unsharded| "
            f"{metrics['denoise_bf16_max_abs_diff']:.3e}")
    return paths, metrics


def sharded_null_text(device, ctx, unet, cn, barrier, reference):
    """Inversion then null-text optimization on phase 6's schedule (bf16
    compute, inner_steps 1), each timed per step after a warm-up step of
    both, with its launches per step and the peak memory of the two."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.parallel.mesh import gather_video
    from motioneditor_tpu_torch.pipelines.editor import ddim_invert, null_optimization
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    dtype = torch.bfloat16
    config = pipeline_configs()[0]
    gen = torch.Generator(device=device).manual_seed(SEED + 65)
    lat = torch.randn((1, FRAMES, LATENT, LATENT, 4), generator=gen, device=device).to(dtype)
    cond = torch.randn((1, 77, 768), generator=gen, device=device)
    uncond0 = torch.randn((1, 77, 768), generator=gen, device=device)
    schedule = DiffusionSchedule()

    def run(shard, steps, bar):
        x = shard_or_keep(shard)(lat)
        launches = {}
        _build.reset_launch_counts()
        ms_inv, (x_t, all_lat) = timed_steps(lambda: ddim_invert(
            unet, config, schedule, x, cond, steps, normal_infer=False, shard_ctx=shard),
            steps, bar)
        launches["inversion"] = dict(_build.launch_counts)
        _build.reset_launch_counts()
        ms_null, uncond = timed_steps(lambda: null_optimization(
            unet, config, schedule, all_lat, cond, uncond0, steps, 1, 1e-2, 7.5,
            compute_dtype="bfloat16", shard_ctx=shard), steps, bar)
        launches["null_text"] = dict(_build.launch_counts)
        return ms_inv, ms_null, x_t, uncond, launches

    run(ctx, 1, barrier)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    ms_inv, ms_null, x_t, uncond, launches = run(ctx, NULL_STEPS, barrier)
    peak = torch.cuda.max_memory_allocated() / 2**30
    x_t = gather_video(x_t, ctx)
    paths = {f"sharded_{k}": v for k, v in launches.items()}
    metrics = {"inversion_ms_per_step": ms_inv, "null_text_ms_per_step": ms_null,
               "null_text_peak_gib": peak}
    log(f"[shard] inversion and null-text over (1, {ctx.fp}), {NULL_STEPS} steps each: "
        f"{ms_inv:.1f} and {ms_null:.1f} ms/step, peak {peak:.2f} GiB, launches {paths}")
    if not (torch.isfinite(x_t).all() and torch.isfinite(uncond).all()):
        raise AssertionError("the sharded inversion or null-text is not finite")
    if uncond.shape != (NULL_STEPS, 1, 77, 768) or torch.equal(uncond[0], uncond0[0]):
        raise AssertionError("the sharded null-text left the embedding unchanged")
    expect_counts("sharded_inversion", paths["sharded_inversion"],
                  EXPECTED_PER_SHARDED_INVERSION_STEP, NULL_STEPS)
    expect_counts("sharded_null_text", paths["sharded_null_text"],
                  EXPECTED_PER_SHARDED_NULL_STEP, NULL_STEPS)
    if reference:
        run(None, 1, lambda: None)
        ms_inv1, ms_null1, x_t1, _, _ = run(None, NULL_STEPS, lambda: None)
        metrics.update(unsharded_inversion_ms_per_step=ms_inv1,
                       unsharded_null_text_ms_per_step=ms_null1,
                       inversion_bf16_max_abs_diff=(x_t.float() - x_t1.float()).abs().max().item())
        log(f"[shard] the same inversion and null-text unsharded on one card: {ms_inv1:.1f} and "
            f"{ms_null1:.1f} ms/step; bf16 max |x_T sharded - unsharded| "
            f"{metrics['inversion_bf16_max_abs_diff']:.3e}")
    return paths, metrics


def sharded_pipeline(device, ctx, unet, cn, barrier, reference):
    """MotionEditorPipeline with the ``shard_ctx`` from frames to frames,
    run_pipeline's parts and schedule (phase 7's), then the p2p edit of the
    same inputs (phase 12's)."""
    import torch

    from motioneditor_tpu_torch.models.clip_text import StubTokenizer
    from motioneditor_tpu_torch.pipelines.editor import MotionEditorPipeline

    dtype = torch.bfloat16
    vae, text = pipeline_models(device, dtype, torch.Generator(device=device).manual_seed(SEED + 66))

    def run(shard, bar):
        pipe = MotionEditorPipeline(unet=unet, vae=vae, text_encoder=text, controlnet=cn,
                                    tokenizer=StubTokenizer(), unet_config=pipeline_configs()[0],
                                    shard_ctx=shard)
        got, paths, state = run_pipeline(
            pipe, torch.Generator(device=device).manual_seed(SEED + 67), SEED + 68,
            "sharded_pipeline" if shard else "pipeline", bar)
        # the p2p edit of the same inputs (phase 12's, frame sharded)
        got["p2p_edit_ms_per_step"], launches, _ = run_edit(pipe, state, True, bar)
        paths[f"{'sharded_' if shard else ''}p2p_pipeline_edit"] = launches
        return got, paths

    got, paths = run(ctx, barrier)
    log(f"[shard] the pipeline over (1, {ctx.fp}): {json.dumps(got)}; launches {paths}")
    expect_counts("sharded_p2p_pipeline_edit", paths["sharded_p2p_pipeline_edit"], add_counts(
        scaled(EXPECTED_PER_SHARDED_VANILLA_STEP, PIPE_START),
        scaled(EXPECTED_PER_SHARDED_STEP, PIPE_STEPS - PIPE_START)), 1)
    expect_counts("sharded_pipeline_inversion", paths["sharded_pipeline_inversion"], add_counts(
        scaled(EXPECTED_PER_SHARDED_INVERSION_STEP, PIPE_STEPS),
        scaled(EXPECTED_PER_SHARDED_NULL_STEP, PIPE_STEPS)), 1)
    expect_counts("sharded_pipeline_edit", paths["sharded_pipeline_edit"], add_counts(
        scaled(EXPECTED_PER_SHARDED_VANILLA_STEP, PIPE_START),
        scaled(EXPECTED_PER_SHARDED_STEP, PIPE_STEPS - PIPE_START)), 1)
    metrics = {"pipeline": got}
    if reference:
        metrics["unsharded_pipeline"], _ = run(None, lambda: None)
        log(f"[shard] the same pipeline unsharded on one card: "
            f"{json.dumps(metrics['unsharded_pipeline'])}")
    del vae, text
    return paths, metrics


def sharded_train(device, ctx, cn, stage: int, barrier, reference):
    """One stage-``stage`` step after a warm-up step, gradient checkpointing
    on, knobs off, bf16 frozen weights with fp32 masters: ms, peak memory,
    launches and the device's busy share of one more step."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.models.layers import init_params
    from motioneditor_tpu_torch.models.unet import UNet3DConditionModel
    from motioneditor_tpu_torch.training import stage1, stage2
    from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state

    dtype = torch.bfloat16
    config, cn_config = pipeline_configs()
    module = stage1 if stage == 1 else stage2
    gen = torch.Generator(device=device).manual_seed(SEED + 60 + stage)
    lat = 0.18215 * torch.randn((1, FRAMES, LATENT, LATENT, 4), generator=gen, device=device)
    enc = torch.randn((1, 77, 768), generator=gen, device=device)
    skel = torch.rand((1, FRAMES, 8 * LATENT, 8 * LATENT, 3), generator=gen, device=device)
    cn.requires_grad_(False)

    def train(shard):
        with torch.device(device):
            model = UNet3DConditionModel(config)
        init_params(model, torch.Generator(device=device).manual_seed(SEED + 61))
        state = make_train_state(model, module.TRAINABLE_MODULES, make_optimizer(3e-5),
                                 frozen_dtype=dtype)
        before = {name: p.detach().clone() for name, p in model.named_parameters()}
        cut = shard_or_keep(shard)
        x, s = cut(lat), cut(skel)

        def step(i):
            g = torch.Generator(device=device).manual_seed(SEED + 62 + i)
            return float(train_step(f"stage{stage}", state, cn, config, cn_config, x, enc, s, g,
                                    remat=True, compute_dtype=dtype,
                                    shard_ctx=shard)[1]["loss"])

        step(0)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        ms, loss = timed_steps(lambda: step(1), 1, barrier if shard else lambda: None)
        launches, peak = dict(_build.launch_counts), torch.cuda.max_memory_allocated() / 2**30
        moved = {name for name, p in model.named_parameters() if not torch.equal(p, before[name])}
        if not math.isfinite(loss) or not moved or not moved <= set(state.trainable):
            raise AssertionError(f"stage {stage}: loss {loss}, or frozen parameters moved")
        return ms, loss, launches, peak, device_busy_share(lambda: step(2))

    name = f"stage{stage}"
    ms, loss, launches, peak, busy = train(ctx)
    metrics = {f"{name}_ms_per_step": ms, f"{name}_peak_gib": peak, f"{name}_loss": loss,
               f"{name}_device_busy": busy}
    log(f"[shard] stage {stage} over (1, {ctx.fp}): {ms:.1f} ms/step, peak {peak:.2f} GiB, "
        f"device busy {busy} of a profiled step, loss {loss}, launches {launches}")
    expected = EXPECTED_PER_SHARDED_STAGE1_STEP if stage == 1 else EXPECTED_PER_SHARDED_STAGE2_STEP
    expect_counts(f"sharded_{name}", launches, expected, 1)
    if reference:
        ms1, loss1, _, _, busy1 = train(None)
        metrics.update({f"unsharded_{name}_ms_per_step": ms1, f"unsharded_{name}_loss": loss1,
                        f"unsharded_{name}_device_busy": busy1})
        log(f"[shard] the same stage-{stage} step unsharded on one card: {ms1:.1f} ms, device "
            f"busy {busy1}, loss {loss1}")
    torch.cuda.empty_cache()
    return {f"sharded_{name}": launches}, metrics


def phase_sharded_check(device, seg_ctx, train_ctx):
    """Tiny fp32 checks on the card (32x32 latents, so level-0 attention
    reaches K12-K14), each sharded path against the unsharded one on the
    same inputs: over ``seg_ctx`` the segment (K1, K2, K3), the segment
    under the p2p controller with LocalBlend, inversion and null-text with
    its early stop reached, and the pipeline's latents; over
    ``train_ctx`` a stage-1 and a stage-2 step (K4-K7): loss, gradients,
    parameters after one AdamW step with eps 1e-4 (TRAIN_CHECKS). Rank 0
    compares."""
    config, cn_config, unet, cn, gen = build_tiny_models(device, SEED + 63)
    models = (config, cn_config, unet, cn, gen)
    launched = {}
    for check, ctx in ((check_segment, seg_ctx), (check_p2p_segment, seg_ctx),
                       (check_null_text, seg_ctx), (check_pipeline, seg_ctx),
                       (check_train, train_ctx)):
        launched.update(check(device, ctx, *models))
    return {"sharded_check": add_counts(*(v for k, v in launched.items()
                                          if k.startswith("sharded")))}


def runs_of(ctx):
    """(name, layout) of the sharded run and, on rank 0, the unsharded one."""
    return [("sharded", ctx)] + ([("unsharded", None)] if ctx.rank == 0 else [])


def check_segment(device, ctx, config, cn_config, unet, cn, gen):
    """The 2-step injected segment in mask mode."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.control.injection import InjectionSpec
    from motioneditor_tpu_torch.models.controlnet import precompute_cond_embedding
    from motioneditor_tpu_torch.parallel.mesh import gather_video
    from motioneditor_tpu_torch.pipelines.editor import denoise_segment
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    f, hw = FRAMES, 32
    lat = 0.3 * torch.randn((2, f, hw, hw, 4), generator=gen, device=device)
    cond, uncond = (0.3 * torch.randn((2, 7, 16), generator=gen, device=device)
                    for _ in range(2))
    image = torch.rand((2, f, 8 * hw, 8 * hw, 3), generator=gen, device=device)
    masks = {(s, s): (torch.rand((f, s * s, 1), generator=gen, device=device) > 0.5).float()
             for s in (32, 16, 8, 4)}
    schedule = DiffusionSchedule()
    launched, outs = {}, {}
    for name, shard in runs_of(ctx):
        cut = shard_or_keep(shard)
        _build.reset_launch_counts()
        with torch.no_grad():
            emb = precompute_cond_embedding(cn, cut(image, branch_axis=True))
        out = denoise_segment(
            unet, config, cn, cn_config, schedule, 50, InjectionSpec.from_start_layer(10), 7.5,
            1.0, cut(lat, branch_axis=True), schedule.inference_timesteps(50)[4:6], cond, uncond,
            emb, {k: cut(m, frame_dim=0) for k, m in masks.items()}, shard_ctx=shard)
        launched[name] = dict(_build.launch_counts)
        outs[name] = gather_video(out, shard, branch_axis=True) if shard else out
    need = {"sharded": SHARDED_KERNELS, "unsharded": FORWARD_KERNELS}
    for name in launched:
        if not all(launched[name].get(k) for k in need[name]):
            raise AssertionError(f"the {name} segment skipped a kernel: {launched[name]}")
    if ctx.rank == 0:
        err = (outs["sharded"] - outs["unsharded"]).abs().max().item()
        log(f"[shard-check] 2-step fp32 segment over (1, {ctx.fp}) vs unsharded: "
            f"max_abs_err={err:.3e}; launches {launched}")
        if not torch.isfinite(outs["sharded"]).all() or err > 2e-3:
            raise AssertionError(f"the sharded segment disagrees with the unsharded one: {err}")
    return launched


def check_p2p_segment(device, ctx, config, cn_config, unet, cn, gen):
    """The 2-step injected segment in mask mode under the replace controller
    with LocalBlend, at a threshold clear of every rank's maps (the least
    gap reduced over the frame group, so every rank picks the same one)."""
    import torch
    import torch.distributed as dist

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.control.injection import InjectionSpec
    from motioneditor_tpu_torch.control.p2p import make_controller, make_local_blend
    from motioneditor_tpu_torch.models.clip_text import StubTokenizer
    from motioneditor_tpu_torch.models.controlnet import precompute_cond_embedding
    from motioneditor_tpu_torch.parallel.mesh import gather_video
    from motioneditor_tpu_torch.pipelines.editor import _count_16x16_sites, denoise_segment
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    f, hw = FRAMES, 32
    lat = 0.3 * torch.randn((2, f, hw, hw, 4), generator=gen, device=device)
    cond, uncond = (P2P_TEXT_SCALE * torch.randn((2, 77, 16), generator=gen, device=device)
                    for _ in range(2))
    image = torch.rand((2, f, 8 * hw, 8 * hw, 3), generator=gen, device=device)
    masks = {(s, s): (torch.rand((f, s * s, 1), generator=gen, device=device) > 0.5).float()
             for s in (32, 16, 8, 4)}
    tokenizer, schedule = StubTokenizer(), DiffusionSchedule()
    controller = make_controller(P2P_PROMPTS, tokenizer, 50)
    alpha = make_local_blend(P2P_PROMPTS, [P2P_WORDS] * 2, tokenizer).alpha_layers

    def run(shard, blend):
        cut = shard_or_keep(shard)
        with torch.no_grad():
            emb = precompute_cond_embedding(cn, cut(image, branch_axis=True))
        local = lat.shape[1] // (shard.fp if shard else 1)
        maps = torch.zeros((_count_16x16_sites(hw, hw), 4 * local, 256, 77), device=device)
        out = denoise_segment(
            unet, config, cn, cn_config, schedule, 50, InjectionSpec.from_start_layer(10), 7.5,
            1.0, cut(lat, branch_axis=True), schedule.inference_timesteps(50)[4:6], cond, uncond,
            emb, {k: cut(m, frame_dim=0) for k, m in masks.items()}, shard_ctx=shard,
            p2p_controller=controller, local_blend=blend, seg_lo=4, maps_sum=maps)
        return gather_video(out, shard, branch_axis=True) if shard else out

    def over_ranks(value, op):
        t = torch.tensor([value], device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN if op == "min" else dist.ReduceOp.MAX,
                        group=ctx.frame_group)
        return t.item()

    threshold = clear_threshold(alpha, lambda blend: run(ctx, blend), over_ranks)
    launched, outs, gaps = {}, {}, []
    for name, shard in runs_of(ctx):
        blend = recording_blend(alpha, threshold)
        _build.reset_launch_counts()
        outs[name] = run(shard, blend)
        launched[f"{name}_p2p"] = dict(_build.launch_counts)
        gaps += [c["gap"] for c in blend.calls]
    if not all(launched["sharded_p2p"].get(k) for k in SHARDED_KERNELS):
        raise AssertionError(f"the sharded p2p segment skipped a kernel: {launched}")
    if ctx.rank == 0:
        err = (outs["sharded"] - outs["unsharded"]).abs().max().item()
        log(f"[shard-check] 2-step fp32 p2p segment (replace + LocalBlend at {threshold:.6f}) "
            f"over (1, {ctx.fp}) vs unsharded: max_abs_err={err:.3e}, least gap to the "
            f"threshold {min(gaps):.2e}; launches {launched}")
        if not torch.isfinite(outs["sharded"]).all() or err > 2e-3 or min(gaps) <= P2P_MARGIN:
            raise AssertionError(f"the sharded p2p segment disagrees with the unsharded one: "
                                 f"{err}")
    return launched


@contextlib.contextmanager
def null_text_objective_calls():
    """(timestep, loss) of every null-text objective call (one per inner
    Adam step) made while the block runs; sharded, the loss is the rank's
    share."""
    from motioneditor_tpu_torch.pipelines import editor

    calls, loss_fn = [], editor.null_text_loss

    def recording_loss(*args, **kwargs):
        loss = loss_fn(*args, **kwargs)
        calls.append((args[8], loss.detach()))
        return loss

    editor.null_text_loss = recording_loss
    try:
        yield calls
    finally:
        editor.null_text_loss = loss_fn


def check_null_text(device, ctx, config, cn_config, unet, cn, gen):
    """3 inversion steps with video attention (the trajectory), then 3
    null-text steps of at most 3 inner steps along each run's own
    trajectory, the early stop between the first two losses of rank 0's
    unsharded run at the first timestep: every rank must take the unsharded
    run's inner steps and end with the same embeddings, bit for bit."""
    import collections

    import torch
    import torch.distributed as dist

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.parallel.mesh import gather_video
    from motioneditor_tpu_torch.pipelines.editor import ddim_invert, null_optimization
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    f, hw, steps, inner = FRAMES, 32, 3, 3
    lat = 0.3 * torch.randn((1, f, hw, hw, 4), generator=gen, device=device)
    cond, uncond0 = (0.3 * torch.randn((1, 7, 16), generator=gen, device=device)
                     for _ in range(2))
    schedule = DiffusionSchedule()
    lead = ctx.rank == 0
    launched, traj, whole = {}, {}, {}
    for name, shard in runs_of(ctx):
        _build.reset_launch_counts()
        _, traj[name] = ddim_invert(unet, config, schedule, shard_or_keep(shard)(lat), cond,
                                    steps, normal_infer=False, shard_ctx=shard)
        launched[f"{name}_inversion"] = dict(_build.launch_counts)
        whole[name] = (gather_video(traj[name], shard, branch_axis=True, frame_dim=2)
                       if shard else traj[name])
    eps = torch.zeros((), device=device)
    if lead:
        with null_text_objective_calls() as calls:
            null_optimization(unet, config, schedule, traj["unsharded"], cond, uncond0, steps,
                              inner, 1e-2, 7.5, early_stop_epsilon=-1.0)
        eps.fill_((calls[0][1] + calls[1][1]).item() / 2)
    dist.broadcast(eps, ctx.frame_ranks[0], group=ctx.frame_group)
    unconds, taken = {}, {}
    for name, shard in runs_of(ctx):
        _build.reset_launch_counts()
        with null_text_objective_calls() as calls:
            unconds[name] = null_optimization(
                unet, config, schedule, traj[name], cond, uncond0, steps, inner, 1e-2, 7.5,
                early_stop_epsilon=eps.item(), shard_ctx=shard)
        launched[f"{name}_null_text"] = dict(_build.launch_counts)
        taken[name] = [t for t, _ in calls]
    ranks = [torch.empty_like(unconds["sharded"]) for _ in range(ctx.fp)]
    dist.all_gather(ranks, unconds["sharded"], group=ctx.frame_group)
    for name in ("sharded_inversion", "sharded_null_text"):
        if not all(launched[name].get(k) for k in SHARDED_STAGE1_LAUNCHES):
            raise AssertionError(f"the {name} path skipped K12 or K14: {launched[name]}")
    if lead:
        err_x = (whole["sharded"] - whole["unsharded"]).abs().max().item()
        err_u = (unconds["sharded"] - unconds["unsharded"]).abs().max().item()
        per_t = collections.Counter(taken["unsharded"])
        log(f"[shard-check] fp32 inversion and null-text over (1, {ctx.fp}) vs unsharded: "
            f"trajectory max_abs_err={err_x:.3e}, uncond max_abs_err={err_u:.3e}; early stop "
            f"at {eps.item():.6f}: inner steps by timestep {dict(per_t)}; launches {launched}")
        if taken["sharded"] != taken["unsharded"] or min(per_t.values()) >= inner:
            raise AssertionError(f"inner steps: sharded {taken['sharded']}, unsharded "
                                 f"{taken['unsharded']}; the early stop must be reached")
        if not all(torch.equal(r, ranks[0]) for r in ranks):
            raise AssertionError("the ranks' null-text embeddings differ")
        if not torch.isfinite(unconds["sharded"]).all() or err_x > 2e-3 or err_u > 2e-3:
            raise AssertionError(f"sharded inversion / null-text disagree: {err_x}, {err_u}")
    return launched


def check_pipeline(device, ctx, config, cn_config, unet, cn, gen):
    """MotionEditorPipeline (a tiny VAE and CLIP text encoder, 256 px) from
    frames to edited latents: a sampled encode, null-text inversion, 3 edit
    steps from start_step 2 with masks and the per-step embeddings."""
    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.models.clip_text import (
        CLIPTextConfig,
        CLIPTextModel,
        StubTokenizer,
    )
    from motioneditor_tpu_torch.models.layers import init_params
    from motioneditor_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from motioneditor_tpu_torch.pipelines.editor import MotionEditorPipeline

    f, size = FRAMES, 256
    vae_config = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                           norm_num_groups=4)
    text_config = CLIPTextConfig(hidden_size=16, num_layers=1, num_heads=2,
                                 intermediate_size=32)
    with torch.device(device):
        vae, text = AutoencoderKL(vae_config), CLIPTextModel(text_config)
    for m in (vae, text):
        init_params(m, gen)
        m.eval()
    video = torch.rand((1, f, size, size, 3), generator=gen, device=device) * 2 - 1
    skeleton = torch.rand((f, size, size, 3), generator=gen, device=device)
    masks = torch.zeros((f, size, size), device=device)
    masks[:, 64:192, 80:176] = 1.0
    prompts = ["a man is dancing", "a man is jumping"]
    launched, outs = {}, {}
    for name, shard in runs_of(ctx):
        pipe = MotionEditorPipeline(unet=unet, vae=vae, text_encoder=text, controlnet=cn,
                                    tokenizer=StubTokenizer(), unet_config=config,
                                    vae_config=vae_config, text_config=text_config,
                                    shard_ctx=shard)
        _build.reset_launch_counts()
        lat = pipe.encode_video(video, generator=torch.Generator(device=device).manual_seed(
            SEED + 69))
        x_t, uncond = pipe.null_text_inversion(lat, prompts[0], num_steps=3)
        outs[name] = pipe(prompts, torch.cat([x_t, x_t]), skeleton, source_masks=masks,
                          uncond_embeddings=uncond, num_inference_steps=3, start_step=2,
                          decode=False)
        launched[f"{name}_pipeline"] = dict(_build.launch_counts)
    if not all(launched["sharded_pipeline"].get(k) for k in SHARDED_KERNELS):
        raise AssertionError(f"the sharded pipeline skipped a kernel: {launched}")
    if ctx.rank == 0:
        err = (outs["sharded"] - outs["unsharded"]).abs().max().item()
        log(f"[shard-check] fp32 pipeline from frames to latents over (1, {ctx.fp}) vs "
            f"unsharded: max_abs_err={err:.3e}; launches {launched}")
        if not torch.isfinite(outs["sharded"]).all() or err > 2e-3:
            raise AssertionError(f"the sharded pipeline disagrees with the unsharded one: {err}")
    return launched


# stage 2's fp32 gradients pass the adapter's ReLU (body.*.block1): when the
# same math runs the ControlNet at other call shapes (a (2, 2) layout's, one
# rank or not), cuDNN's rounding can flip a pre-activation near 0, which
# moves a gradient past this check's limits; in fp64 nothing moves
# (chip_variants.py --stage2-shapes, PERF.md §6). So stage 2's gradients and
# parameters are compared in fp64 on the plain path, its fp32 kernel path by
# the loss; stage 1 (no ReLU) in fp32
TRAIN_CHECKS = (("stage1", "float32", True), ("stage2", "float32", False),
                ("stage2", "float64", True))


def check_train(device, ctx, config, cn_config, unet, cn, gen):
    """A stage-1 and a stage-2 step, gradient checkpointing on; stage 1 and
    stage 2 in fp32 on the kernels, stage 2 also in fp64 on the plain path
    (TRAIN_CHECKS: which runs compare gradients and parameters)."""
    import copy

    import torch

    from motioneditor_tpu_torch import _build
    from motioneditor_tpu_torch.training import stage1, stage2
    from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state

    f, hw = FRAMES, 32
    lat = 0.5 * torch.randn((2, f, hw, hw, 4), generator=gen, device=device)
    enc = 0.5 * torch.randn((2, 7, 16), generator=gen, device=device)
    skel = torch.rand((2, f, 8 * hw, 8 * hw, 3), generator=gen, device=device)
    cn.requires_grad_(False)
    launched = {}
    for stage, dtype_name, compare_grads in TRAIN_CHECKS:
        module = stage1 if stage == "stage1" else stage2
        dtype = getattr(torch, dtype_name)
        kernels = dtype == torch.float32  # the kernels take bf16 and fp32
        cn_run = cn if kernels else copy.deepcopy(cn).to(dtype)
        out = {}
        for name, shard in runs_of(ctx):
            state = make_train_state(copy.deepcopy(unet).to(dtype), module.TRAINABLE_MODULES,
                                     make_optimizer(learning_rate=1e-3, eps=1e-4))
            x, e, s = lat.to(dtype), enc.to(dtype), skel.to(dtype)
            if shard is not None:
                cut = shard_or_keep(shard)
                x, s, e = cut(x), cut(s), e.chunk(shard.dp)[shard.data_rank]
            _build.reset_launch_counts()
            state, metrics = train_step(
                stage, state, cn_run, config, cn_config, x, e, s,
                torch.Generator(device=device).manual_seed(SEED + 64), remat=True,
                use_flash=kernels, shard_ctx=shard)
            if kernels:
                launched[f"{name}_{stage}"] = dict(_build.launch_counts)
            out[name] = (float(metrics["loss"]),
                         {n: p.grad.clone() for n, p in state.trainable.items()},
                         {n: p.detach().clone() for n, p in state.trainable.items()})
        # fp32 here: no launch takes a tensor-core body, so no ".tc" count
        if kernels and not all(launched[f"sharded_{stage}"].get(k)
                               for k in SHARDED_STAGE1_LAUNCHES):
            raise AssertionError(f"the sharded {stage} step skipped a kernel: {launched}")
        if ctx.rank == 0:
            (ls, gs, ps), (lu, gu, pu) = out["sharded"], out["unsharded"]
            top = max(g.abs().max().item() for g in gu.values())
            gerr = max((gs[n] - gu[n]).abs().max().item() for n in gu) / top
            perr = max((ps[n] - pu[n]).abs().max().item() for n in pu)
            log(f"[shard-check] {dtype_name} {stage} step over ({ctx.dp}, {ctx.fp}) vs "
                f"unsharded{'' if kernels else ' (plain path)'}: loss {ls:.9f} vs {lu:.9f}, "
                f"grad max err {gerr:.3e} of max |g|, param max err {perr:.3e} "
                f"({'compared' if compare_grads else 'shown'}); launches "
                f"{launched.get(f'sharded_{stage}') if kernels else {}}")
            if abs(ls - lu) > 1e-5 * abs(lu):
                raise AssertionError(f"the sharded {stage} loss disagrees with the unsharded one")
            if compare_grads and (gerr > 1e-4 or perr > 1e-6):
                raise AssertionError(f"the sharded {stage} step disagrees with the unsharded one")
    return launched


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from motioneditor_tpu_torch import _build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    path, build_log = _build.build()
    if build_log:
        (path.parent / "build.log").write_text(build_log)
    elif (path.parent / "build.log").is_file():
        build_log = (path.parent / "build.log").read_text()
    _build.kernels()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    log(f"[build] ptxas registers and spills of attention_tc: "
        f"{json.dumps(ptxas_usage(build_log))}")
    log(f"[build] ptxas registers and spills of K10's pair_stats_kernel: "
        f"{json.dumps(ptxas_usage(build_log, 'pair_stats_kernel'))}")
    log(f"[build] tensor-core instructions in the SASS of attention_tc: "
        f"{json.dumps(sass_mma_counts(path)) or 'cuobjdump not on this host'}")

    t0 = time.perf_counter()
    results = phase_kernels(device)
    log(f"[kernels] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k3, got = results["temporal_flash_attention"], phase_temporal(device)
    k3["max_abs_err"] = max(k3["max_abs_err"], got.pop("max_abs_err"))
    k3.update(got)
    log(f"[temporal] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    results.update(phase_bwd_kernels(device))
    log(f"[bwd] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    norm_results, yardsticks = phase_norm_kernels(device)
    results.update(norm_results)
    log(f"[norm] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    results.update(phase_kv_kernels(device))
    log(f"[kv] done in {time.perf_counter() - t0:.1f} s")
    k1, k12 = results["video_flash_attention"], results["video_flash_attention_kv"]
    log(f"[kv] the same work, bf16 q [2, {FRAMES}, 4096, 320] against 2N keys per frame, "
        f"both on the tensor-core body: K12 {k12['ms']:.3f} ms, K1 {k1['ms']:.3f} ms, "
        f"SDPA {k12['library_ms']:.3f} (K12's call) and {k1['library_ms']:.3f} ms (K1's)")
    k14 = results["temporal_flash_attention_global"]
    log(f"[kv] the temporal attention, bf16 [2, {FRAMES}, 4096, 320] causal, both on "
        f"csrc/temporal_attention_tma.cu: K14 at Fq = Fk = {FRAMES} {k14['ms']:.4f} ms, K3 "
        f"{results['temporal_flash_attention']['ms']:.4f} ms; SDPA with a boolean mask "
        f"{k14['library_ms']:.4f} ms")
    k2, k13 = results["video_injection_attention"], results["video_injection_attention_kv"]
    log(f"[kv] the injection, bf16 q [2, {FRAMES}, 4096, 320] against 2N source keys scored "
        f"once and N target keys per frame: tensor cores K2 {k2['ms']:.3f} ms, K13 "
        f"{k13['ms']:.3f} ms; CUDA-core bodies {k2['cuda_core_ms']:.3f} and "
        f"{k13['cuda_core_ms']:.3f} ms; SDPA over the 5N injected keys "
        f"{k2['library_ms']:.3f} and {k13['library_ms']:.3f} ms")
    launches, ms_per_step, slice_profile = phase_slice(device)
    phase_check(device)
    phase_null_check(device)
    paths, null_metrics = phase_null_text(device)
    paths["denoise"] = launches
    pipe, pipe_paths, pipe_metrics, pipe_state = phase_pipeline(device)
    paths.update(pipe_paths)
    t0 = time.perf_counter()
    paths["p2p_edit"], p2p_metrics, p2p_profiles, p2p_video = phase_p2p(device, pipe, pipe_state)
    log(f"[p2p] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eval_metrics = phase_eval(device, pipe, pipe_state, p2p_video)
    log(f"[eval] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["weights_edit"], weights_metrics = phase_weights(device, pipe, pipe_state,
                                                           pipe_paths["pipeline_edit"])
    log(f"[weights] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    prep_metrics = phase_prep(device)
    paths["prep"] = dict(_build.launch_counts)
    log(f"[prep] done in {time.perf_counter() - t0:.1f} s; launches {paths['prep']}")
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    masks_metrics = phase_masks(device)
    paths["masks"] = dict(_build.launch_counts)
    log(f"[masks] done in {time.perf_counter() - t0:.1f} s; launches {paths['masks']}")
    if paths["masks"]:
        raise AssertionError(f"phase 16 launched kernels: {paths['masks']}")
    unet, cn = pipe.unet, pipe.controlnet
    del pipe, pipe_state, p2p_video
    torch.cuda.empty_cache()
    paths["auto"], auto_ms, auto_profile = phase_auto(device, unet, cn)
    del unet, cn
    torch.cuda.empty_cache()
    paths["split_head"] = phase_split_check(device)
    t0 = time.perf_counter()
    paths.update(phase_p2p_check(device))
    log(f"[p2p-check] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["train_check"] = phase_train_check(device)
    log(f"[train-check] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_paths, train_metrics, stage1_profile = phase_train(device)
    paths.update(train_paths)
    log(f"[train] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    import torch.distributed as dist

    from motioneditor_tpu_torch.parallel.mesh import init_frame_sharding

    ctx = init_frame_sharding(1, 1, device)  # NCCL, one rank, no network
    try:
        paths.update(phase_sharded_check(device, ctx, ctx))
        shard_paths, shard_metrics = phase_sharded(device, ctx)
        paths.update(shard_paths)
    finally:
        dist.destroy_process_group()
    log(f"[shard] done in {time.perf_counter() - t0:.1f} s")
    sharded_pipe = shard_metrics["pipeline"]
    beside = {  # (sharded in the one-rank group, unsharded phase of this run)
        "inversion_ms_per_step": (shard_metrics["inversion_ms_per_step"],
                                  null_metrics["inversion_ms_per_step"]),
        "null_text_ms_per_step": (shard_metrics["null_text_ms_per_step"],
                                  null_metrics["null_text_ms_per_step"]),
        "null_text_peak_gib": (shard_metrics["null_text_peak_gib"],
                               null_metrics["null_text_peak_gib"]),
        "pipeline_inversion_null_text_ms_per_step": (
            sharded_pipe["inversion_null_text_ms_per_step"],
            pipe_metrics["inversion_null_text_ms_per_step"]),
        "pipeline_edit_ms_per_step": (sharded_pipe["edit_ms_per_step"],
                                      pipe_metrics["edit_ms_per_step"]),
        "pipeline_peak_gib": (sharded_pipe["peak_gib"], pipe_metrics["peak_gib"]),
        "stage1_ms_per_step": (shard_metrics["stage1_ms_per_step"],
                               train_metrics["stage1_ms_per_step_knobs_off"]),
        "stage1_peak_gib": (shard_metrics["stage1_peak_gib"],
                            train_metrics["stage1_peak_gib_knobs_off"]),
        "stage2_ms_per_step": (shard_metrics["stage2_ms_per_step"],
                               train_metrics["stage2_ms_per_step_knobs_off"]),
        "stage2_peak_gib": (shard_metrics["stage2_peak_gib"],
                            train_metrics["stage2_peak_gib_knobs_off"]),
    }
    log(f"[shard] sharded in a one-rank group beside the unsharded phases of this run "
        f"(knobs off): {json.dumps(beside)}")

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = results[name]
        launched = sum(p.get(name, 0) for p in paths.values())
        if not launched:
            raise AssertionError(f"{name} never launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launched, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "cuda_core_ms": r.get("cuda_core_ms"),
            **({"cuda_core_source": CUDA_CORE_SOURCE[name]} if name in CUDA_CORE_SOURCE else {}),
            "at": r["at"],
            "library_at": r.get("library_at"), "flops": r["flops"], "bytes": r["bytes"],
            "tflops": r["flops"] / r["ms"] / 1e9,
            **{k: v for k, v in r.items()
               if k.startswith(("scaled_", "ms_", "bound_ms_", "library_ms_", "gate_"))
               or k.endswith("_32x32")},
        })
    print(json.dumps({"kernels": kernels, "slice_ms_per_step": ms_per_step, **null_metrics,
                      "auto_ms_per_step": auto_ms, "pipeline": pipe_metrics,
                      "p2p": p2p_metrics, "eval": eval_metrics, "weights": weights_metrics,
                      "prep": prep_metrics, "masks": masks_metrics,
                      "train": train_metrics, "norm_yardsticks": yardsticks,
                      "sharded": shard_metrics, "sharded_vs_unsharded": beside,
                      "profiles": {"denoise": slice_profile, "auto": auto_profile,
                                   "p2p": p2p_profiles["p2p"],
                                   "p2p_plain": p2p_profiles["plain"],
                                   "stage1": stage1_profile},
                      "launches_by_path": paths}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
