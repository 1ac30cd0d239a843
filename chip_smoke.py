#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`viewcrafter_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # every phase, on cuda:0

Phases, each printing JSON lines:
  device   the card's name and power limit; TF32 switched off explicitly
  build    compile the hand-written kernels from `viewcrafter_tpu_torch/csrc`;
           a line of its own with ptxas's registers and spill bytes for the
           kernels built on wgmma or TMA (fullkv, dual cross-attention, the
           GEMM core of the temporal conv, the FF layer and the temporal and
           spatial layers' projections, the temporal layer's frame
           attention) and any ptxas note on their wgmma; a spill fails
  wiring   a small config whose every gate takes the kernels: `generate` on
           the card against the same weights, noise and (fixed) prompt ids on
           the CPU; three times: default routes (the fused GroupNorm on, the
           dual cross-attention off), both routes on, and
           routes on at 40 frames (where the temporal attentions leave the layer kernel for
           `temporal_attention_fused`)
  relpos_causal_wiring
           the same small config with the relative-position bias and causal
           temporal attention, card against CPU: every temporal attention
           takes the plain path (the JAX package's gate), so
           `fused_temporal_layer` launches nowhere and the other three
           main-path kernels do
  main     `VideoDiffusionEngine.generate` on the flagship `viewcrafter_25`
           (576x1024x25, B=1, K=2 CFG, 3 DDIM steps, seeded random weights),
           default routes: stage times, peak memory, output checks, launches
           per UNet eval (`group_norm_fused` once per GroupNorm, 166), and a
           torch.profiler breakdown of one more UNet eval by kernel
  routes   the same through an engine built with cross_attn_impl="auto" and
           gn_fused=True, 2 steps, with its own profile
  pab      that engine through `generate_staged` with attn_reuse_interval=3
           at the ds1 sites, 6 steps (two cells), cache stored as bf16 and as
           f8, then bf16 once more with sequential CFG (one UNet call per
           branch, each branch with its own cache): seconds per full and per
           reuse step, the cache's bytes, peak memory, the batched numbers
           beside the sequential ones
  long     a 40-frame copy of `viewcrafter_25_512` (320x512), routes on,
           2 steps: both temporal attentions of every block run
           `temporal_attention_fused`
  op       `fused_spatial_layer`, which no model calls, once at each of its
           three flagship shapes; then the device kernels of one call at each
           shape from torch.profiler (after the counts are read), which must
           be the staging's 4 (LayerNorm, QKV product, attention,
           out-projection)
  geometry_wiring
           a small DUSt3R (128 wide, 2 heads of 64, 128x512 input: S = 256)
           whose every attention takes `fullkv_attention`, on the card
           against the same weights on the CPU, then 10 aligner steps on
           both from the card's pointmaps
  pipeline `ViewCrafterPipeline.run()` (single_view_target) from a seeded
           numpy photo at dust3r_512 + viewcrafter_25, 300 alignment steps,
           2 DDIM steps, seeded random weights; this phase and the three
           below go through `run_mode`: a line per pass with the stage
           times (DUSt3R encode and decode, the MST init, the Adam steps,
           the render, the artifact writes, diffusion prepare / step /
           decode), the geometry seconds, the pass's seconds extrapolated to
           50 DDIM steps, the render's coverage per frame, the images, pairs
           and fullkv launches (encoder, decoder) of each DUSt3R run; then a
           line per phase with peak memory, the four main-path kernels per
           UNet eval, the videos' shapes and finiteness and the files
           written. Here one DUSt3R run of 2 images: fullkv 24/48, sites
           (2,576,576,16,64) x24 and (2,576,576,12,64) x48
  sparse_interp
           sparse_view_interp at the same width, 2 DDIM steps per segment:
           three seeded numpy views panned sideways (3 images, 6 directed
           pairs, the cloud cleaned, 2 segments of 25 frames); fullkv 24
           launches in the encoder and 48 in the decoder
  iterative
           single_view_nbv from the seeded photo, cut to its first 2 of 3
           passes (NBV_PASSES): 2 and 6 images (2 and 30 pairs, the decoder
           in chunks of 8 pairs); per pass the chosen candidate and fullkv's
           24/48 and 24/192 launches (encoder/decoder)
  eval     single_view_eval on the first 6 frames of test/eval1 (6 seeded
           numpy views without PIL): 30 pairs, then frame 0 duplicated
           (fullkv 24/192, then 24/48). Its render must cover pixels in
           frame 0, the identity camera where its two alignments meet; an
           "eval_geometry" line says what the render sees from each camera
           (`eval_geometry`)
  checkpoint
           the released checkpoints' path at full width: seeded weights of
           `viewcrafter_25` and `dust3r_512` (rounded to bf16) written by
           `utils.checkpoint.*_to_reference` in the released containers as
           bf16 leaves (the diffusion file with the legacy `framestride_embed`
           name and an unused key, the DUSt3R file without `dec_blocks2.*`)
           into a temporary directory, loaded by `ViewCrafterPipeline` through
           `ckpt_path` / `model_path`; every loaded tensor must equal its
           source; then one DUSt3R run of 2 images (fullkv 24/48, 10 aligner
           steps) and one `engine.generate` of 2 DDIM steps with the main
           path's launches per UNet eval; file sizes, the seed / write / load
           seconds (`StageTimer`), peak memory
  train_wiring
           `TrainLoop` on the wiring config with both opt-in routes (every
           kernel with a backward but `temporal_attention_fused`), 3 steps
           on the card (bf16, float32 master weights) against the CPU in
           float32, from the same weights, batches and draws: the losses,
           gradient norms and the weights' change within twice the CPU bf16
           run's distance plus floors; then under deterministic algorithms
           the card's run once through and once saved after step 2,
           restored in a new loop and run to the end: bit-identical
  train    the full-width training path: `TrainLoop.run` on
           `viewcrafter_25_512` (1.44 B UNet parameters, counted on the meta
           device), seeded weights, B = 1 clip of 320x512x25, remat and EMA
           on, 4 steps (warmup 1: step 1's lr is 0): s/step, the loss and
           gradient norm per step, launches and backward passes per step,
           whether the weights changed at step 2, peak memory, and step 4
           under torch.profiler split on the device timeline into forward,
           backward, optimizer and EMA (`phase_split`), with its kernel
           categories
  pretrain_wiring
           a small DUSt3R (linear head) and a small CroCo, 128 wide with 2
           heads of 64 at 128x256 (128 tokens; CroCo's visible 64), so that
           fullkv takes every attention: 3 steps each of
           `make_dust3r_train_step` (symmetrized) and
           `make_croco_pretrain_step` (fixed masks) on the card (bf16, float32
           master weights) against the CPU in float32 from the same weights
           and batches, within `compare_runs`' tolerance (the CPU's bf16 run
           the yardstick); fullkv forward and backward at every attention;
           the CroCo translator's round trip of the card's weights; then both
           at dp 2 on 2 gloo ranks sharing cuda:0 against the single rank
  dust3r_train
           DUSt3R fine-tuning at full width and depth: `make_dust3r_train_step`
           on `dust3r_512` (0.57 B parameters), ConfLoss(Regr3D) alpha 0.2,
           mode plain, symmetrized, B = 4 pairs at 384x512 (S = 768) from
           `SyntheticMultiviewGenerator` rendered on the card in the
           Co3dPairDataset layout, the references' AdamW in its warmup, 4
           steps: s/step, peak memory, the step profiled into forward,
           backward and optimizer, fullkv's launches and backward passes per
           step and site, as counted, against the count from the code (per
           model call 24 at (8,768,768,16,64) and 48 at (4,768,768,12,64),
           two calls a step)
  croco_pretrain
           `make_croco_pretrain_step` on the published CroCo (ViT-B encoder,
           512/8/16 decoder, 224x224, mask ratio 0.9), 16 synthetic pairs, 4
           steps: s/step, peak memory; no kernel launches, and why (the
           gate's answer at each attention shape)
  stereoflow_wiring
           a small CroCo downstream (128 wide, 2 heads of 64, crop 128x256:
           128 tokens, decoder depth 8, small DPT widths) with a stereo and a
           flow head, and the monocular encoder, seeded on the card (bf16)
           against the same weights on the CPU: `tiled_pred` on a 160x320
           pair (4 tiles) and on a 96x200 pair smaller than the crop (the
           cubic upscale and the antialiased resize back), the monocular
           forward; then 3 `make_stereoflow_train_step` steps
           (laplacian_loss_bounded2) within `compare_runs`' tolerance; fullkv
           enc_depth + 2 dec_depth times a forward, as many backward passes
           a step
  stereo_tiled
           CroCo-Stereo at the released topology (ViT-L 1024/24/16, decoder
           768/12/12, DPT 96/192/384/768 -> 256 -> 32, 1 + conf), seeded
           weights in bf16: a 375x1242 pair (KITTI 2015's size) at the
           released crop 352x704 (6 tiles, 968 tokens: no fullkv launch, the
           gate's answer printed) and at 384x768 (upscaled to 384x1272, 3
           tiles: fullkv 24 at (6,1152,1152,16,64) and 24 at
           (3,1152,1152,12,64)); CroCo-Flow (2 + conf) on a 436x1024 pair
           (MPI-Sintel's size) at 352x704 (4 tiles): seconds per pair
           (median of 3 after a warm-up), peak memory, tiles, launches
  stereo_train
           `make_stereoflow_train_step` on the same CroCo-Stereo, 2 seeded
           pairs at 352x704 with finite random disparities,
           laplacian_loss_bounded2, the references' AdamW at a constant
           lr 3e-5, 3 steps: s/step, the last step split into forward, backward and
           optimizer, peak memory, fullkv launches (none at 968 tokens), the
           losses
  kernel_grads
           every kernel with a backward (all but `fused_spatial_layer`)
           under grad at every site the training phases launched it with,
           plus KERNEL_GRAD_EXTRA for the one they do not reach: the output
           carries `KernelFunction`'s grad_fn, agrees with the twin's, and
           every input's gradient is the twin's, bit for bit (the backward
           is the twin's VJP); the backward's
           and the forward's ms; then `fused_spatial_layer` must raise under
           grad
  train_sharded_wiring
           the wiring config's train step at dp 2 x sp 2 on 4 gloo ranks on
           cuda:0 (2 clips, frames over sp), one step of a constant lr,
           against the single-rank step on the card, at train_wiring's
           tolerance; every rank launches every kernel and its backward
  sharded_cfg_dp
           multi-device sampling (`generate_staged(mesh=...)`, ranks started
           by `parallel.mesh.spawn`): `viewcrafter_25` at full width, B = 1,
           K = 2, default routes, 2 DDIM steps, first unsharded on this card
           with batched CFG (the reference) and with sequential CFG (the
           yardstick: the same math at other batch sizes); then the two CFG
           branches over dp as 2 ranks sharing cuda:0 over gloo, then as 1
           rank over NCCL through the same mesh code, and as 2 ranks on 2
           cards over NCCL where the machine has them. Each rank builds the
           seeded weights in turn (checked equal with one all_reduce of a
           checksum) and loads the kernels this process built. Rank 0's video
           against the reference: max and mean error within twice the
           yardstick's plus a floor, the share of bit-equal values; a line
           per rank with s/step, peak memory, the main-path launches per UNet
           eval (those of the unsharded run, in every rank) and the
           collectives' seconds per step
  sharded_sp
           the same for `viewcrafter_16` (16 frames) with its frames over sp
           (dp 1 x sp 2, 2 gloo ranks on cuda:0): each temporal module
           gathers the clip's frames through the host
  sharded_wiring
           the wiring config at dp 2 x sp 2, 4 gloo ranks on cuda:0, against
           the CPU's float32 run at `run_wiring`'s tolerance
  sharded_tp
           tensor parallelism at full width: `viewcrafter_25`, B = 1, K = 2,
           default routes, 1 DDIM step (TP_STEPS), the UNet's heads and
           channels over tp (dp 1 x tp 2) as 2 gloo ranks on cuda:0, and on 2
           cards over NCCL where the machine has them, against the unsharded
           run of as many steps at `sharded_cfg_dp`'s tolerance; each rank line adds the
           all-reduces' count, seconds and GiB per step and the rank's launch
           sites (its local heads and widths), and every rank must launch the
           main path's kernels as often per UNet eval as the unsharded run
  sharded_tp_wiring
           the wiring config at 192 channels (3 heads at the 16x16 level:
           an uneven split) with both opt-in routes, at dp 2 x sp 2 x tp 2 on
           8 gloo ranks on cuda:0, against the CPU's float32 run: every rank
           launches all six kernels of the two routes on its local slices
  kernels  each kernel against its plain torch twin at every input shape any
           phase above launched it with (all eight kernels, all paths, the
           wiring runs and the sharded ranks' shapes included: under tp the
           local heads and widths), the two attention kernels once more near
           one-hot (q scaled by 8), the temporal and spatial layers once more
           near one-hot (Wqkv scaled by 4), GroupNorm once more on groups of
           mean 100 and spread 1 in float32 and bf16 (GN_LARGE_MEAN_SITES):
           max_abs_err and rms_rel_err beside
           their tolerances, kernel_ms (CUDA events, median of 10 after
           warm-up), plain_ms, library_ms (one PyTorch call computing the same
           function, or null), bound_ms (the DUSt3R sites of fullkv, up to
           batch 8, with SDPA as library_ms, like every fullkv site); for the
           two attention kernels and the spatial layer also
           mufu_bound_ms, their exponentials over the card's MUFU rate (16
           per SM per clock at the card's maximum SM clock); for the FF,
           temporal and spatial layers also gemm_library_ms, their two
           products as F.linear calls (cuBLAS), and for the temporal layer
           attn_library_ms, F.scaled_dot_product_attention over the frames of
           permuted (B, S, H, T, D) views, and for the spatial layer
           composed_library_ms, F.layer_norm, F.linear, SDPA on (B, H, S, D)
           views and F.linear with the bias in turn: yardsticks for the
           layer's parts or a chain of calls, not one library call for the
           whole function (library_ms stays null);
           the training phases' sites are among them
Every phase that drives a path sets the launch counts to 0 just before it and
reads them just after.
Then one {"kernels": [...]} line (every row but the spatial layer's has
"backward": the plain twin's VJP at its costliest training site with its ms,
and the train phase's launches and backward passes per step, the fullkv
row's also the dust3r_train sites with the launches and backward passes of
each step there, as counted, and both directions' times; the fullkv row also lists its DUSt3R sites
under "dust3r_sites", with the launches of each geometry pass that ran them;
every row lists the sites `sharded_tp`'s ranks launched it at under
"tp_sites", with both ranks' launches; the fullkv row lists the stereo_tiled
phase's 1152-token sites under "stereo_sites", with the launches of one pair;
the GroupNorm row lists its large-mean checks under "large_mean_sites"; the
spatial layer's row has composed_library_ms and mufu_bound_ms),
the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; with no
CUDA device, or outside the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

FLAGSHIP_STEPS = 3
ROUTE_STEPS = 2
PAB_STEPS, PAB_INTERVAL, PAB_SITES = 6, 3, ("down_0", "up_0", "init_attn")
LONG_FRAMES = 40
GEOMETRY_WIRING_STEPS = 10
PIPELINE_NITER, PIPELINE_STEPS = 300, 2
CHECKPOINT_NITER = 10  # aligner steps of the checkpoint phase's DUSt3R run
RELPOS_CAUSAL = {"use_relative_position": True, "use_causal_attention": True}
SHARDED_STEPS, SHARDED_SEED = 2, 5  # the sharded phases' DDIM steps and input seed
# sharded_tp's DDIM steps: one, not SHARDED_STEPS (~35-45 s a step through
# gloo's host-staged all-reduces), to keep the script near 720 s with the
# DUSt3R and CroCo training phases
TP_STEPS = 1
SPAWN_TIMEOUT = 600  # seconds for a sharded phase's ranks to finish
EVAL_FRAMES = 6  # frames of the eval phase's clip (test/eval1 has 25)
# single_view_nbv's passes in the iterative phase (of the mode's 3): the third
# (10 views, ~35-44 s) was cut to keep the script near 720 s when the DUSt3R
# and CroCo training phases came in. Of its fullkv sites only the encoder's
# batch of 8 images (10 encoded as 8 + 2) is launched nowhere else: the
# kernels phase checks it all the same (NBV_PASS3_SITE)
NBV_PASSES = 2
NBV_PASS3_SITE = (8, 576, 576, 16, 64)
SPATIAL_OP_SHAPES = ((50, 9216, 5, 64), (50, 2304, 10, 64), (50, 576, 20, 64))  # (B, S, heads, D)
TRAIN_STEPS, PROFILED_STEP = 4, 4  # the full-width train phase's steps, and the one profiled
TRAIN_WIRING_STEPS = 3
TRAIN_SEED = 11
# the training phases' check that the weights moved at step 2 compares this
# many leading elements of each of the four largest master weights (a small
# copy, so that the check adds nothing visible to the peak memory)
CHANGE_PROBE = 1 << 16
PRETRAIN_WIRING_STEPS = 3
# DUSt3R fine-tuning and CroCo pretraining on the card: the references'
# AdamW (betas 0.9 / 0.95, weight decay 0.05) at their peak learning rates
# (DUSt3R's 512 recipe 1e-4; CroCo's base 1.5e-4 scaled by the batch over
# 256), each step of the run inside a linear warmup of PRETRAIN_WARMUP steps
# from 0, as the references' runs start
DUST3R_STEPS, DUST3R_PAIRS, DUST3R_RES, DUST3R_LR = 4, 4, (384, 512), 1e-4
CROCO_STEPS, CROCO_PAIRS = 4, 16
CROCO_LR = 1.5e-4 * CROCO_PAIRS / 256
PRETRAIN_WARMUP = 100
# the CroCo downstream phases: the wiring's train steps; the tiled phase's
# timed calls a case; the full-width train phase's steps, pairs and constant
# lr (CroCo-Stereo's fine-tuning lr); the data sets' pair sizes (KITTI 2015,
# MPI-Sintel) and the two tile crops (the released one, and the one whose
# 1152 tokens pass fullkv's gate)
STEREO_WIRING_STEPS = 3
STEREO_TILED_REPS = 3
STEREO_TRAIN_STEPS, STEREO_PAIRS, STEREO_LR = 3, 2, 3e-5
KITTI_SIZE, SINTEL_SIZE = (375, 1242), (436, 1024)
RELEASED_CROP, GATED_CROP = (352, 704), (384, 768)
# a kernel no training phase launches gets its backward checked here: the
# long clip's temporal attention at B = 1 (the 512 model at 40 frames), and
# at the wiring config's width
# the train step's record_function ranges (training.py, train_loop.py)
TRAIN_RANGES = ("train_step.forward", "train_step.optimizer", "train_loop.ema")
KERNEL_GRAD_EXTRA = {"temporal_attention_fused": ((1, 40, 2560, 5, 64), (1, 40, 256, 1, 64))}
# the near one-hot sites of the attention kernels (main-path ds2 sites, the
# routes path's ds1 site)
PEAKY_SITES = {"fullkv_attention": (50, 2304, 2304, 10, 64),
               "dual_cross_attention": (50, 9216, 5, 64, 77, 256),
               "fused_temporal_layer": (2, 25, 2304, 640, 10, 64),
               "fused_spatial_layer": (50, 9216, 5, 64)}
# GroupNorm on groups whose mean is large against their spread (x = 100 +
# N(0, 1)), where E[x^2] - mean^2 cancels: kernel against twin in float32 and
# bf16, with the SiLU (N, S, C, groups, itemsize, silu)
GN_LARGE_MEAN_SITES = ((2, 64, 320, 32, 4, 1), (2, 64, 320, 32, 2, 1))
# the kernels built around wgmma and TMA: their ptxas registers and spills
# get a line of their own, and a spill fails the build phase
WGMMA_FUNCTIONS = ("fullkv_kernel", "dual_cross_kernel", "gemm_sm90_kernel",
                   "frame_attention_kernel")
MAIN_KERNELS = ("temporal_conv3", "fused_ff_layer", "fullkv_attention", "fused_temporal_layer")
# GroupNorms of the UNet at the released widths: the engine's default route
# launches `group_norm_fused` once for each per UNet eval
UNET_GROUP_NORMS = 166
# the path whose launch count a kernel's row reports
ROW_PATH = {**{k: "main" for k in MAIN_KERNELS}, "group_norm_fused": "main",
            "dual_cross_attention": "routes", "temporal_attention_fused": "long",
            "fused_spatial_layer": "op"}

# dense bf16 tensor-core peak (TFLOP/s) and memory rate (TB/s) by card,
# from NVIDIA's data sheets; matched against torch.cuda.get_device_name()
CARD_PEAKS = (
    ("H100 PCIe", 756.0, 2.0),
    ("H100 NVL", 835.0, 3.9),
    ("H200", 989.0, 4.8),
    ("H100", 989.0, 3.35),  # SXM5 (HBM3)
)

REPLACES = {
    "temporal_conv3": "viewcrafter_tpu/ops/pallas/temporal_conv.py:67",
    "fused_ff_layer": "viewcrafter_tpu/ops/pallas/ff_layer.py:84",
    "fullkv_attention": "viewcrafter_tpu/ops/pallas/fullkv_attention.py:179",
    "fused_temporal_layer": "viewcrafter_tpu/ops/pallas/temporal_layer.py:127",
    "group_norm_fused": "viewcrafter_tpu/ops/pallas/groupnorm.py:89",
    "dual_cross_attention": "viewcrafter_tpu/ops/pallas/cross_attention.py:92",
    "temporal_attention_fused": "viewcrafter_tpu/ops/pallas/temporal_attention.py:108",
    "fused_spatial_layer": "viewcrafter_tpu/ops/pallas/spatial_layer.py:108",
}
SOURCES = {
    "temporal_conv3": "viewcrafter_tpu_torch/csrc/temporal_conv.cu",
    "fused_ff_layer": "viewcrafter_tpu_torch/csrc/ff_layer.cu",
    "fullkv_attention": "viewcrafter_tpu_torch/csrc/fullkv_attention.cu",
    "fused_temporal_layer": "viewcrafter_tpu_torch/csrc/temporal_layer.cu",
    "group_norm_fused": "viewcrafter_tpu_torch/csrc/groupnorm.cu",
    "dual_cross_attention": "viewcrafter_tpu_torch/csrc/cross_attention.cu",
    "temporal_attention_fused": "viewcrafter_tpu_torch/csrc/temporal_attention.cu",
    "fused_spatial_layer": "viewcrafter_tpu_torch/csrc/spatial_layer.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of `reps` CUDA-event timings of fn() after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_peaks(name: str):
    for key, tflops, tbs in CARD_PEAKS:
        if key in name:
            return tflops * 1e12, tbs * 1e12
    raise RuntimeError(f"no published peaks recorded for {name!r}")


def nvidia_smi(fields: str, *fmt: str) -> str:
    """The first card's `fields`, as nvidia-smi --query-gpu prints them."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                           "--format=" + ",".join(("csv", "noheader") + fmt)],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def mufu_exp_per_s(max_sm_mhz: float) -> float:
    """Exponentials per second on the MUFU: 16 per SM per clock at the card's
    maximum SM clock."""
    import torch

    return 16.0 * torch.cuda.get_device_properties(0).multi_processor_count * max_sm_mhz * 1e6


def bound(flops: float, nbytes: float, peaks) -> dict:
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "gbytes": nbytes / 1e9}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --------------------------------------------------------------------------
# kernel phases
# --------------------------------------------------------------------------


def seeded_randn(gen):
    """randn(*shape, scale=1.0, dtype=bf16): normal draws on the card from
    gen, scaled, in the dtype asked for."""
    import torch

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)
    return randn


def check_kernel(name, site, got, ref, kernel, plain, library, flops, nb, *, peaks, mufu_rate,
                 path_launches=0, plain_reps=3, max_rel=4 * 2.0 ** -8, rms_tol=2.0 ** -7,
                 variant=None, exps=None, extra=None) -> dict:
    """A kernel's output `got` against its twin's `ref` and its times: the
    kernel, the twin, the library call (or null), each timed callable of
    `extra`, the bound from `flops` and `nb` bytes, and with `exps` the
    exponentials over the MUFU's rate. within_limits() judges the result."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise AssertionError(f"{name} at {site}: {got.dtype} {tuple(got.shape)} against "
                             f"{ref.dtype} {tuple(ref.shape)}")
    diff, ref = got.float() - ref.float(), ref.float()
    # both sides round at the same points; a different f32 summation order
    # can flip a bf16 rounding, worth 2^-8 of the value: allow 4 such
    # roundings of the largest output, and an error RMS of 2^-7 of the
    # output's RMS (rounding flips alone stay near 2^-9; a systematic
    # error of 1% does not). A float32 site passes its own, smaller limits.
    err, tol = diff.abs().max().item(), max_rel * ref.abs().max().item()
    rms_rel = (diff.square().mean().sqrt() / ref.square().mean().sqrt()).item()
    del diff, ref
    res = {"phase": "kernel", "name": name, "site": list(site), "variant": variant,
           "path_launches": path_launches, "max_abs_err": err, "tol": tol,
           "rms_rel_err": rms_rel, "rms_tol": rms_tol, "kernel_ms": time_ms(kernel),
           "plain_ms": time_ms(plain, reps=plain_reps, warmup=1),
           "library_ms": time_ms(library) if library is not None else None,
           **bound(flops, nb, peaks)}
    if exps is not None:
        res["mufu_bound_ms"] = exps / mufu_rate * 1e3
    for key, fn in (extra or {}).items():
        res[key] = time_ms(fn)
    return res


def within_limits(res: dict) -> None:
    if not (res["max_abs_err"] <= res["tol"] and res["rms_rel_err"] <= res["rms_tol"]):  # and NaN
        raise AssertionError(f"{res['name']} at {res['site']}: max_abs_err {res['max_abs_err']} "
                             f"(tol {res['tol']}), rms_rel_err {res['rms_rel_err']} "
                             f"(tol {res['rms_tol']})")


def spatial_layer_check(spatial_layer, randn, site, check, w_mul=None) -> dict:
    """`fused_spatial_layer` of the module given (this checkout's, or another
    tree's in scripts/time_spatial_layer.py) at site (B, S, heads, D) on
    inputs from randn, Wqkv scaled by w_mul, through check (check_kernel's
    arguments): against its twin, with its bound and MUFU bound, its two
    products alone through cuBLAS (gemm_library_ms) and the function as a
    chain of library calls (composed_library_ms): no single call computes
    it, so library_ms is null."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    b, s, h, d = site
    c = h * d
    x = randn(b, s, c, scale=0.5)
    lw, lb = 1 + randn(c, scale=0.1, dtype=torch.float32), randn(c, scale=0.1, dtype=torch.float32)
    wqkv = randn(3 * c, c, scale=(w_mul or 1.0) * c ** -0.5)
    wo, bo = randn(c, c, scale=c ** -0.5), randn(c, scale=0.1)
    kw = dict(heads=h, dim_head=d)
    args = (x, lw, lb, wqkv, wo, bo)
    y = spatial_layer.fused_spatial_layer(*args, **kw)
    ref = spatial_layer.fused_spatial_layer_plain(*args, **kw)
    n = b * s
    xn, att = randn(n, c), randn(n, c)  # operands of the two products' shapes

    def composed():
        xl = F.layer_norm(x, (c,), lw.to(bf), lb.to(bf), 1e-5)
        q, k, v = F.linear(xl, wqkv).view(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(q, k, v)
        return F.linear(a.transpose(1, 2).reshape(b, s, c), wo, bo)
    return check("fused_spatial_layer", site, y, ref,
                 lambda: spatial_layer.fused_spatial_layer(*args, **kw),
                 lambda: spatial_layer.fused_spatial_layer_plain(*args, **kw), None,
                 2.0 * n * c * 3 * c + 4.0 * b * h * s * s * d + 2.0 * n * c * c,
                 nbytes(*args, y), plain_reps=2, variant=w_mul and f"peaky_wqkv{w_mul:g}",
                 exps=float(b * h * s * s),
                 extra={"gemm_library_ms": lambda: (F.linear(xn, wqkv), F.linear(att, wo)),
                        "composed_library_ms": composed})


def kernel_sites(peaks, gen, sites, mufu_rate):
    """Yield one result dict per (kernel, input shape) of `sites`, the shapes
    the path phases launched each kernel with (`kernels.launch_sites()`)."""
    import torch
    import torch.nn.functional as F

    from viewcrafter_tpu_torch.ops.kernels import (
        cross_attention, ff_layer, fullkv_attention, groupnorm, spatial_layer,
        temporal_attention, temporal_conv, temporal_layer)

    bf = torch.bfloat16
    randn = seeded_randn(gen)

    def check(name, site, *args, variant=None, **kw):
        res = check_kernel(name, site, *args, peaks=peaks, mufu_rate=mufu_rate, variant=variant,
                           path_launches=0 if variant else sites[name][site], **kw)
        emit(res)
        within_limits(res)
        return res

    for site in sites["temporal_conv3"]:
        b, t, s, cin, cout = site
        x, w, bias = randn(b, t, s, cin), randn(cout, 3 * cin, scale=(3 * cin) ** -0.5), randn(cout, scale=0.1)
        y = temporal_conv.temporal_conv3(x, w, bias)
        ref = temporal_conv.temporal_conv3_plain(x, w, bias)
        x5 = x.permute(0, 3, 1, 2).unsqueeze(-1)  # (B, Cin, T, S, 1) view
        w5 = w.view(cout, 3, cin).permute(0, 2, 1)[..., None, None].contiguous()
        yield check("temporal_conv3", site, y, ref,
                    lambda: temporal_conv.temporal_conv3(x, w, bias),
                    lambda: temporal_conv.temporal_conv3_plain(x, w, bias),
                    lambda: F.conv3d(x5, w5, bias, padding=(1, 0, 0)),
                    2.0 * b * s * cin * cout * (3 * t - 2), nbytes(x, w, bias, y))
        del x, w, bias, y, ref, x5, w5

    for site in sites["fused_ff_layer"]:
        n, c, i, c_out = site
        x = randn(n, c)
        lw, lb = 1 + randn(c, scale=0.1, dtype=torch.float32), randn(c, scale=0.1, dtype=torch.float32)
        w1, b1 = randn(2 * i, c, scale=c ** -0.5), randn(2 * i, scale=0.1)
        w2, b2 = randn(c_out, i, scale=i ** -0.5), randn(c_out, scale=0.1)
        args = (x, lw, lb, w1, b1, w2, b2)
        y = ff_layer.fused_ff_layer(*args)
        ref = ff_layer.fused_ff_layer_plain(*args)
        # the two products alone through cuBLAS, on operands of their shapes
        xn, g = randn(n, c), randn(n, i)
        yield check("fused_ff_layer", site, y, ref, lambda: ff_layer.fused_ff_layer(*args),
                    lambda: ff_layer.fused_ff_layer_plain(*args), None,
                    2.0 * n * c * 2 * i + 2.0 * n * i * c_out, nbytes(*args, y),
                    extra={"gemm_library_ms": lambda: (F.linear(xn, w1), F.linear(g, w2))})
        del x, w1, w2, y, ref, args, xn, g

    # each driven site, then one near one-hot site (q scaled by 8: the running
    # maximum's rescale and the masked padding decide the result)
    for site, q_mul in [(s, None) for s in sites["fullkv_attention"]] + [(PEAKY_SITES["fullkv_attention"], 8.0)]:
        b, s, sk, h, d = site
        q, k, v = randn(b, s, h, d, scale=q_mul or 1.0), randn(b, sk, h, d), randn(b, sk, h, d)
        y = fullkv_attention.fullkv_attention(q, k, v)
        ref = fullkv_attention.fullkv_attention_plain(q, k, v)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        yield check("fullkv_attention", site, y, ref,
                    lambda: fullkv_attention.fullkv_attention(q, k, v),
                    lambda: fullkv_attention.fullkv_attention_plain(q, k, v),
                    lambda: F.scaled_dot_product_attention(qt, kt, vt),
                    4.0 * b * h * s * sk * d, nbytes(q, k, v, y), plain_reps=2,
                    variant=q_mul and f"peaky_q{q_mul:g}", exps=float(b * h * s * sk))
        del q, k, v, y, ref, qt, kt, vt

    # each driven site, then one near one-hot site (Wqkv scaled by 4: logits
    # 16 times larger, so the masked padded frames and the rounding of the
    # probabilities decide the result)
    # (a tensor-parallel rank's site has its block of the heads: inner =
    # heads * D < C)
    for site, w_mul in ([(s, None) for s in sites["fused_temporal_layer"]]
                        + [(PEAKY_SITES["fused_temporal_layer"], 4.0)]):
        b, t, s, c, h, d = site
        inner = h * d
        x = randn(b, t, s, c)
        lw, lb = 1 + randn(c, scale=0.1, dtype=torch.float32), randn(c, scale=0.1, dtype=torch.float32)
        wqkv = randn(3 * inner, c, scale=(w_mul or 1.0) * c ** -0.5)
        wo, bo = randn(c, inner, scale=inner ** -0.5), randn(c, scale=0.1)
        kw = dict(heads=h, dim_head=d)
        args = (x, lw, lb, wqkv, wo, bo)
        y = temporal_layer.fused_temporal_layer(*args, **kw)
        ref = temporal_layer.fused_temporal_layer_plain(*args, **kw)
        n = b * t * s
        # yardsticks on operands of the parts' shapes: the two products
        # through cuBLAS, the frame attention through SDPA on permuted views
        xn, att = randn(n, c), randn(n, inner)
        q5, k5, v5 = (randn(b, t, s, h, d).permute(0, 2, 3, 1, 4) for _ in range(3))
        yield check("fused_temporal_layer", site, y, ref,
                    lambda: temporal_layer.fused_temporal_layer(*args, **kw),
                    lambda: temporal_layer.fused_temporal_layer_plain(*args, **kw), None,
                    2.0 * n * c * 3 * inner + 4.0 * b * s * h * t * t * d + 2.0 * n * inner * c,
                    nbytes(*args, y), variant=w_mul and f"peaky_wqkv{w_mul:g}",
                    extra={"gemm_library_ms": lambda: (F.linear(xn, wqkv), F.linear(att, wo)),
                           "attn_library_ms": lambda: F.scaled_dot_product_attention(q5, k5, v5)})
        del x, wqkv, wo, y, ref, args, xn, att, q5, k5, v5
    torch.cuda.empty_cache()

    # (a tensor-parallel rank's site has its block of the channels and of
    # the 32 groups)
    for site, large_mean in ([(s, False) for s in sites["group_norm_fused"]]
                             + [(s, True) for s in GN_LARGE_MEAN_SITES]):
        n, s, c, groups, itemsize, silu = site
        dtype = bf if itemsize == 2 else torch.float32
        if large_mean:
            x = (randn(n, s, c, dtype=torch.float32) + 100.0).to(dtype)
        else:
            x = randn(n, s, c, scale=1.5, dtype=dtype) + 0.3
        w = 1 + randn(c, scale=0.1, dtype=torch.float32)
        b = randn(c, scale=0.1, dtype=torch.float32)
        args = (x, w, b, groups, 1e-5, bool(silu))
        y = groupnorm.group_norm_fused(*args)
        ref = groupnorm.group_norm_fused_plain(*args)
        xcf, wl, bl = x.permute(0, 2, 1), w.to(dtype), b.to(dtype)  # channels-first view

        def library(xcf=xcf, wl=wl, bl=bl, silu=silu, groups=groups):
            out = F.group_norm(xcf, groups, wl, bl, 1e-5)
            return F.silu(out) if silu else out
        # float32 input rounds nowhere: kernel and twin differ by the order of
        # their f32 sums and the kernel's fast exp in the SiLU
        tols = {} if itemsize == 2 else {"max_rel": 2.0 ** -14, "rms_tol": 2.0 ** -16}
        yield check("group_norm_fused", site, y, ref,
                    lambda: groupnorm.group_norm_fused(*args),
                    lambda: groupnorm.group_norm_fused_plain(*args), library,
                    8.0 * n * s * c, nbytes(x, w, b, y), variant=large_mean and "large_mean",
                    **tols)
        del x, y, ref, xcf, args, library
    torch.cuda.empty_cache()

    for site, q_mul in [(s, None) for s in sites["dual_cross_attention"]] + [(PEAKY_SITES["dual_cross_attention"], 8.0)]:
        b, s, h, d, lt, li = site
        q = randn(b, s, h, d, scale=q_mul or 1.0)
        kt, vt, ki, vi = randn(b, lt, h, d), randn(b, lt, h, d), randn(b, li, h, d), randn(b, li, h, d)
        args = (q, kt, vt, ki, vi)
        y = cross_attention.dual_cross_attention(*args)
        ref = cross_attention.dual_cross_attention_plain(*args)
        tr = [a.transpose(1, 2) for a in args]

        def library(tr=tr):
            return (F.scaled_dot_product_attention(tr[0], tr[1], tr[2])
                    + F.scaled_dot_product_attention(tr[0], tr[3], tr[4]))
        yield check("dual_cross_attention", site, y, ref,
                    lambda: cross_attention.dual_cross_attention(*args),
                    lambda: cross_attention.dual_cross_attention_plain(*args), library,
                    4.0 * b * h * s * (lt + li) * d, nbytes(*args, y), plain_reps=2,
                    variant=q_mul and f"peaky_q{q_mul:g}", exps=float(b * h * s * (lt + li)))
        del q, y, ref, tr, args, library

    for site in sites["temporal_attention_fused"]:
        b, t, s, h, d = site
        q, k, v = randn(b, t, s, h, d), randn(b, t, s, h, d), randn(b, t, s, h, d)
        y = temporal_attention.temporal_attention_fused(q, k, v)
        ref = temporal_attention.temporal_attention_fused_plain(q, k, v)
        pq, pk, pv = (a.permute(0, 2, 3, 1, 4) for a in (q, k, v))  # (B, S, H, T, D) views
        yield check("temporal_attention_fused", site, y, ref,
                    lambda: temporal_attention.temporal_attention_fused(q, k, v),
                    lambda: temporal_attention.temporal_attention_fused_plain(q, k, v),
                    lambda: F.scaled_dot_product_attention(pq, pk, pv),
                    4.0 * b * s * h * t * t * d, nbytes(q, k, v, y))
        del q, k, v, y, ref, pq, pk, pv

    # each driven site, then one near one-hot site (Wqkv scaled by 4: logits
    # 16 times larger, so the running maximum's rescale and the masking
    # decide the result)
    for site, w_mul in ([(s, None) for s in sites["fused_spatial_layer"]]
                        + [(PEAKY_SITES["fused_spatial_layer"], 4.0)]):
        yield spatial_layer_check(spatial_layer, randn, site, check, w_mul)
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# wiring and main path
# --------------------------------------------------------------------------


def wiring_config(frames: int = 8, **unet_flags):
    """A small ModelConfig whose UNet passes every kernel gate: head dim 64,
    two levels, a 16x16 latent (S = 256 and 64) and `frames` frames (8: the
    layer kernel's gate; 33 to 64: `temporal_attention_fused`'s).
    `unet_flags`: UNetConfig fields to set (the relative-position bias, the
    causal mask)."""
    from viewcrafter_tpu_torch.config import (
        CLIPTextConfig, CLIPVisionConfig, DiffusionConfig, ModelConfig, ResamplerConfig,
        UNetConfig, VAEConfig)

    return ModelConfig(
        name="wiring",
        diffusion=DiffusionConfig(latent_size=(16, 16)),
        unet=UNetConfig(model_channels=64, num_res_blocks=1, attention_resolutions=(1, 2),
                        channel_mult=(1, 2), num_head_channels=64, context_dim=64,
                        temporal_length=frames, **unet_flags),
        vae=VAEConfig(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1),
        resampler=ResamplerConfig(dim=64, depth=1, dim_head=16, heads=4, num_queries=4,
                                  embedding_dim=48, output_dim=64, video_length=4),
        clip_text=CLIPTextConfig(width=64, heads=2, layers=2),
        clip_vision=CLIPVisionConfig(patch_size=56, width=48, heads=2, layers=2),
        video_length=frames, height=128, width=128,
    )


def fixed_prompt_ids(n_words: int, device) -> "torch.Tensor":
    """(1, 77) token ids as `prompt_ids` returns them, the same in every
    process: the words' ids from numpy's default_rng(0) in the tokenizer's
    hash-fallback range (without a BPE file that fallback takes Python's
    salted `hash`, so the ids would change from one run to the next)."""
    import numpy as np
    import torch

    ids = np.zeros((1, 77), np.int64)
    ids[0, :n_words + 2] = [49406, *np.random.default_rng(0).integers(1000, 49000, n_words), 49407]
    return torch.from_numpy(ids).to(device)


def route_kwargs(routes: bool) -> dict:
    return {"cross_attn_impl": "auto", "gn_fused": True} if routes else {}


def run_wiring(gen, routes: bool = False, frames: int = 8, guidance=None, unet_flags=None,
               **staged) -> tuple:
    """`generate_staged` (without `staged` arguments such as attention reuse,
    the same as `generate`) with every kernel on the card against the plain
    path on the CPU: same weights, same
    noise, same routes, same `guidance` (default K = 2 batched). The
    yardstick for the tolerance is the CPU run's own bf16 distance from its
    float32 run. `unet_flags` (e.g. RELPOS_CAUSAL): UNetConfig fields of the
    small config; with a mask or a bias no temporal attention may take a
    kernel. Returns (result, launch sites)."""
    import torch

    from viewcrafter_tpu_torch.models.lvdm import SUBMODELS, VideoDiffusionEngine
    from viewcrafter_tpu_torch.ops import kernels
    from viewcrafter_tpu_torch.sampling.ddim import GuidanceConfig

    unet_flags = unet_flags or {}
    cfg = wiring_config(frames, **unet_flags)
    kw = route_kwargs(routes)
    cuda = VideoDiffusionEngine(cfg, dtype=torch.bfloat16, device="cuda", **kw)
    cuda.init_params(seed=1)
    state = {n: {k: v.float().cpu() for k, v in getattr(cuda, n).state_dict().items()}
             for n in SUBMODELS}
    ref32 = VideoDiffusionEngine(cfg, dtype=torch.float32, device="cpu", **kw)
    ref16 = VideoDiffusionEngine(cfg, dtype=torch.bfloat16, device="cpu", **kw)
    ref32.load_params(state)
    ref16.load_params(state)
    frames_t = torch.rand((1, cfg.video_length, cfg.height, cfg.width, 3), generator=gen,
                          device="cuda") * 2 - 1
    ids, uids = fixed_prompt_ids(6, "cuda"), fixed_prompt_ids(0, "cuda")
    noise = cuda.draw_noise(frames_t.shape, 2, gen)
    kw = dict(staged, steps=2, guidance=guidance or GuidanceConfig())
    kernels.reset_launches()
    out = cuda.generate_staged(frames_t, ids, uids, noise=noise, **kw).cpu()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    cpu_noise = type(noise)(*(t.cpu() for t in (noise.x_T, noise.steps, noise.posterior)))
    o32 = ref32.generate_staged(frames_t.cpu(), ids.cpu(), uids.cpu(), noise=cpu_noise, **kw)
    o16 = ref16.generate_staged(frames_t.cpu(), ids.cpu(), uids.cpu(), noise=cpu_noise, **kw)
    # max and mean distance from the CPU float32 run, each held to twice the
    # CPU bf16 run's own distance (plus a floor)
    err, mean_err = (out - o32).abs().max().item(), (out - o32).abs().mean().item()
    yard, yard_mean = (o16 - o32).abs().max().item(), (o16 - o32).abs().mean().item()
    tol, mean_tol = 2 * yard + 1e-2, 2 * yard_mean + 1e-3
    phase = "relpos_causal_wiring" if unet_flags else "wiring"
    res = {"phase": phase, "routes": routes, "frames": frames, "unet_flags": unet_flags,
           "shape": list(out.shape),
           "sequential_cfg": kw["guidance"].sequential, "staged": staged,
           "max_abs_err_vs_cpu_f32": err,
           "mean_abs_err_vs_cpu_f32": mean_err, "cpu_bf16_vs_f32": yard,
           "cpu_bf16_vs_f32_mean": yard_mean, "tol": tol, "mean_tol": mean_tol,
           "max_abs_err_vs_cpu_bf16": (out - o16).abs().max().item(),
           "output_abs_mean": o32.abs().mean().item(), "launches": counts}
    sites = kernels.launch_sites()
    emit(res)
    if not (err <= tol and mean_err <= mean_tol):
        raise AssertionError(f"{phase}: card vs CPU f32 max {err} (tol {tol}), "
                             f"mean {mean_err} (tol {mean_tol})")
    # the kernels this configuration must reach: the four of the main path
    # (the layer kernel only up to 32 frames) and the fused GroupNorm, the
    # engine's default; the dual cross-attention when asked for, the temporal
    # attention kernel past 32 frames; with a mask or a bias neither temporal
    # kernel
    masked = any(unet_flags.values())
    expect = set(MAIN_KERNELS) - ({"fused_temporal_layer"} if frames > 32 or masked else set())
    expect.add("group_norm_fused")
    if routes:
        expect.add("dual_cross_attention")
    if frames > 32 and not masked:
        expect.add("temporal_attention_fused")
    wrong = [k for k, v in counts.items() if (v > 0) != (k in expect)]
    if wrong:
        raise AssertionError(f"{phase}: launches {counts} do not match the expected set "
                             f"{sorted(expect)}: {wrong}")
    return res, sites


# kernel-name patterns of the profile phase's categories, tried in order
PROFILE_CATEGORIES = (
    ("port:fullkv", "vc::fullkv_kernel"), ("port:temporal_attention", "vc::temporal_att"),
    ("port:dual_cross_attention", "vc::dual_cross_kernel"),
    ("port:group_norm", "vc::group_norm_kernel"), ("port:frame_attention", "vc::frame_attention"),
    ("port:layernorm", "vc::ln_apply_kernel"), ("port:temporal_conv", "LoadConv3"),
    ("port:ff_gemm1_geglu", "LoadGeglu"),
    # one instance of the core: the FF's GEMM2 and the temporal layer's two products
    ("port:gemm_plain", "LoadPlain"),
    ("cudnn_conv", "fprop"), ("cudnn_conv", "conv"), ("cublas_gemm", "gemm"),
    ("cublas_gemm", "nvjet"), ("softmax", "softmax"), ("reduce", "reduce"),
    ("elementwise", "elementwise"), ("cat", "Cat"),
)


def profile_unet_eval(eng, frames, ids, uids, guidance, gen, what: str) -> dict:
    """Device time by kernel of one UNet eval (the K=2 batched denoise call
    of one DDIM step), from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    z_cond = eng.encode_frames(frames)
    contexts = eng.build_contexts(frames, 0, ids, uids, guidance)
    denoise, _, _ = eng._denoise_fn(z_cond, contexts, float(eng.cfg.unet.default_fs), guidance)
    k = guidance.num_branches
    x_k = torch.randn(z_cond.shape, generator=gen, device="cuda").repeat(k, 1, 1, 1, 1)
    t_k = torch.full((k,), 999.0, device="cuda")
    with torch.no_grad():
        denoise(x_k, t_k)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            denoise(x_k, t_k)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    return {"phase": "profile", "what": what, "wall_ms": wall_ms,
            **device_breakdown(prof, wall_ms)}


def is_annotation(evt) -> bool:
    """A `record_function` range mirrored on the device timeline (it spans
    kernels that are counted on their own)."""
    return getattr(evt, "is_user_annotation", False) or evt.name.startswith(TRAIN_RANGES)


def phase_split(prof) -> dict:
    """The profiled train step's phases on the device timeline: forward,
    optimizer and EMA (where the step has one) from their `record_function`
    ranges, the backward
    from the end of the forward to the start of the optimizer (autograd
    launches it from its own thread, outside any range of the main one);
    for each the span and the kernel time that starts inside it (ms)."""
    import torch

    spans, kernels = {}, []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = evt.time_range
        if evt.name in TRAIN_RANGES:
            spans[evt.name] = (t.start, t.end)
        elif not is_annotation(evt):
            kernels.append((t.start, t.end - t.start))
    fwd, opt = spans["train_step.forward"], spans["train_step.optimizer"]
    phases = {"forward": fwd, "backward": (fwd[1], opt[0]), "optimizer": opt}
    if "train_loop.ema" in spans:  # the pretraining steps keep no EMA
        phases["ema"] = spans["train_loop.ema"]
    return {name: {"span_ms": (b - a) / 1e3,
                   "kernel_ms": sum(d for start, d in kernels if a <= start < b) / 1e3}
            for name, (a, b) in phases.items()}


def device_breakdown(prof, wall_ms: float) -> dict:
    """A torch.profiler run's device time: in all, its idle share of
    `wall_ms`, by kernel category (PROFILE_CATEGORIES) and the top kernels."""
    import torch

    kernels, cats = {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA or is_annotation(evt):
            continue
        ms = evt.device_time / 1e3
        name = evt.name
        kernels.setdefault(name, [0.0, 0])
        kernels[name][0] += ms
        kernels[name][1] += 1
        cat = next((c for c, pat in PROFILE_CATEGORIES if pat in name), "other")
        cats[cat] = cats.get(cat, 0.0) + ms
    device_ms = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    return {"device_ms": device_ms, "idle_share": max(0.0, 1 - device_ms / wall_ms),
            "by_category_ms": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
            "top": [[n[:100], v[0], v[1]] for n, v in top]}


def drive(phase: str, cfg, gen, steps: int, routes: bool, profile_what=None, eng=None,
          guidance=None, **staged):
    """One path through the entry points a user calls: build the engine (or
    take `eng`), reset the launch counts, run `generate` (or, with `staged`
    arguments, `generate_staged`) for `steps` DDIM steps on seeded random
    frames with `guidance` (default K = 2 batched), read the counts, check
    the video. Returns (result, launch sites, engine)."""
    import torch

    from viewcrafter_tpu_torch.models.lvdm import VideoDiffusionEngine
    from viewcrafter_tpu_torch.ops import kernels
    from viewcrafter_tpu_torch.sampling.ddim import GuidanceConfig

    setup_s = 0.0
    if eng is None:
        t0 = time.perf_counter()
        eng = VideoDiffusionEngine(cfg, **route_kwargs(routes))  # device=None: the card
        eng.init_params(seed=0)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    frames = torch.rand((1, cfg.video_length, cfg.height, cfg.width, 3), generator=gen,
                        device="cuda") * 2 - 1
    ids, uids = fixed_prompt_ids(6, "cuda"), fixed_prompt_ids(0, "cuda")
    guidance = guidance or GuidanceConfig()  # K = 2, scale 7.5, rescale 0.7
    stamps = []

    def on_stage(name):
        torch.cuda.synchronize()
        stamps.append((name, time.perf_counter(), kernels.launch_counts(), kernels.launch_sites()))

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t_start = time.perf_counter()
    run = eng.generate_staged if staged else eng.generate
    video = run(frames, ids, uids, steps=steps, eta=1.0, guidance=guidance, generator=gen,
                on_stage=on_stage, **staged)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = kernels.launch_counts()
    sites = kernels.launch_sites()
    times = [t_start] + [stamp[1] for stamp in stamps]
    step_kinds = [stamp[0] for stamp in stamps[1:-1]]
    step_s = [times[i + 1] - times[i] for i in range(1, 1 + steps)]
    # launches of the sampling steps alone (the VAE's GroupNorms run in
    # prepare and decode), per UNet eval
    per_eval = {k: (stamps[-2][2][k] - stamps[0][2][k]) / steps for k in counts}
    step_sites = {k: {site: n - stamps[0][3][k].get(site, 0) for site, n in v.items()
                      if n > stamps[0][3][k].get(site, 0)} for k, v in stamps[-2][3].items()}
    res = {
        "phase": phase, "config": cfg.name, "frames": list(frames.shape), "routes": routes,
        "steps": steps, "guidance_branches": guidance.num_branches,
        "sequential_cfg": guidance.sequential,
        "setup_s": setup_s, "prepare_s": times[1] - times[0], "step_kinds": step_kinds,
        # the first step of a freshly built engine pays cuDNN's and the
        # allocator's warm-up: the figure is the median of the later steps
        "step_s": step_s, "s_per_step": statistics.median(step_s[1:] or step_s),
        "decode_s": times[-1] - times[-2], "total_s": t_end - t_start,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "output_shape": list(video.shape), "finite": bool(torch.isfinite(video).all()),
        "output_abs_mean": video.abs().mean().item(),
        "launches": counts, "launches_per_unet_eval": per_eval,
        "sites": {k: [[list(site), n] for site, n in v.items()] for k, v in sites.items()},
    }
    if staged:
        res["staged"] = {k: (list(v) if isinstance(v, tuple) else v) for k, v in staged.items()}
        for kind in ("full", "reuse"):
            ts = [t for t, name in zip(step_s, step_kinds) if name == kind]
            if ts:
                res[f"s_per_{kind}_step"] = statistics.median(ts)
    emit(res)
    if profile_what:
        emit(profile_unet_eval(eng, frames, ids, uids, guidance, gen, profile_what))
    expect = [1, cfg.video_length, cfg.height, cfg.width, 3]
    if res["output_shape"] != expect or not res["finite"]:
        raise AssertionError(f"{phase}: output {res['output_shape']} finite={res['finite']}")
    return res, {"all": sites, "steps": step_sites}, eng


def require_launches(phase: str, res: dict, expect: dict) -> None:
    """Fail unless each kernel in `expect` was launched by the phase: exactly
    the given number of times per UNet eval, or at least once for None; and
    no kernel outside `expect` at all."""
    per_eval, counts = res["launches_per_unet_eval"], res["launches"]
    for name, n in counts.items():
        if name not in expect:
            if n:
                raise AssertionError(f"{phase}: {name} launched {n} times, expected none")
        elif n == 0 or (expect[name] is not None and per_eval[name] != expect[name]):
            raise AssertionError(f"{phase}: {name} launched {per_eval[name]} per eval "
                                 f"({n} in all), expected {expect[name]}")


def cache_bytes(eng, gen, cache_dtype: str, guidance=None) -> dict:
    """Size of the attention cache one full PAB step of the `pab` phase
    collects (sites and bytes), from a denoise_full call of its own; under
    sequential CFG the K branches' caches together."""
    import torch

    from viewcrafter_tpu_torch.sampling.ddim import GuidanceConfig

    cfg, guidance = eng.cfg, guidance or GuidanceConfig()
    f = cfg.vae.downsample_factor
    shape = (1, cfg.video_length, cfg.height // f, cfg.width // f, cfg.vae.z_channels)
    z_cond = torch.randn(shape, generator=gen, device="cuda")
    contexts = torch.randn((2, 1, 77 + 256, cfg.unet.context_dim), generator=gen, device="cuda")
    _, d_full, _ = eng._denoise_fn(z_cond, contexts, float(cfg.unet.default_fs), guidance,
                                   cache_sites=PAB_SITES, cache_dtype=cache_dtype)
    with torch.no_grad():
        _, cache = d_full(z_cond.repeat(2, 1, 1, 1, 1), torch.full((2,), 999.0, device="cuda"))
    caches = cache if isinstance(cache, list) else [cache]
    return {"sites": len(caches[0]), "caches": len(caches),
            "gib": sum(nbytes(*c.values()) for c in caches) / 2 ** 30}


def device_kernels_per_call(fn) -> int:
    """The device kernels one call of fn launches, from torch.profiler. After
    the path phases' profiler runs the op phase's window counted 3 of the
    spatial layer's 4 kernels, alone or behind a spin kernel; behind a zero
    fill it counts all 4. So a one-element zero fill goes first, and only
    that fill (the window's first kernel, if it is a fill) is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    return len(kernels) - bool(kernels and "fill" in kernels[0].name.lower())


def run_spatial_op(gen) -> tuple:
    """`fused_spatial_layer` as the stand-alone op it is (no model calls it, in
    either package): one call at each of its three flagship shapes."""
    import torch

    from viewcrafter_tpu_torch.ops import kernels
    from viewcrafter_tpu_torch.ops.kernels import spatial_layer

    kernels.reset_launches()
    outs = []
    for b, s, h, d in SPATIAL_OP_SHAPES:
        c = h * d

        def randn(*shape, scale=1.0, dtype=torch.bfloat16):
            return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

        y = spatial_layer.fused_spatial_layer(
            randn(b, s, c, scale=0.5), 1 + randn(c, scale=0.1, dtype=torch.float32),
            randn(c, scale=0.1, dtype=torch.float32), randn(3 * c, c, scale=c ** -0.5),
            randn(c, c, scale=c ** -0.5), randn(c, scale=0.1), heads=h, dim_head=d)
        torch.cuda.synchronize()
        outs.append({"shape": list(y.shape), "finite": bool(torch.isfinite(y).all()),
                     "abs_mean": y.float().abs().mean().item()})
        del y
    counts = kernels.launch_counts()
    sites = {"all": kernels.launch_sites(), "steps": kernels.launch_sites()}
    # the device kernels of one call at each shape, from torch.profiler
    # (after the counts are read: these calls are no part of the path)
    per_call = {}
    for b, s, h, d in SPATIAL_OP_SHAPES:
        c = h * d
        args = (torch.zeros(b, s, c, dtype=torch.bfloat16, device="cuda"),
                torch.ones(c, device="cuda"), torch.zeros(c, device="cuda"),
                torch.zeros(3 * c, c, dtype=torch.bfloat16, device="cuda"),
                torch.zeros(c, c, dtype=torch.bfloat16, device="cuda"),
                torch.zeros(c, dtype=torch.bfloat16, device="cuda"))
        per_call[f"{b}x{s}x{h}x{d}"] = device_kernels_per_call(
            lambda: spatial_layer.fused_spatial_layer(*args, heads=h, dim_head=d))
        del args
    res = {"phase": "op", "op": "fused_spatial_layer", "outputs": outs, "launches": counts,
           "device_kernels_per_call": per_call}
    emit(res)
    if counts["fused_spatial_layer"] != len(SPATIAL_OP_SHAPES) or not all(
            o["finite"] and o["abs_mean"] > 0 for o in outs):
        raise AssertionError(f"op: {res}")
    if any(n != 4 for n in per_call.values()):
        raise AssertionError(f"op: four kernels a call expected: {res}")
    torch.cuda.empty_cache()
    return res, sites


# --------------------------------------------------------------------------
# the geometry front and the photo -> video pipeline
# --------------------------------------------------------------------------


def dust3r_wiring_config():
    """A small DUSt3R whose every attention passes fullkv's gate: encoder and
    decoder 128 wide with 2 heads (D = 64); at 128x512 input S = 256."""
    from viewcrafter_tpu_torch.config import Dust3rConfig

    return Dust3rConfig(enc_embed_dim=128, enc_depth=2, enc_num_heads=2, dec_embed_dim=128,
                        dec_depth=2, dec_num_heads=2, dpt_feature_dim=32,
                        dpt_hidden_dims=(16, 16, 32, 64))


def against_cpu(got, o32, o16) -> dict:
    """A card output against the CPU's float32 run, relative to its largest
    value, held to twice the CPU bf16 run's own distance plus 1e-2."""
    import torch

    got = got.float().cpu()
    scale = max(o32.abs().max().item(), 1e-12)
    err, yard = (got - o32).abs().max().item() / scale, (o16 - o32).abs().max().item() / scale
    finite = bool(torch.isfinite(got).all())
    return {"rel_err_vs_cpu_f32": err, "cpu_bf16_vs_f32": yard, "tol": 2 * yard + 1e-2,
            "finite": finite, "ok": err <= 2 * yard + 1e-2 and finite}


def run_geometry_wiring(gen) -> tuple:
    """The small DUSt3R on the card against the same weights on the CPU
    (float32 and bf16; the yardstick for the tolerance is the CPU bf16 run's
    own distance from its float32 run), then GEOMETRY_WIRING_STEPS aligner
    steps on the card against the same steps on the CPU, both from the
    card's pointmaps. Returns (result, launch sites)."""
    import dataclasses

    import numpy as np
    import torch

    from viewcrafter_tpu_torch.align.global_align import GlobalAligner, SceneGraph
    from viewcrafter_tpu_torch.config import AlignConfig
    from viewcrafter_tpu_torch.models.dust3r import Dust3rModel
    from viewcrafter_tpu_torch.models.layers import init_random_
    from viewcrafter_tpu_torch.ops import kernels

    cfg = dust3r_wiring_config()
    with torch.device("cuda"):
        card = Dust3rModel(cfg).eval()
    init_random_(card, torch.Generator(device="cuda").manual_seed(2))
    state = {k: v.float().cpu() for k, v in card.state_dict().items()}
    ref32, ref16 = Dust3rModel(cfg, dtype=torch.float32).eval(), Dust3rModel(cfg).eval()
    ref32.load_state_dict(state)
    ref16.load_state_dict(state)
    imgs = torch.rand((2, 128, 512, 3), generator=gen, device="cuda") * 2 - 1
    pairs = torch.tensor([1, 0], device="cuda"), torch.tensor([0, 1], device="cuda")
    kernels.reset_launches()
    with torch.no_grad():
        out = card.decode_pairs(*card.encode(imgs), *pairs, 128, 512)
        torch.cuda.synchronize()
        counts, sites = kernels.launch_counts(), kernels.launch_sites()
        cpu = [m.decode_pairs(*m.encode(imgs.cpu()), *(p.cpu() for p in pairs), 128, 512)
               for m in (ref32, ref16)]
    res = {"phase": "geometry_wiring", "config": dataclasses.asdict(cfg), "input": [2, 128, 512, 3],
           "launches": counts, "outputs": {}}
    ok = True
    for key in ("pts3d1", "conf1", "pts3d2_in_view1", "conf2"):
        res["outputs"][key] = against_cpu(out[key], cpu[0][key], cpu[1][key])
        ok &= res["outputs"][key]["ok"]
    # the aligner on the card and on the CPU from the card's pointmaps
    host = {k: v.float().cpu().numpy() for k, v in out.items()}
    graph = SceneGraph(edges=np.array([[1, 0], [0, 1]]), pred_i=host["pts3d1"],
                       pred_j=host["pts3d2_in_view1"], conf_i=host["conf1"],
                       conf_j=host["conf2"], imgs=(imgs.cpu().numpy() + 1) / 2)
    align = AlignConfig(niter=GEOMETRY_WIRING_STEPS)
    scenes, losses = [], []
    for device in ("cuda", "cpu"):
        aligner = GlobalAligner(graph, align, device=device)
        params, loss = aligner.optimize(aligner.init_mst())
        scenes.append(aligner.get_scene(params))
        losses.append(loss.cpu().numpy())

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    res["align"] = {"steps": GEOMETRY_WIRING_STEPS, "loss_card": losses[0].tolist(),
                    "loss_cpu": losses[1].tolist(), "tol": 1e-3,
                    **{f"{k}_rel_err": rel(getattr(scenes[0], k), getattr(scenes[1], k))
                       for k in ("depths", "poses", "focals")}}
    ok &= rel(losses[0], losses[1]) <= 1e-3 and all(
        res["align"][f"{k}_rel_err"] <= 1e-3 for k in ("depths", "poses", "focals"))
    emit(res)
    n_attn = cfg.enc_depth + 4 * cfg.dec_depth  # encoder self; decoder self + cross, 2 streams
    if not ok or counts["fullkv_attention"] != n_attn or sum(counts.values()) != n_attn:
        raise AssertionError(f"geometry_wiring: {res}")
    return res, sites


def pipeline_input(seed: int, h: int, w: int):
    """A seeded photo made with numpy alone (no PIL): smooth colour fields
    at the diffusion resolution (h, w), and its 2x2-average downsample at
    DUSt3R's resolution, as a `LoadedImage` in [-1, 1]."""
    import numpy as np

    from viewcrafter_tpu_torch.utils.io import LoadedImage

    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        for _ in range(4):
            fy, fx, ph = rng.uniform(0.5, 4), rng.uniform(0.5, 4), rng.uniform(0, 6.3)
            img[..., c] += np.sin(2 * np.pi * (fy * yy + fx * xx) + ph) / 4
    img_ori = np.clip(img + rng.normal(0, 0.05, img.shape), -1, 1).astype(np.float32)
    small = img_ori.reshape(h // 2, 2, w // 2, 2, 3).mean(axis=(1, 3))
    return LoadedImage(img=small.astype(np.float32), img_ori=img_ori, index=0)


def shifted_views(n: int, shift: int, h: int, w: int) -> list:
    """`n` views of one seeded numpy photo (`pipeline_input`), the i-th
    panned `i * shift` pixels sideways at the diffusion resolution."""
    import numpy as np

    from viewcrafter_tpu_torch.utils.io import LoadedImage

    base = pipeline_input(0, h, w).img_ori
    views = []
    for i in range(n):
        ori = np.ascontiguousarray(np.roll(base, i * shift, axis=1))
        small = ori.reshape(h // 2, 2, w // 2, 2, 3).mean(axis=(1, 3)).astype(np.float32)
        views.append(LoadedImage(img=small, img_ori=ori, index=i))
    return views


def eval_clip(n: int, h: int, w: int):
    """The first `n` frames of test/eval1 through the pipeline's loader, or,
    without PIL, `n` seeded numpy views. Returns (views, source)."""
    from viewcrafter_tpu_torch.utils import io as vio

    try:
        import PIL  # noqa: F401
    except ImportError:
        return shifted_views(n, 24, h, w), f"{n} seeded numpy views (no PIL)"
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test", "eval1")
    paths = [os.path.join(folder, f) for f in sorted(os.listdir(folder))][:n]
    return vio.load_images(paths, size=512, target_hw=(h, w)), f"test/eval1 frames 0-{n - 1}"


def run_mode(phase: str, mode: str, images: list, fullkv_per_dust3r: list, frames: int,
             cuts: list, covered: slice, nbv_passes: int = 3, **opt_kw) -> tuple:
    """`ViewCrafterPipeline.run()` in `mode` at dust3r_512 + viewcrafter_25,
    PIPELINE_NITER alignment steps, PIPELINE_STEPS DDIM steps per diffusion
    call, seeded random weights, default routes. One line per pass (a pass
    ends with its diffusion video: one per iteration of the iterative modes,
    one in all for the others): each stage's seconds (repeated stages
    summed), the geometry seconds (DUSt3R and the alignment), the MST init
    and the Adam steps of each DUSt3R run apart, the writes apart, the
    images, pairs and aligner edges of each DUSt3R run and its fullkv
    launches (encoder, decoder), the chosen NBV candidate, the share of
    pixels the render covers in each frame (at DUSt3R's size, before the
    input photo replaces frame 0), and the pass's seconds extrapolated to 50
    DDIM steps per diffusion call at its median step (with and without the
    writes; an extrapolation, not a 50-step run). Fails unless each DUSt3R
    run launched fullkv as `fullkv_per_dust3r` says, every UNet eval
    launched the four main-path kernels as the main path does, the videos
    are finite with `frames` frames at 576x1024, and every pass's render
    covers some pixels in the frames `covered` selects. In single_view_eval
    a line says what its render sees (`eval_geometry`). `nbv_passes` goes to
    the pipeline (single_view_nbv's passes). Returns (result, launch sites,
    [(pass, DUSt3R fullkv sites)])."""
    import re
    import tempfile

    import numpy as np
    import torch

    from viewcrafter_tpu_torch.ops import kernels
    from viewcrafter_tpu_torch.pipeline import InferenceOptions, ViewCrafterPipeline

    stamps, dust3r_images, scenes, renders = [], [], [], []

    def on_stage(name):
        torch.cuda.synchronize()
        stamps.append((name, time.perf_counter(), kernels.launch_counts(),
                       kernels.launch_sites()))

    with tempfile.TemporaryDirectory() as out_dir:
        opts = InferenceOptions(mode=mode, model="viewcrafter_25", dust3r_model="dust3r_512",
                                niter=PIPELINE_NITER, ddim_steps=PIPELINE_STEPS,
                                out_dir=out_dir, exp_name=phase, ckpt_path=None,
                                model_path=None, **opt_kw)
        t0 = time.perf_counter()
        pipe = ViewCrafterPipeline(opts, on_stage=on_stage,  # device=None: the card
                                   nbv_passes=nbv_passes)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        align, render = pipe.run_dust3r, pipe.run_render

        def run_dust3r(imgs, clean_pc=False):  # keeps each DUSt3R run's images and scene
            dust3r_images.append(len(imgs))
            scenes.append(align(imgs, clean_pc))
            return scenes[-1]

        def run_render(*args, **kw):  # the last render of a pass is its trajectory
            out = render(*args, **kw)
            renders.append((args, (out[0] > 0).any(-1).mean(axis=(1, 2)).tolist()))
            return out

        pipe.run_dust3r, pipe.run_render = run_dust3r, run_render
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        on_stage("start")
        out = pipe.run(images=images)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        written = sorted(os.listdir(opts.save_dir))
    counts, sites = kernels.launch_counts(), kernels.launch_sites()
    videos = out if isinstance(out, list) else [out]

    passes, cur = [], []
    for prev, st in zip(stamps, stamps[1:]):
        cur.append((st[0], st[1] - prev[1], prev, st))
        if st[0] == "write_video":
            passes.append(cur)
            cur = []
    runs = iter(dust3r_images)
    steps = {"n": 0, "counts": {k: 0 for k in counts}}
    pass_res, pass_sites, coverage, n_render = [], [], [], 0
    for k, stages in enumerate(passes):
        stage_s, fullkv, geo_sites, step_s, mst_s, adam_s = {}, [], {}, [], [], []
        for name, dt, prev, st in stages:
            stage_s[name] = stage_s.get(name, 0.0) + dt
            if name == "align_init":
                mst_s.append(dt)
            if name == "align":
                adam_s.append(dt)
            n_render += name == "render"
            if name == "dust3r_encode":
                enc = st[2]["fullkv_attention"] - prev[2]["fullkv_attention"]
                start = prev
            if name == "dust3r_decode":
                fullkv.append([enc, st[2]["fullkv_attention"] - start[2]["fullkv_attention"] - enc])
                for site, n in st[3]["fullkv_attention"].items():
                    n -= start[3]["fullkv_attention"].get(site, 0)
                    if n:
                        geo_sites[site] = geo_sites.get(site, 0) + n
            if name == "step":
                step_s.append(dt)
                steps["n"] += 1
                for kk in counts:
                    steps["counts"][kk] += st[2][kk] - prev[2][kk]
        n_img = [next(runs) for _ in fullkv]
        pick = [m.group(1) for m in (re.match(rf"candidate_mask{k}_nbv(\d+)", f) for f in written)
                if m]
        pass_s = stages[-1][3][1] - stages[0][2][1]
        s_per_step = statistics.median(step_s[1:] or step_s)
        calls = sum(name == "prepare" for name, *_ in stages)
        # the pass's last render (nbv renders its candidates first)
        frame_cov = renders[n_render - 1][1]
        coverage.append(frame_cov)
        res = {"phase": f"{phase}_pass", "mode": mode, "pass": k, "images": n_img,
               "pairs": [n * (n - 1) for n in n_img], "aligner_edges": [n * (n - 1) for n in n_img],
               "fullkv_encoder_decoder": fullkv, "mst_s": mst_s, "adam_s": adam_s,
               "stage_s": stage_s, "step_s": step_s,
               "geometry_s": sum(stage_s.get(n, 0.0) for n in (
                   "dust3r_encode", "dust3r_decode", "align_init", "align")),
               "writes_s": {n: stage_s.get(n) for n in ("write_render", "write_video")},
               "s_per_step": s_per_step, "pass_s": pass_s,
               "extrapolated_s_50_steps": pass_s - sum(step_s) + 50 * calls * s_per_step,
               "extrapolated_s_50_steps_no_writes": (
                   pass_s - sum(step_s) + 50 * calls * s_per_step
                   - stage_s.get("write_render", 0.0) - stage_s.get("write_video", 0.0)),
               "render_coverage_per_frame": frame_cov,
               "nbv_candidate": int(pick[0]) if pick else None}
        emit(res)
        pass_res.append(res)
        pass_sites.append((k, geo_sites))
    per_eval = {kk: v / steps["n"] for kk, v in steps["counts"].items()}
    res = {
        "phase": phase, "mode": mode, "dust3r": opts.dust3r_model, "model": opts.model,
        "niter": PIPELINE_NITER, "ddim_steps_per_call": PIPELINE_STEPS, "cuts": cuts,
        "setup_s": setup_s, "total_s": t_end - stamps[0][1], "passes": len(passes),
        "diffusion_calls": sum(st[0] == "prepare" for st in stamps),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "geometry_s": sum(p["geometry_s"] for p in pass_res),
        "extrapolated_s_50_steps": sum(p["extrapolated_s_50_steps"] for p in pass_res),
        "extrapolated_s_50_steps_no_writes": sum(
            p["extrapolated_s_50_steps_no_writes"] for p in pass_res),
        "launches": counts, "launches_per_unet_eval": per_eval,
        "fullkv_encoder_decoder": [r for p in pass_res for r in p["fullkv_encoder_decoder"]],
        "output_shapes": [list(v.shape) for v in videos],
        "finite": all(bool(np.isfinite(v).all()) for v in videos),
        "output_abs_mean": float(np.mean([np.abs(v).mean() for v in videos])),
        "render_coverage": [float(np.mean(c[covered])) for c in coverage],
        "render_coverage_frames": str(covered), "written": written,
    }
    emit(res)
    if mode == "single_view_eval":
        emit({"phase": f"{phase}_geometry", **eval_geometry(scenes, renders[-1][0])})
    if not res["finite"] or any(v.shape != (frames, 576, 1024, 3) for v in videos) or (
            min(res["render_coverage"]) <= 0):
        raise AssertionError(f"{phase}: {res}")
    if res["fullkv_encoder_decoder"] != [list(x) for x in fullkv_per_dust3r]:
        raise AssertionError(f"{phase}: fullkv (encoder, decoder) launches per DUSt3R run "
                             f"{res['fullkv_encoder_decoder']}, expected {fullkv_per_dust3r}")
    require_launches(phase, res, {"fullkv_attention": 15, "fused_temporal_layer": 34,
                                  "fused_ff_layer": 33, "temporal_conv3": 88,
                                  "group_norm_fused": None})
    del pipe
    torch.cuda.empty_cache()
    return res, sites, pass_sites


def run_checkpoint(gen, smi: str) -> tuple:
    """The released checkpoints' path at full width (viewcrafter_25 +
    dust3r_512): seeded pipeline weights, rounded to bf16, written under the
    reference's names in the released containers as bf16 leaves (exact for
    bf16 values) into a temporary directory, then loaded by a new
    `ViewCrafterPipeline` through `ckpt_path` / `model_path`. Fails unless
    every loaded tensor equals its source, one DUSt3R run of 2 images
    launches fullkv 24 / 48 times (encoder / decoder) and one
    `engine.generate` of 2 DDIM steps launches the four main-path kernels as
    the main path does. Returns (result, launch sites)."""
    import tempfile

    import torch

    from viewcrafter_tpu_torch.config import get_dust3r_config, get_model_config
    from viewcrafter_tpu_torch.models.lvdm import SUBMODELS
    from viewcrafter_tpu_torch.ops import kernels
    from viewcrafter_tpu_torch.pipeline import InferenceOptions, ViewCrafterPipeline
    from viewcrafter_tpu_torch.utils import checkpoint as ck
    from viewcrafter_tpu_torch.utils.profiling import StageTimer

    cfg, dcfg = get_model_config("viewcrafter_25"), get_dust3r_config("dust3r_512")
    timer, stamps = StageTimer(), []

    def on_stage(name):
        torch.cuda.synchronize()
        stamps.append((name, kernels.launch_counts()["fullkv_attention"]))

    def opts(**kw):
        return InferenceOptions(model=cfg.name, dust3r_model="dust3r_512",
                                niter=CHECKPOINT_NITER, seed=7, **kw)

    with timer.stage("seed"):
        seeded = ViewCrafterPipeline(opts(ckpt_path=None, model_path=None))
        torch.cuda.synchronize()
    lvdm_src = {n: {k: v.to("cpu", torch.bfloat16) for k, v in
                    getattr(seeded.engine, n).state_dict().items()} for n in SUBMODELS}
    dust3r_src = {k: v.to("cpu", torch.bfloat16) for k, v in seeded.dust3r.state_dict().items()}
    del seeded
    torch.cuda.empty_cache()
    # a DUSt3R file without a second decoder loads the first one twice
    for k in dust3r_src:
        if ".block2_" in k:
            dust3r_src[k] = dust3r_src[k.replace(".block2_", ".block1_")]

    with tempfile.TemporaryDirectory() as tmp:
        paths = (os.path.join(tmp, "model.ckpt"),
                 os.path.join(tmp, "DUSt3R_ViTLarge_BaseDecoder_512_dpt.pth"))
        with timer.stage("write"):
            ref = ck.lvdm_to_reference(lvdm_src, cfg)
            legacy = {k.replace("fps_embedding", "framestride_embed"): v for k, v in ref.items()}
            legacy["alphas_cumprod"] = torch.ones(1000, dtype=torch.bfloat16)  # no map takes it
            torch.save({"state_dict": legacy}, paths[0])
            dref = ck.dust3r_to_reference(dust3r_src, dcfg)
            one_decoder = {k: v for k, v in dref.items() if not k.startswith("dec_blocks2.")}
            torch.save({"model": one_decoder, "args": "AsymmetricCroCo3DStereo(...)"}, paths[1])
            del ref, legacy, dref, one_decoder
        sizes = [os.path.getsize(p) / 2 ** 30 for p in paths]
        torch.cuda.reset_peak_memory_stats()
        with timer.stage("load"):
            pipe = ViewCrafterPipeline(opts(ckpt_path=paths[0], model_path=paths[1]),
                                       on_stage=on_stage)
            torch.cuda.synchronize()
        load_peak = torch.cuda.max_memory_allocated() / 2 ** 30

    n_equal, differ = 0, []
    loaded = [(f"{n}.{k}", v, lvdm_src[n][k]) for n in SUBMODELS
              for k, v in getattr(pipe.engine, n).state_dict().items()]
    loaded += [(f"dust3r.{k}", v, dust3r_src[k]) for k, v in pipe.dust3r.state_dict().items()]
    for key, got, want in loaded:
        if torch.equal(got, want.to(got.device, got.dtype)):
            n_equal += 1
        else:
            differ.append(key)
    del loaded

    kernels.reset_launches()
    stamps.append(("start", 0))
    h, w = cfg.height, cfg.width
    pipe.run_dust3r(shifted_views(2, 24, h, w))
    marks = dict(stamps)
    fullkv = [marks["dust3r_encode"], marks["dust3r_decode"] - marks["dust3r_encode"]]
    dust3r_sites = kernels.launch_sites()
    gen_res, gen_sites, _ = drive("checkpoint_generate", cfg, gen, 2, routes=False, eng=pipe.engine)
    res = {"phase": "checkpoint", "model": cfg.name, "dust3r": "dust3r_512",
           "file_gib": {"diffusion": sizes[0], "dust3r": sizes[1]},
           "tensors_equal": n_equal, "tensors_differ": differ[:20],
           "seconds": timer.totals(), "load_peak_mem_gib": load_peak,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "loaded_real_ckpt": pipe.loaded_real_ckpt, "dust3r_images": 2,
           "fullkv_encoder_decoder": fullkv, "generate_steps": 2,
           "generate_launches_per_unet_eval": gen_res["launches_per_unet_eval"],
           "generate_s_per_step": gen_res["s_per_step"], "nvidia_smi": smi}
    emit(res)
    if differ or not n_equal or not pipe.loaded_real_ckpt or fullkv != [24, 48]:
        raise AssertionError(f"checkpoint: {res}")
    require_launches("checkpoint", gen_res, {"fullkv_attention": 15, "fused_temporal_layer": 34,
                                             "fused_ff_layer": 33, "temporal_conv3": 88,
                                             "group_norm_fused": UNET_GROUP_NORMS})
    del pipe, lvdm_src, dust3r_src
    torch.cuda.empty_cache()
    return res, merge_sites(dust3r_sites, gen_sites["all"])


def eval_geometry(scenes: list, render_args: tuple) -> dict:
    """What the eval phase's render sees: single_view_eval draws the cloud
    of an alignment of its own ([img0, img0], the last scene) along the
    cameras of the clip's alignment (the first scene), re-anchored so that
    camera 0 is the identity; that holds only if the two alignments share
    camera 0's frame and their scale. Reports the cloud's coverage at its
    own camera 0 (its own pose, focal and principal point), how far its
    camera 0 lies from the identity, both scenes' median depths (their
    scales), the share of its depths at or below the rasterizer's znear
    (1e-4; such points are not drawn), the focals, each render camera's distance
    and rotation from camera 0, and per render camera the share of the
    cloud's points in front of it and inside its image."""
    import numpy as np
    import torch

    from viewcrafter_tpu_torch.geometry.transforms import inv_se3, make_intrinsics
    from viewcrafter_tpu_torch.ops.rasterize import render_trajectory

    clip, ref = scenes[0], scenes[-1]
    pts, _, c2ws, focals, pps, (h, w) = render_args

    def angle_deg(r):
        return float(np.degrees(np.arccos(np.clip((np.trace(r[:3, :3]) - 1) / 2, -1, 1))))

    own = render_trajectory(
        torch.as_tensor(pts, dtype=torch.float32, device="cuda"),
        torch.ones((len(pts), 1), device="cuda"),
        inv_se3(torch.as_tensor(ref.poses[:1], dtype=torch.float32, device="cuda")),
        torch.as_tensor(make_intrinsics(ref.focals[:1], ref.principal_points[:1]),
                        device="cuda"), h, w)
    in_front, in_view = [], []
    for c2w in np.asarray(c2ws, np.float64):
        w2c = np.linalg.inv(c2w)
        cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        front = cam[:, 2] > 1e-4
        z = np.where(front, cam[:, 2], 1.0)
        u = focals[0] * cam[:, 0] / z + pps[0][0]
        v = focals[0] * cam[:, 1] / z + pps[0][1]
        in_front.append(float(front.mean()))
        in_view.append(float((front & (u > -0.5) & (u < w - 0.5) & (v > -0.5)
                              & (v < h - 0.5)).mean()))
    return {
        "ref_cloud_coverage_at_own_camera0": float((own[0, ..., 0] > 0).float().mean()),
        "ref_camera0_distance": float(np.linalg.norm(ref.poses[0][:3, 3])),
        "ref_camera0_rotation_deg": angle_deg(ref.poses[0]),
        "ref_depth_median": float(np.median(ref.depths[0])),
        "ref_depth_share_below_znear": float((ref.depths[0] <= 1e-4).mean()),
        "clip_depth0_median": float(np.median(clip.depths[0])),
        "ref_focal": float(ref.focals[0]), "clip_focal": float(focals[0]),
        "camera_distance": [float(np.linalg.norm(c[:3, 3])) for c in c2ws],
        "camera_rotation_deg": [angle_deg(c) for c in c2ws],
        "ref_points_in_front": in_front, "ref_points_in_view": in_view,
    }


# --------------------------------------------------------------------------
# multi-device sampling: ranks spawned from this process
# --------------------------------------------------------------------------


def sharded_inputs(eng, steps: int, seed: int):
    """Frames, prompt ids and every draw of one sharded phase, made on the
    card from `seed`: the same numbers in this process and in every rank."""
    import torch

    cfg = eng.cfg
    g = torch.Generator(device="cuda").manual_seed(seed)
    frames = torch.rand((1, cfg.video_length, cfg.height, cfg.width, 3), generator=g,
                        device="cuda") * 2 - 1
    return (frames, fixed_prompt_ids(6, "cuda"), fixed_prompt_ids(0, "cuda"),
            eng.draw_noise(frames.shape, steps, g))


def timed_generate(eng, inputs, steps: int, guidance, mesh=None) -> tuple:
    """`generate_staged` on `inputs` with a stamp after every stage: (video,
    stage seconds, peak memory, launches in all and per UNet eval of the
    sampling steps, launch sites, and the seconds and bytes of the
    collectives of the sampling steps, as seen by this rank: all of them,
    and the all-reduces of tensor parallelism apart, their bytes those of
    this rank's partial sums)."""
    import torch

    from viewcrafter_tpu_torch.ops import kernels
    from viewcrafter_tpu_torch.parallel import mesh as pm

    coll = {"s": 0.0, "bytes": 0, "reduce_s": 0.0, "reduce_bytes": 0, "reduces": 0}
    gather, reduce = pm.all_gather, pm.all_reduce_sum

    def timed(fn, kind):
        def run(x, group, *args):
            if group is None:  # an axis of one rank: no collective
                return fn(x, group, *args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x, group, *args)
            torch.cuda.synchronize()
            dt, nb = time.perf_counter() - t0, out.numel() * out.element_size()
            coll["s"] += dt
            coll["bytes"] += nb
            if kind == "reduce":
                coll["reduce_s"] += dt
                coll["reduce_bytes"] += nb
                coll["reduces"] += 1
            return out
        return run

    stamps = []

    def on_stage(name):
        torch.cuda.synchronize()
        stamps.append((name, time.perf_counter(), kernels.launch_counts(), dict(coll)))

    frames, ids, uids, noise = inputs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    pm.all_gather, pm.all_reduce_sum = timed(gather, "gather"), timed(reduce, "reduce")
    try:
        t0 = time.perf_counter()
        video = eng.generate_staged(frames, ids, uids, steps=steps, guidance=guidance,
                                    chunk=steps, noise=noise, mesh=mesh, on_stage=on_stage)
        torch.cuda.synchronize()
    finally:
        pm.all_gather, pm.all_reduce_sum = gather, reduce
    times = [t0] + [s[1] for s in stamps]
    step_s = [times[i + 1] - times[i] for i in range(1, 1 + steps)]
    counts = kernels.launch_counts()
    first, last = stamps[0], stamps[-2]  # after prepare, after the last step
    res = {"prepare_s": times[1] - times[0], "step_s": step_s,
           "s_per_step": statistics.median(step_s[1:] or step_s),
           "decode_s": times[-1] - times[-2],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": counts,
           "launches_per_unet_eval": {k: (last[2][k] - first[2][k]) / steps for k in counts},
           "collective_s_per_step": (last[3]["s"] - first[3]["s"]) / steps,
           "collective_gib_per_step": (last[3]["bytes"] - first[3]["bytes"]) / steps / 2 ** 30,
           "all_reduce_s_per_step": (last[3]["reduce_s"] - first[3]["reduce_s"]) / steps,
           "all_reduce_gib_per_step":
               (last[3]["reduce_bytes"] - first[3]["reduce_bytes"]) / steps / 2 ** 30,
           "all_reduces_per_step": (last[3]["reduces"] - first[3]["reduces"]) / steps,
           "collective_s_all": coll["s"], "sites": kernels.launch_sites()}
    return video, res


def sharded_rank(spec: dict) -> dict:
    """Rank target of the sharded phases (`chip_smoke.spawn_phase`): load
    the kernels the parent built, build the phase's engine (seeded weights,
    or `state`), one rank at a time since a build in float32 peaks near
    10 GiB at full width, check every rank holds the same weights, then run
    `generate_staged` on the phase's mesh with the phase's inputs. Returns
    this rank's numbers; rank 0 also returns the video."""
    import torch
    import torch.distributed as dist

    from viewcrafter_tpu_torch.models.lvdm import SUBMODELS, VideoDiffusionEngine
    from viewcrafter_tpu_torch.ops.kernels import _lib
    from viewcrafter_tpu_torch.parallel import mesh as pm

    if not _lib.library_path().exists():
        raise RuntimeError("the kernels are not built: the parent process builds them")
    _lib.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = pm.make_mesh(dp=spec["dp"], tp=spec.get("tp", 1), devices=spec["devices"])
    device = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    for r in range(pm.world_size()):
        if pm.rank() == r:
            eng = VideoDiffusionEngine(spec["cfg"], device=device,
                                       **route_kwargs(spec.get("routes", False)))
            if spec["state"] is None:
                eng.init_params(seed=spec["weights_seed"])
            else:
                eng.load_params({n: {k: torch.from_numpy(v) for k, v in sd.items()}
                                 for n, sd in spec["state"].items()})
            torch.cuda.synchronize()
        dist.barrier()
    build_s = time.perf_counter() - t0
    checksum = pm.assert_replicated(p for n in SUBMODELS for p in getattr(eng, n).parameters())
    inputs = sharded_inputs(eng, spec["steps"], spec["seed"])
    video, res = timed_generate(eng, inputs, spec["steps"], spec["guidance"], mesh)
    return {"rank": pm.rank(), "device": str(device), "mesh": pm.mesh_shape(mesh),
            "build_s": build_s, "weights_checksum": checksum,
            "video_sum": float(video.double().sum()),
            "video": video.cpu().numpy() if pm.rank() == 0 else None, **res}


def compare_videos(got, ref, yard) -> dict:
    """A sharded video against the unsharded one: max and mean error, each
    held to twice the yardstick's (plus a floor, as `run_wiring` does), the
    error RMS relative to the output's, the share of bit-equal values, and
    the kernel check's rule (max error / (4 * 2^-8 of the largest output),
    RMS / 2^-7) for reference."""
    import numpy as np

    diff = np.abs(got.astype(np.float64) - ref)
    err, mean_err = float(diff.max()), float(diff.mean())
    rms_rel = float(np.sqrt((diff ** 2).mean()) / np.sqrt((ref ** 2).mean()))
    tol, mean_tol = 2 * yard[0] + 1e-2, 2 * yard[1] + 1e-3
    return {"max_abs_err": err, "tol": tol, "mean_abs_err": mean_err, "mean_tol": mean_tol,
            "rms_rel_err": rms_rel, "bit_equal_share": float((got == ref).mean()),
            "kernel_rule_max_ratio": err / (4 * 2.0 ** -8 * float(np.abs(ref).max())),
            "kernel_rule_rms_ratio": rms_rel / 2.0 ** -7,
            "ok": err <= tol and mean_err <= mean_tol}


def spawn_phase(phase: str, spec: dict, world: int, backend: str, devices: list,
                ref, yard, expect_per_eval, sequential=None, required=MAIN_KERNELS) -> tuple:
    """One sharded run of `phase`: `world` ranks on `devices` over `backend`,
    rank 0's video against the unsharded `ref` (tolerance from `yard`), the
    same video on every rank, and every kernel of `required` launched in
    every rank (`expect_per_eval`: the main path's launches per UNet eval, or
    None for at least one). `sequential`, if given, the unsharded
    sequential-CFG video: the share of values equal to it is reported too.
    Emits a line per rank (under tensor parallelism with the rank's launch
    sites: its local heads and widths) and one for the run; returns (the
    run's line, the ranks' launch sites)."""
    import torch

    from viewcrafter_tpu_torch.parallel import mesh as pm

    t0 = time.perf_counter()
    ranks = pm.spawn(sharded_rank, world, backend, devices=devices,
                     args=(dict(spec, devices=devices),), timeout=SPAWN_TIMEOUT)
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    tp = spec.get("tp", 1)
    for r in ranks:
        line = {k: v for k, v in r.items() if k not in ("video", "sites")}
        if tp > 1:
            line["sites"] = {k: [[list(site), n] for site, n in v.items()]
                             for k, v in r["sites"].items() if v}
        emit({"phase": f"{phase}_rank", "backend": backend, "world": world, **line})
        for name in required:
            n = r["launches_per_unet_eval"][name]
            if n == 0 or (expect_per_eval is not None and n != expect_per_eval[name]):
                raise AssertionError(f"{phase} ({backend}, rank {r['rank']}): {name} launched "
                                     f"{n} times per UNet eval, expected {expect_per_eval}")
    if len({r["video_sum"] for r in ranks}) != 1:
        raise AssertionError(f"{phase}: the ranks returned other videos: "
                             f"{[r['video_sum'] for r in ranks]}")
    got = ranks[0]["video"]
    res = {"phase": phase, "backend": backend, "world": world, "devices": devices,
           "mesh": ranks[0]["mesh"], "shape": list(got.shape),
           "finite": bool(torch.isfinite(torch.from_numpy(got)).all()),
           **compare_videos(got, ref, yard),
           "bit_equal_share_vs_sequential": (None if sequential is None
                                             else float((got == sequential).mean())),
           "s_per_step": [r["s_per_step"] for r in ranks],
           "peak_mem_gib": [r["peak_mem_gib"] for r in ranks],
           "collective_s_per_step": [r["collective_s_per_step"] for r in ranks],
           "launches_per_unet_eval": [{k: r["launches_per_unet_eval"][k] for k in required}
                                      for r in ranks],
           "spawn_wall_s": wall_s}
    if tp > 1:
        for key in ("all_reduce_s_per_step", "all_reduce_gib_per_step", "all_reduces_per_step"):
            res[key] = [r[key] for r in ranks]
    emit(res)
    if not (res["ok"] and res["finite"] and list(got.shape) == list(ref.shape)):
        raise AssertionError(f"{phase} ({backend}, {world} ranks): {res}")
    return res, [r["sites"] for r in ranks]


def unsharded_reference(phase: str, cfg, smi: str, steps: int = SHARDED_STEPS) -> dict:
    """The reference of a full-width sharded phase: the unsharded
    `generate_staged` on this card (batched CFG) with the sharded phases'
    seeded weights and inputs, and the yardstick of rounding, the same with
    sequential CFG (the same math at other batch sizes). Emits a line;
    returns the two videos, the yardstick's max and mean error and the
    main-path launches per UNet eval."""
    import numpy as np
    import torch

    from viewcrafter_tpu_torch.models.lvdm import VideoDiffusionEngine
    from viewcrafter_tpu_torch.sampling.ddim import GuidanceConfig

    eng = VideoDiffusionEngine(cfg)
    eng.init_params(seed=0)
    inputs = sharded_inputs(eng, steps, SHARDED_SEED)
    ref, ref_res = timed_generate(eng, inputs, steps, GuidanceConfig())
    seq, seq_res = timed_generate(eng, inputs, steps, GuidanceConfig(sequential=True))
    ref, seq = ref.double().cpu().numpy(), seq.cpu().numpy()
    diff = np.abs(seq - ref)
    yard = (float(diff.max()), float(diff.mean()))
    emit({"phase": f"{phase}_unsharded", "config": cfg.name,
          "frames": list(inputs[0].shape), "steps": steps,
          "s_per_step": ref_res["s_per_step"], "sequential_s_per_step": seq_res["s_per_step"],
          "peak_mem_gib": ref_res["peak_mem_gib"],
          "sequential_peak_mem_gib": seq_res["peak_mem_gib"],
          "launches_per_unet_eval": ref_res["launches_per_unet_eval"],
          "sequential_vs_batched": {"max_abs_err": yard[0], "mean_abs_err": yard[1],
                                    "bit_equal_share": float((seq == ref).mean())},
          "nvidia_smi": smi})
    del eng, inputs
    torch.cuda.empty_cache()
    return {"ref": ref, "seq": seq, "yard": yard,
            "expect": {k: ref_res["launches_per_unet_eval"][k] for k in MAIN_KERNELS}}


def run_sharded(phase: str, cfg, dp: int, world: int, smi: str, nccl: bool = False,
                tp: int = 1, reference=None, steps: int = SHARDED_STEPS) -> list:
    """A sharded phase of `steps` DDIM steps at full width against
    `reference` (`unsharded_reference` of as many steps, made here if not
    given; the same weights and inputs): `world` ranks on cuda:0 over gloo
    with the mesh
    make_mesh(world, dp, tp); with `nccl`, the same through one NCCL rank
    (without tp: one rank holds the whole mesh), and across `world` cards
    over NCCL where the machine has them. Returns the ranks' launch sites."""
    import torch

    from viewcrafter_tpu_torch.sampling.ddim import GuidanceConfig

    reference = reference or unsharded_reference(phase, cfg, smi, steps)
    spec = dict(cfg=cfg, state=None, weights_seed=0, seed=SHARDED_SEED, steps=steps,
                guidance=GuidanceConfig(), dp=dp, tp=tp)
    runs = [(world, "gloo", ["cuda:0"] * world, spec)]
    if nccl and tp == 1:
        runs.append((1, "nccl", ["cuda:0"], dict(spec, dp=1)))
    if nccl and torch.cuda.device_count() >= world:
        runs.append((world, "nccl", [f"cuda:{i}" for i in range(world)], spec))
    sites = []
    for n, backend, devices, run_spec in runs:
        _, s = spawn_phase(phase, run_spec, n, backend, devices, reference["ref"],
                           reference["yard"], reference["expect"], reference["seq"])
        sites += s
    return sites


def tp_wiring_config():
    """The wiring config at 192 channels: 3 heads of 64 at the 16x16 level
    (split 2/1 at tp = 2, each rank with a head where
    `dual_cross_attention`'s gate holds) and 6 at the 8x8 level."""
    import dataclasses

    cfg = wiring_config(8)
    return dataclasses.replace(cfg, name="wiring_tp",
                               unet=dataclasses.replace(cfg.unet, model_channels=192))


def run_sharded_wiring(gen, phase: str = "sharded_wiring", cfg=None, world: int = 4,
                       tp: int = 1, routes: bool = False) -> list:
    """A small config whose every gate takes the kernels (default the wiring
    config) on `world` gloo ranks on cuda:0 at dp 2 x tp `tp` and sp the
    rest (one sample, so its two CFG branches over dp and its 8 frames over
    sp), with both routes on when `routes`, against the CPU's float32
    run at `run_wiring`'s tolerance (twice the CPU bf16 run's own distance,
    plus a floor). Every rank must launch the main path's kernels and the
    fused GroupNorm, and with `routes` the dual cross-attention too. Returns
    the ranks' launch sites."""
    import torch

    from viewcrafter_tpu_torch.models.lvdm import SUBMODELS, GenerateNoise, VideoDiffusionEngine
    from viewcrafter_tpu_torch.sampling.ddim import GuidanceConfig

    cfg = cfg or wiring_config(8)
    kw = route_kwargs(routes)
    cuda = VideoDiffusionEngine(cfg, dtype=torch.bfloat16, device="cuda", **kw)
    cuda.init_params(seed=1)
    state = {n: {k: v.float().cpu() for k, v in getattr(cuda, n).state_dict().items()}
             for n in SUBMODELS}
    frames, ids, uids, noise = sharded_inputs(cuda, SHARDED_STEPS, SHARDED_SEED)
    cpu_in = (frames.cpu(), ids.cpu(), uids.cpu(),
              GenerateNoise(*(t.cpu() for t in (noise.x_T, noise.steps, noise.posterior))))
    refs = {}
    for dtype in (torch.float32, torch.bfloat16):
        ref = VideoDiffusionEngine(cfg, dtype=dtype, device="cpu", **kw)
        ref.load_params(state)
        refs[dtype] = ref.generate_staged(*cpu_in[:3], steps=SHARDED_STEPS,
                                          guidance=GuidanceConfig(), noise=cpu_in[3]).double()
    o32, o16 = refs[torch.float32].numpy(), refs[torch.bfloat16].numpy()
    yard = (float(abs(o16 - o32).max()), float(abs(o16 - o32).mean()))
    del cuda
    torch.cuda.empty_cache()
    spec = dict(cfg=cfg, state={n: {k: v.numpy() for k, v in sd.items()}
                                for n, sd in state.items()},
                seed=SHARDED_SEED, steps=SHARDED_STEPS, guidance=GuidanceConfig(), dp=2, tp=tp,
                routes=routes)
    required = MAIN_KERNELS + ("group_norm_fused",) + (("dual_cross_attention",) if routes else ())
    _, sites = spawn_phase(phase, spec, world, "gloo", ["cuda:0"] * world, o32, yard, None,
                           required=required)
    return sites


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def train_batches(cfg, n: int, seed: int, device) -> list:
    """`n` seeded training batches of one clip of `cfg`, made on `device`:
    latents and guidance latents (1, T, h, w, 4), a context of the text
    tokens and the resampler's image tokens, fs 10."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    h, w = cfg.diffusion.latent_size
    ctx_len = cfg.clip_text.context_length + cfg.resampler.num_queries * (
        cfg.resampler.video_length or 1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    return [{"latents": randn(1, cfg.video_length, h, w, 4),
             "cond_latents": randn(1, cfg.video_length, h, w, 4),
             "context": randn(1, ctx_len, cfg.unet.context_dim),
             "fs": torch.full((1,), 10.0, device=device)} for _ in range(n)]


def wiring_loop(cfg, loop_cfg, device, dtype, weights, routes: bool, mesh=None):
    """A TrainLoop of the wiring config on `device` in `dtype` (both opt-in
    routes with `routes`) and its state from `weights`, its draws from a
    CPU generator seeded with TRAIN_SEED: the same t and eps in every run."""
    import torch

    from viewcrafter_tpu_torch.train_loop import TrainLoop

    loop = TrainLoop(cfg, loop_cfg, mesh=mesh, device=device, dtype=dtype,
                     **route_kwargs(routes))
    return loop, loop.init_state(torch.Generator().manual_seed(TRAIN_SEED), params=weights)


def run_loop(loop, state, batches) -> dict:
    """Run `loop` from `state` over `batches`; per step the loss, the
    gradient norm and the seconds; the weights' change from the start (as
    float32 on the CPU)."""
    import torch

    start = {k: v.detach().to("cpu", torch.float32, copy=True)
             for k, v in state.train.params.items()}
    steps = []

    def on_step(step, loss, grad_norm):
        steps.append((float(loss), float(grad_norm), time.perf_counter()))

    t0 = time.perf_counter()
    loop.run(batches, None, state=state, on_step=on_step)
    if loop.device.type == "cuda":
        torch.cuda.synchronize()
    times = [t0] + [s[2] for s in steps]
    return {"loss": [s[0] for s in steps], "grad_norm": [s[1] for s in steps],
            "step_s": [b - a for a, b in zip(times, times[1:])],
            "delta": {k: state.train.params[k].detach().float().cpu() - v
                      for k, v in start.items()}}


def compare_runs(got: dict, ref: dict, yard: tuple, lr: float) -> dict:
    """A training run against the reference run: the losses and gradient
    norms (relative error, the largest over the steps) and the weights'
    change (in units of the learning rate: max and mean over every weight),
    each held to twice the error of the yardstick pair of runs `yard` plus a
    floor, as `run_wiring` holds a video (Adam turns a gradient near
    rounding noise into a step of up to lr either way, so the mean is the
    tight one)."""
    import torch

    def errs(a, b):
        rel = lambda x, y: max(abs(p - q) / max(abs(q), 1e-12) for p, q in zip(x, y))  # noqa: E731
        diff = torch.cat([(a["delta"][k] - b["delta"][k]).abs().flatten() for k in b["delta"]])
        return {"loss": rel(a["loss"], b["loss"]), "grad_norm": rel(a["grad_norm"], b["grad_norm"]),
                "delta_max": float(diff.max()) / lr, "delta_mean": float(diff.mean()) / lr}

    err, y = errs(got, ref), errs(*yard)
    floors = {"loss": 1e-2, "grad_norm": 1e-2, "delta_max": 0.1, "delta_mean": 1e-2}
    tol = {k: 2 * y[k] + floors[k] for k in err}
    return {"err": err, "yardstick": y, "tol": tol,
            "ok": all(err[k] <= tol[k] for k in err)}


def wiring_weights(cfg, seed: int) -> dict:
    """Seeded float32 weights of the wiring config's UNet, on the CPU."""
    import torch

    from viewcrafter_tpu_torch.models.layers import init_random_
    from viewcrafter_tpu_torch.models.unet3d import UNet3D

    unet = UNet3D(cfg.unet, dtype=torch.float32)
    init_random_(unet, torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in unet.state_dict().items()}


def run_train_wiring(steps: int = TRAIN_WIRING_STEPS, resume: bool = True) -> tuple:
    """`TrainLoop` on the wiring config with both opt-in routes, so that every
    gate takes its kernel: `steps` steps on the card (bf16 compute, float32
    master weights) and on the CPU in float32 and in bf16 (the yardstick),
    from the same weights, batches and draws; the losses, gradient norms and
    weight changes held to `compare_runs`' tolerance, and every kernel of
    the path launched and run backward. With `resume`: under
    torch.use_deterministic_algorithms(True) the same run on the card once
    through and once saved after step `steps - 1`, restored in a new loop
    and run to the end: bit-identical, else the ops that have no
    deterministic variant and the difference are printed and the phase
    fails. Returns (result, launch sites)."""
    import torch

    from viewcrafter_tpu_torch.ops import kernels
    from viewcrafter_tpu_torch.train_loop import TrainLoopConfig

    cfg = wiring_config(8)
    loop_cfg = TrainLoopConfig(lr=1e-3, warmup_steps=1, decay_steps=10, max_steps=steps,
                               log_every=0)
    weights = wiring_weights(cfg, TRAIN_SEED)
    batches = train_batches(cfg, steps, TRAIN_SEED, "cpu")
    kernels.reset_launches()
    runs = {}
    for name, device, dtype in (("card", "cuda", torch.bfloat16), ("cpu_f32", "cpu", torch.float32),
                                ("cpu_bf16", "cpu", torch.bfloat16)):
        loop, state = wiring_loop(cfg, loop_cfg, device, dtype, weights, routes=True)
        runs[name] = run_loop(loop, state, batches)
        if name == "card":
            counts, back = kernels.launch_counts(), kernels.backward_plain_counts()
            sites = kernels.launch_sites()
        del loop, state
    cmp = compare_runs(runs["card"], runs["cpu_f32"], (runs["cpu_bf16"], runs["cpu_f32"]),
                       loop_cfg.lr)
    res = {"phase": "train_wiring", "steps": steps, "routes": True,
           **{f"{k}_loss": runs[k]["loss"] for k in runs},
           **{f"{k}_grad_norm": runs[k]["grad_norm"] for k in runs},
           "card_step_s": runs["card"]["step_s"], **cmp,
           "launches": counts, "backward_plain": back}
    expect = set(MAIN_KERNELS) | {"group_norm_fused", "dual_cross_attention"}
    missing = [k for k in expect if not (counts[k] and back[k])]
    if resume:
        res.update(deterministic_resume(cfg, loop_cfg, weights, batches))
    emit(res)
    if not cmp["ok"] or missing or (resume and not res["resume_bit_identical"]):
        raise AssertionError(f"train_wiring: {cmp}, kernels without launches or backward "
                             f"{missing}, resume {res.get('resume_bit_identical')}")
    return res, sites


def deterministic_resume(cfg, loop_cfg, weights, batches, device="cuda") -> dict:
    """The card's run once through and once resumed from the checkpoint of
    its last-but-one step, under deterministic algorithms: whether the
    master weights, Adam's state and the EMA come out bit-identical, the
    largest difference, and the ops that warned that they have no
    deterministic variant. (cuBLAS asks for CUBLAS_WORKSPACE_CONFIG under
    deterministic algorithms; it is set here when unset.)"""
    import dataclasses
    import tempfile
    import warnings

    import torch

    steps = loop_cfg.max_steps
    batches = batches[:steps - 1]  # the resumed loop starts a new epoch at the cut
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    out = {}
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            finals = []
            for name, cuts in (("once", (steps,)), ("resumed", (steps - 1, steps))):
                lc = dataclasses.replace(loop_cfg, ckpt_dir=os.path.join(tmp, name))
                for i, n in enumerate(cuts):
                    loop, state = wiring_loop(cfg, dataclasses.replace(lc, max_steps=n), device,
                                              torch.bfloat16, weights, routes=True)
                    state = loop.run(batches, None, state=None if i else state)
                finals.append(state)
        finally:
            torch.use_deterministic_algorithms(False)
    a, b = finals
    pairs = [(a.train.params, b.train.params), (a.train.opt_state.mu, b.train.opt_state.mu),
             (a.train.opt_state.nu, b.train.opt_state.nu), (a.ema.shadow, b.ema.shadow)]
    diff = max(float((x[k] - y[k]).abs().max()) for x, y in pairs for k in x)
    out["resume_bit_identical"] = all(torch.equal(x[k], y[k]) for x, y in pairs for k in x) and \
        a.train.step == b.train.step == steps
    out["resume_max_abs_diff"] = diff
    out["nondeterministic_ops"] = sorted({str(w.message)[:200] for w in caught
                                          if "deterministic" in str(w.message)})
    return out


def run_train(smi: str) -> tuple:
    """The full-width training path: `TrainLoop.run` on `viewcrafter_25_512`
    (the released 512 model at full width and depth, seeded weights) on the
    card, remat on, EMA on, the TrainLoopConfig defaults but warmup_steps = 1
    and max_steps = TRAIN_STEPS, B = 1 clip of 320x512x25 (latents 40x64x4
    and 4 guidance channels), a context of 77 + 16*16 tokens, fs 10, batches
    from a torch.Generator. Per step: seconds, the loss, the global gradient
    norm, the kernels' launches and their backward passes; one step under
    torch.profiler split into forward, backward, optimizer and EMA; the peak
    memory; whether the weights changed at step 2 (step 1's lr is 0).
    Returns (result, launch sites)."""
    import math

    import torch

    from viewcrafter_tpu_torch.config import get_model_config
    from viewcrafter_tpu_torch.models.unet3d import UNet3D
    from viewcrafter_tpu_torch.train_loop import TrainLoop, TrainLoopConfig

    cfg = get_model_config("viewcrafter_25_512")
    with torch.device("meta"):
        n_params = sum(p.numel() for p in UNet3D(cfg.unet).parameters())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop = TrainLoop(cfg, TrainLoopConfig(warmup_steps=1, max_steps=TRAIN_STEPS))
    state = loop.init_state(torch.Generator(device="cuda").manual_seed(TRAIN_SEED))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    state_gib = torch.cuda.memory_allocated() / 2 ** 30
    batches = train_batches(cfg, TRAIN_STEPS, TRAIN_SEED, "cuda")
    run = train_steps_on_card(
        lambda on_step: loop.run(batches, None, state=state, on_step=on_step),
        state.train.params, PROFILED_STEP)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    records = run["records"]
    sites = merge_sites(*(r["sites"] for r in records))
    step_s = [r["s"] for r in records]
    per_step = [{k: r["launches"][k] for k in MAIN_KERNELS} for r in records]
    back = [{k: r["backward_plain"][k] for k in MAIN_KERNELS} for r in records]
    split, breakdown = run["split"], run["profile"]
    changed = run["changed_at_step_2"]
    res = {"phase": "train", "model": cfg.name, "unet_params": n_params,
           "batch": [1, cfg.video_length, cfg.height, cfg.width], "remat": loop.cfg.remat,
           "ema": loop.cfg.use_ema, "steps": TRAIN_STEPS, "setup_s": setup_s,
           "state_gib_before_step_1": state_gib, "step_s": step_s,
           "s_per_step": statistics.median(step_s[1:]), "peak_mem_gib": peak,
           "loss": [r["loss"] for r in records], "grad_norm": [r["grad_norm"] for r in records],
           "lr": [float(loop.lr_fn(i)) for i in range(len(records))],
           "params_changed_at_step_2": changed, "launches_per_step": per_step,
           "backward_plain_per_step": back,
           "profiled_step": PROFILED_STEP, "split": split, "profile": breakdown,
           "nvidia_smi": smi,
           "sites": {k: [[list(site), n] for site, n in v.items()] for k, v in sites.items() if v}}
    emit(res)
    del loop, state, batches, run
    torch.cuda.empty_cache()
    bad = [k for k in MAIN_KERNELS
           if not all(p[k] for p in per_step) or not all(b[k] for b in back)]
    if (not all(math.isfinite(x) for x in res["loss"]) or not changed or bad
            or any(k in sites and sites[k] for k in ("group_norm_fused", "dual_cross_attention"))):
        raise AssertionError(f"train: losses {res['loss']}, weights changed at step 2 {changed}, "
                             f"kernels without launches or backward in a step {bad}")
    return res, sites


def grad_inputs(name: str, site, randn) -> tuple:
    """Random inputs of kernel `name` at `site` (a launch-sites key), the
    differentiable ones first, and the wrapper's and twin's other arguments:
    (tensors, kwargs)."""
    import torch

    f32 = torch.float32
    if name == "fullkv_attention":
        b, s, sk, h, d = site
        return (randn(b, s, h, d), randn(b, sk, h, d), randn(b, sk, h, d)), {}
    if name == "dual_cross_attention":
        b, s, h, d, lt, li = site
        return (randn(b, s, h, d), randn(b, lt, h, d), randn(b, lt, h, d), randn(b, li, h, d),
                randn(b, li, h, d)), {}
    if name == "temporal_attention_fused":
        return tuple(randn(*site) for _ in range(3)), {}
    if name == "temporal_conv3":
        b, t, s, cin, cout = site
        return (randn(b, t, s, cin), randn(cout, 3 * cin, scale=(3 * cin) ** -0.5),
                randn(cout, scale=0.1)), {}
    if name == "fused_ff_layer":
        n, c, i, c_out = site
        return (randn(n, c), 1 + randn(c, scale=0.1, dtype=f32), randn(c, scale=0.1, dtype=f32),
                randn(2 * i, c, scale=c ** -0.5), randn(2 * i, scale=0.1),
                randn(c_out, i, scale=i ** -0.5), randn(c_out, scale=0.1)), {}
    if name == "fused_temporal_layer":
        b, t, s, c, h, d = site
        inner = h * d
        return (randn(b, t, s, c), 1 + randn(c, scale=0.1, dtype=f32),
                randn(c, scale=0.1, dtype=f32), randn(3 * inner, c, scale=c ** -0.5),
                randn(c, inner, scale=inner ** -0.5), randn(c, scale=0.1)), \
            {"heads": h, "dim_head": d}
    if name == "group_norm_fused":
        n, s, c, groups, itemsize, silu = site
        dtype = torch.bfloat16 if itemsize == 2 else f32
        return (randn(n, s, c, scale=1.5, dtype=dtype) + 0.3, 1 + randn(c, scale=0.1, dtype=f32),
                randn(c, scale=0.1, dtype=f32)), \
            {"num_groups": groups, "eps": 1e-5, "with_silu": bool(silu)}
    raise KeyError(name)


GRAD_KERNELS = ("temporal_conv3", "fused_ff_layer", "fullkv_attention", "fused_temporal_layer",
                "group_norm_fused", "dual_cross_attention", "temporal_attention_fused")


def grad_check(name: str, site, gen, peaks=None) -> dict:
    """Kernel `name` under grad at `site`, through its wrapper: the output
    must carry the Function's grad_fn, agree with the twin's output (the
    kernel rule of `kernel_sites`), and give every input the twin's gradient
    (expected bit-equal: the backward is the twin's VJP; held to the kernel
    rule); the time of the Function's backward (the twin's recompute and
    VJP) and of its forward."""
    import torch

    from viewcrafter_tpu_torch.ops import kernels
    from viewcrafter_tpu_torch.ops.kernels import _lib

    mod = kernels.KERNEL_MODULES[name]
    twin = getattr(mod, name + "_plain")

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    args, kw = grad_inputs(name, site, randn)
    leaves = [a.detach().requires_grad_(True) for a in args]
    out = getattr(mod, name)(*leaves, **kw)
    gout = randn(*out.shape, dtype=out.dtype)
    before = mod.backward_plain
    got = torch.autograd.grad(out, leaves, gout, retain_graph=True)
    ran = mod.backward_plain - before
    ref_leaves = [a.detach().requires_grad_(True) for a in args]
    ref_out = twin(*ref_leaves, **kw)
    ref = torch.autograd.grad(ref_out, ref_leaves, gout)
    worst, exact = {"max_abs_err": 0.0, "ok": True}, True
    for g, r in zip(got, ref):
        exact = exact and torch.equal(g, r)
        err = (g.float() - r.float()).abs().max().item()
        tol = 4 * 2.0 ** -8 * r.float().abs().max().item()
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        worst["ok"] = worst["ok"] and err <= tol
    fwd_err = (out.float() - ref_out.float()).abs().max().item()
    fwd_tol = 4 * 2.0 ** -8 * ref_out.float().abs().max().item()
    res = {"phase": "kernel_grad", "name": name, "site": list(site),
           "grad_fn": type(out.grad_fn).__name__ if out.grad_fn is not None else None,
           "backward_plain_calls": ran, "grads_bit_equal": exact,
           "grad_max_abs_err": worst["max_abs_err"], "forward_max_abs_err": fwd_err,
           "forward_tol": fwd_tol,
           "backward_ms": time_ms(lambda: torch.autograd.grad(out, leaves, gout, retain_graph=True),
                                  reps=3, warmup=1),
           "forward_ms": time_ms(lambda: getattr(mod, name)(*leaves, **kw), reps=3, warmup=1)}
    del got, ref, ref_out, out, leaves, ref_leaves, args
    torch.cuda.empty_cache()
    if not (res["grad_fn"] == "KernelFunctionBackward" and ran == 1 and worst["ok"] and exact
            and fwd_err <= fwd_tol):
        raise AssertionError(f"kernel_grads: {res}")
    return res




def backward_row(name: str, worst: dict, train_res: dict):
    """The `{"kernels"}` row's backward entry: the plain twin's VJP (no
    backward kernel) at the kernel's costliest training site, and the train
    phase's launches and backward passes per step; None for the kernel
    without a backward."""
    if name not in worst:
        return None
    w = worst[name]
    return {"route": "plain twin", "site": w["site"], "backward_ms": w["backward_ms"],
            "forward_ms": w["forward_ms"], "grads_bit_equal": w["grads_bit_equal"],
            "train_launches_per_step": [p.get(name, 0) for p in train_res["launches_per_step"]],
            "train_backward_plain_per_step": [b.get(name, 0)
                                              for b in train_res["backward_plain_per_step"]]}


def spatial_layer_refuses_grad() -> str:
    """`fused_spatial_layer` on a CUDA input that requires grad under grad
    mode: it must raise. Returns the message."""
    import torch

    from viewcrafter_tpu_torch.ops.kernels import spatial_layer

    c = 64
    x = torch.zeros((1, 64, c), dtype=torch.bfloat16, device="cuda", requires_grad=True)
    w = torch.zeros((3 * c, c), dtype=torch.bfloat16, device="cuda")
    ones, zeros = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
    try:
        spatial_layer.fused_spatial_layer(x, ones, zeros, w, w[:c], zeros.bfloat16(),
                                          heads=1, dim_head=64)
    except RuntimeError as exc:
        return str(exc)
    raise AssertionError("fused_spatial_layer returned under grad on a CUDA input that "
                         "requires grad")


def run_kernel_grads(gen, site_maps) -> tuple:
    """Every kernel with a backward under grad at every site of `site_maps`
    (the training phases' launches) and KERNEL_GRAD_EXTRA (a kernel no
    training phase reaches): `grad_check` each; then `fused_spatial_layer`
    must raise under grad. Returns, per kernel, the site whose backward
    takes longest with its times, and every check by kernel and site."""
    sites = merge_sites(*site_maps)
    for name, extra in KERNEL_GRAD_EXTRA.items():
        for site in extra:
            sites.setdefault(name, {}).setdefault(site, 0)
    worst, checks = {}, {}
    for name in GRAD_KERNELS:
        if not sites.get(name):
            raise AssertionError(f"kernel_grads: no site of {name}")
        for site in sites[name]:
            res = grad_check(name, site, gen)
            emit(res)
            checks.setdefault(name, {})[tuple(site)] = res
            if name not in worst or res["backward_ms"] > worst[name]["backward_ms"]:
                worst[name] = res
    msg = spatial_layer_refuses_grad()
    emit({"phase": "kernel_grads", "checks": sum(len(v) for k, v in sites.items()
                                                 if k in GRAD_KERNELS),
          "spatial_layer_under_grad": msg[:200],
          "grads_bit_equal": all(r["grads_bit_equal"] for c in checks.values()
                                 for r in c.values()),
          "costliest_backward": {k: {key: v[key] for key in ("site", "backward_ms", "forward_ms",
                                                             "grads_bit_equal")}
                                 for k, v in worst.items()}})
    return worst, checks


def train_sharded_rank(spec: dict) -> dict:
    """Rank target of `train_sharded_wiring`: load the kernels the parent
    built, one step of the wiring config's TrainLoop on the phase's mesh from
    the given weights and draws; returns the loss, the gradient norm, the
    kernels' launches and backward passes, and on rank 0 the weights'
    change."""
    import torch

    from viewcrafter_tpu_torch.ops import kernels
    from viewcrafter_tpu_torch.ops.kernels import _lib
    from viewcrafter_tpu_torch.parallel import mesh as pm

    if not _lib.library_path().exists():
        raise RuntimeError("the kernels are not built: the parent process builds them")
    _lib.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = pm.make_mesh(dp=2, devices=spec["devices"])
    device = torch.device("cuda", torch.cuda.current_device())
    weights = {k: torch.from_numpy(v) for k, v in spec["weights"].items()}
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in spec["batches"]]
    loop, state = wiring_loop(spec["cfg"], spec["loop_cfg"], device, torch.bfloat16, weights,
                              routes=True, mesh=mesh)
    kernels.reset_launches()
    run = run_loop(loop, state, batches)
    torch.cuda.synchronize()
    return {"rank": pm.rank(), "mesh": pm.mesh_shape(mesh), "loss": run["loss"],
            "grad_norm": run["grad_norm"], "step_s": run["step_s"],
            "launches": kernels.launch_counts(), "backward_plain": kernels.backward_plain_counts(),
            "sites": kernels.launch_sites(),
            "delta": {k: v.numpy() for k, v in run["delta"].items()} if pm.rank() == 0 else None}


def run_train_sharded_wiring(world: int = 4) -> tuple:
    """The wiring config's train step at dp 2 x sp 2 on `world` gloo ranks
    sharing cuda:0 (batch 2: a clip a dp rank, its 8 frames over sp), both
    routes on, one step of a constant lr (so that it moves the weights),
    against the single-rank step on this card from the same weights,
    batches and draws: the loss, gradient norm and weights' change held to
    `compare_runs`' tolerance with the yardstick of the CPU's bf16 run
    against its float32 run; every rank launches every kernel of the path
    and runs its backward. Returns (result, the ranks' launch sites)."""
    import torch

    from viewcrafter_tpu_torch.parallel import mesh as pm
    from viewcrafter_tpu_torch.train_loop import TrainLoopConfig

    cfg = wiring_config(8)
    loop_cfg = TrainLoopConfig(lr=1e-3, warmup_steps=0, schedule="constant", max_steps=1,
                               log_every=0)
    weights = wiring_weights(cfg, TRAIN_SEED + 1)
    batch = train_batches(cfg, 2, TRAIN_SEED + 1, "cpu")
    batch = [{k: torch.cat([b[k] for b in batch]) for k in batch[0]}]  # 2 clips
    runs = {}
    for name, device, dtype in (("card", "cuda", torch.bfloat16), ("cpu_f32", "cpu", torch.float32),
                                ("cpu_bf16", "cpu", torch.bfloat16)):
        loop, state = wiring_loop(cfg, loop_cfg, device, dtype, weights, routes=True)
        runs[name] = run_loop(loop, state, batch)
        del loop, state
    torch.cuda.empty_cache()
    devices = ["cuda:0"] * world
    spec = {"cfg": cfg, "loop_cfg": loop_cfg, "devices": devices,
            "weights": {k: v.numpy() for k, v in weights.items()},
            "batches": [{k: v.numpy() for k, v in b.items()} for b in batch]}
    t0 = time.perf_counter()
    ranks = pm.spawn(train_sharded_rank, world, "gloo", devices=devices, args=(spec,),
                     timeout=SPAWN_TIMEOUT)
    wall_s = time.perf_counter() - t0
    got = {"loss": ranks[0]["loss"], "grad_norm": ranks[0]["grad_norm"],
           "delta": {k: torch.from_numpy(v) for k, v in ranks[0]["delta"].items()}}
    cmp = compare_runs(got, runs["card"], (runs["cpu_bf16"], runs["cpu_f32"]), loop_cfg.lr)
    expect = set(MAIN_KERNELS) | {"group_norm_fused", "dual_cross_attention"}
    missing = {r["rank"]: [k for k in expect if not (r["launches"][k] and r["backward_plain"][k])]
               for r in ranks}
    res = {"phase": "train_sharded_wiring", "world": world, "backend": "gloo",
           "mesh": ranks[0]["mesh"], "loss": [r["loss"] for r in ranks],
           "single_rank_loss": runs["card"]["loss"],
           "grad_norm": [r["grad_norm"] for r in ranks],
           "single_rank_grad_norm": runs["card"]["grad_norm"],
           "step_s": [r["step_s"] for r in ranks], **cmp,
           "launches": [{k: r["launches"][k] for k in expect} for r in ranks],
           "backward_plain": [{k: r["backward_plain"][k] for k in expect} for r in ranks],
           "spawn_wall_s": wall_s}
    emit(res)
    if (not cmp["ok"] or any(missing.values())
            or len({(tuple(r["loss"]), tuple(r["grad_norm"])) for r in ranks}) != 1):
        raise AssertionError(f"train_sharded_wiring: {res}")
    return res, [r["sites"] for r in ranks]


# --------------------------------------------------------------------------
# DUSt3R and CroCo training
# --------------------------------------------------------------------------


def pretrain_wiring_configs() -> dict:
    """A small DUSt3R (linear head) and a small CroCo whose every attention
    passes fullkv's gate: 128 wide, 2 heads of 64, 128x256 images (128
    tokens; the CroCo masks half, so its visible tokens are 64)."""
    from viewcrafter_tpu_torch.config import Dust3rConfig
    from viewcrafter_tpu_torch.models.croco_pretrain import CroCoPretrainConfig

    small = dict(img_size=(128, 256), enc_embed_dim=128, enc_depth=2, enc_num_heads=2,
                 dec_embed_dim=128, dec_depth=2, dec_num_heads=2)
    return {"dust3r": Dust3rConfig(**small, head_type="linear"),
            "croco": CroCoPretrainConfig(**small, mask_ratio=0.5)}


def pretrain_fullkv_per_step(kind: str, cfg) -> int:
    """fullkv launches (and backward passes) of one pretraining step: for
    DUSt3R a call launches once per encoder block (both views batched) and
    four times per decoder depth (self and cross attention of two streams),
    two calls a step (symmetrized); CroCo encodes its two views apart and
    runs one decoder stream."""
    if kind == "dust3r":
        return 2 * (cfg.enc_depth + 4 * cfg.dec_depth)
    return 2 * cfg.enc_depth + 2 * cfg.dec_depth


def with_delta(run: dict, weights: dict) -> dict:
    """A `_dryrun.pretrain_steps` result with the weights' change from
    `weights` (float32 CPU tensors), as `compare_runs` takes it."""
    return {**run, "delta": {k: run["params"][k] - weights[k].float() for k in weights}}


def run_pretrain_wiring() -> tuple:
    """The small DUSt3R (symmetrized) and CroCo train steps, PRETRAIN_WIRING_STEPS
    each, on the card (bf16, float32 master weights) against the CPU in
    float32, from the same weights and batches (the CroCo's masks fixed): the
    losses, gradient norms and weight changes within `compare_runs`'
    tolerance (the CPU's bf16 run against its float32 run the yardstick), and
    fullkv launched forward and run backward at every attention of every
    step; the CroCo translator's round trip of the card's trained weights;
    then both at dp 2 on 2 gloo ranks sharing cuda:0 against the card's
    single-rank run, at the same tolerance. Returns (result, launch sites)."""
    import torch

    from viewcrafter_tpu_torch import _dryrun
    from viewcrafter_tpu_torch.ops import kernels
    from viewcrafter_tpu_torch.parallel import mesh as pm
    from viewcrafter_tpu_torch.utils.checkpoint import (
        croco_pretrain_from_reference, croco_pretrain_to_reference)

    steps, lr = PRETRAIN_WIRING_STEPS, _dryrun.PRETRAIN_LR
    res, sites, specs, ok = {"phase": "pretrain_wiring", "steps": steps, "lr": lr}, [], [], True
    for kind, cfg in pretrain_wiring_configs().items():
        weights = _dryrun.seeded_weights(kind, cfg, TRAIN_SEED)
        batches = [_dryrun.pretrain_batch(kind, cfg, 2, seed=TRAIN_SEED + i) for i in range(steps)]
        runs = {}
        for name, device, dtype in (("card", "cuda", torch.bfloat16),
                                    ("cpu_f32", "cpu", torch.float32),
                                    ("cpu_bf16", "cpu", torch.bfloat16)):
            kernels.reset_launches()
            runs[name] = with_delta(_dryrun.pretrain_steps(kind, cfg, weights, batches, device,
                                                           dtype), weights)
            if name == "card":
                counts, back = kernels.launch_counts(), kernels.backward_plain_counts()
                sites.append(kernels.launch_sites())
        cmp = compare_runs(runs["card"], runs["cpu_f32"], (runs["cpu_bf16"], runs["cpu_f32"]), lr)
        want = steps * pretrain_fullkv_per_step(kind, cfg)
        line = {"config": str(cfg), **{f"{k}_loss": runs[k]["loss"] for k in runs},
                **{f"{k}_grad_norm": runs[k]["grad_norm"] for k in runs}, **cmp,
                "fullkv_launches": counts["fullkv_attention"],
                "fullkv_backward_plain": back["fullkv_attention"], "fullkv_expected": want,
                "other_launches": sum(counts.values()) - counts["fullkv_attention"]}
        ok &= (cmp["ok"] and counts["fullkv_attention"] == back["fullkv_attention"] == want
               and line["other_launches"] == 0)
        if kind == "croco":
            ref = croco_pretrain_to_reference(runs["card"]["params"], cfg)
            back_sd = croco_pretrain_from_reference(ref, cfg)
            line["translator_round_trip_equal"] = set(back_sd) == set(runs["card"]["params"]) \
                and all(torch.equal(back_sd[k], v) for k, v in runs["card"]["params"].items())
            line["reference_keys"] = len(ref)
            ok &= line["translator_round_trip_equal"]
        res[kind] = line
        specs.append({"kind": kind, "cfg": cfg, "batches": batches, "card": runs["card"],
                      "yard": (runs["cpu_bf16"], runs["cpu_f32"]), "weights": weights})
    # dp 2: both models in one spawn, a sample a rank
    devices = ["cuda:0"] * 2
    t0 = time.perf_counter()
    ranks = pm.spawn(_dryrun.pretrain_on_mesh, 2, "gloo", devices=devices, timeout=SPAWN_TIMEOUT,
                     args=({"devices": devices, "dtype": torch.bfloat16,
                            "runs": [{k: sp[k] for k in ("kind", "cfg", "batches")} |
                                     {"weights": {n: v.numpy() for n, v in sp["weights"].items()}}
                                     for sp in specs]},))
    res["dp2_spawn_wall_s"] = time.perf_counter() - t0
    for i, sp in enumerate(specs):
        got = ranks[0]["runs"][i]
        got = with_delta({**got, "params": {k: torch.from_numpy(v)
                                            for k, v in got["params"].items()}}, sp["weights"])
        cmp = compare_runs(got, sp["card"], sp["yard"], lr)
        want = steps * pretrain_fullkv_per_step(sp["kind"], sp["cfg"])
        launched = [r["runs"][i]["launches"]["fullkv_attention"] for r in ranks]
        res[sp["kind"]]["dp2"] = {"mesh": ranks[0]["mesh"], "loss": got["loss"],
                                  "single_rank_loss": sp["card"]["loss"], **cmp,
                                  "fullkv_launches_per_rank": launched}
        same = len({tuple(r["runs"][i]["loss"]) for r in ranks}) == 1
        ok &= cmp["ok"] and same and launched == [want] * 2
        sites += [r["runs"][i]["sites"] for r in ranks]
    emit(res)
    if not ok:
        raise AssertionError(f"pretrain_wiring: {res}")
    return res, merge_sites(*sites)


def reference_adamw(peak_lr: float):
    """The DUSt3R and CroCo references' AdamW (betas 0.9 / 0.95, weight
    decay 0.05, no clip) on a linear warmup from 0 to `peak_lr` over
    PRETRAIN_WARMUP steps: step 1's lr is 0."""
    from viewcrafter_tpu_torch.train_loop import AdamW, linear_schedule

    return AdamW(linear_schedule(0.0, peak_lr, PRETRAIN_WARMUP), grad_clip=float("inf"),
                 weight_decay=0.05, b2=0.95)


def train_steps_on_card(drive, params: dict, profiled: int) -> dict:
    """Record the train steps that `drive(on_step)` runs on the card, where
    `on_step(step, loss, grad_norm, parts=None)` is called after each step
    (`TrainLoop.run`'s hook, after its EMA update): per step the seconds,
    the loss, the gradient norm, the loss's parts, and every kernel's
    launches, backward passes, launch sites and backward passes per site
    (the counts are reset before each step); whether the four largest
    master weights of `params` changed at step 2 (step 1's lr is 0; their
    first CHANGE_PROBE elements compared); step
    `profiled` under torch.profiler, split into forward, backward, optimizer
    and EMA where there is one (`phase_split`), with its kernel categories.
    The hook's own work falls outside the steps' seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from viewcrafter_tpu_torch.ops import kernels

    probe = sorted(params, key=lambda k: -params[k].numel())[:4]
    recs, box = [], {}

    def head(k):
        return params[k].reshape(-1)[:CHANGE_PROBE]

    def start(step):  # just before `step`
        kernels.reset_launches()
        if step == profiled:
            box["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            box["prof"].__enter__()
        torch.cuda.synchronize()
        box["t"] = time.perf_counter()

    def on_step(step, loss, grad_norm, parts=None):
        torch.cuda.synchronize()
        dt = time.perf_counter() - box["t"]
        if step == profiled:
            box["prof"].__exit__(None, None, None)
            box["split"] = phase_split(box["prof"])
            box["profile"] = device_breakdown(box.pop("prof"), dt * 1e3)
        recs.append({"s": dt, "loss": float(loss), "grad_norm": float(grad_norm),
                     "parts": None if parts is None else {k: float(v) for k, v in parts.items()},
                     "launches": kernels.launch_counts(),
                     "backward_plain": kernels.backward_plain_counts(),
                     "sites": kernels.launch_sites(), "backward_sites": kernels.backward_sites()})
        if step == 1:
            box["before"] = {k: head(k).clone() for k in probe}
        elif step == 2:
            box["changed"] = any(not torch.equal(box.pop("before")[k], head(k)) for k in probe)
        start(step + 1)

    start(1)
    drive(on_step)
    return {"records": recs, "changed_at_step_2": box.get("changed"), "split": box["split"],
            "profile": box["profile"]}


def pretrain_steps_on_card(step_fn, params: dict, n: int) -> dict:
    """`train_steps_on_card` over `n` calls of `step_fn()` (a pretraining
    step: (state, loss, grad_norm) or (state, loss, parts, grad_norm)), the
    last one profiled."""

    def drive(on_step):
        for i in range(1, n + 1):
            out = step_fn()
            on_step(i, out[1], out[-1], out[2] if len(out) == 4 else None)

    return train_steps_on_card(drive, params, n)


def run_dust3r_train(smi: str) -> tuple:
    """DUSt3R fine-tuning at full width and depth: `make_dust3r_train_step`
    on `dust3r_512` (the released ViT-L encoder, Base decoder and DPT
    heads), seeded weights in bf16 with float32 master weights,
    ConfLoss(Regr3D) with alpha 0.2, mode plain, symmetrized; the
    reference's AdamW (`reference_adamw`); B = DUST3R_PAIRS view pairs at
    384x512 (S = 768 tokens) from `SyntheticMultiviewGenerator` rendered on
    the card, in the Co3dPairDataset layout (`as_dust3r_pairs`);
    DUST3R_STEPS steps. fullkv must launch at every attention, forward and
    backward: per model call 24 encoder sites (2B, 768, 768, 16, 64) and 48
    decoder sites (B, 768, 768, 12, 64), two calls a step, each launch with
    its backward pass at its site, as counted. Returns (result, launch
    sites, per fullkv site its launches and backward passes in each step)."""
    import math

    import torch

    from viewcrafter_tpu_torch.config import get_dust3r_config
    from viewcrafter_tpu_torch.data.synth_multiview import SyntheticMultiviewGenerator
    from viewcrafter_tpu_torch.models.dust3r import Dust3rModel
    from viewcrafter_tpu_torch.pretrain import collate_views, make_dust3r_train_step
    from viewcrafter_tpu_torch.training import create_train_state

    cfg = get_dust3r_config("dust3r_512")
    h, w = DUST3R_RES
    t0 = time.perf_counter()
    views = SyntheticMultiviewGenerator(resolution=DUST3R_RES, seed=TRAIN_SEED, device="cuda")
    pairs = [views.as_dust3r_pairs(i) for i in range(DUST3R_PAIRS)]
    data_s = time.perf_counter() - t0
    batch = {g: {k: v.cuda() for k, v in collate_views([p[j] for p in pairs]).items()}
             for j, g in enumerate(("gt1", "gt2"))}
    valid = [float(batch[g]["valid_mask"].float().mean()) for g in ("gt1", "gt2")]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.device("cuda"):
        model = Dust3rModel(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    tx = reference_adamw(DUST3R_LR)
    state = create_train_state(model, cfg, torch.Generator(device="cuda").manual_seed(TRAIN_SEED),
                               tx)
    step = make_dust3r_train_step(model, tx, alpha=0.2, mode="plain", symmetrized=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    run = pretrain_steps_on_card(lambda: step(state, batch), state.params, DUST3R_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    b, s = DUST3R_PAIRS, (h // cfg.patch_size) * (w // cfg.patch_size)
    enc = (2 * b, s, s, cfg.enc_num_heads, cfg.enc_embed_dim // cfg.enc_num_heads)
    dec = (b, s, s, cfg.dec_num_heads, cfg.dec_embed_dim // cfg.dec_num_heads)
    want = {enc: 2 * cfg.enc_depth, dec: 2 * 4 * cfg.dec_depth}
    recs = run["records"]
    fk_sites = [r["sites"]["fullkv_attention"] for r in recs]
    fk_back = [r["backward_sites"]["fullkv_attention"] for r in recs]
    others = [sum(r["launches"].values()) - r["launches"]["fullkv_attention"] for r in recs]
    res = {"phase": "dust3r_train", "model": "dust3r_512", "params": n_params,
           "batch_pairs": b, "image": [h, w], "tokens": s, "symmetrized": True, "alpha": 0.2,
           "mode": "plain", "optimizer": {"peak_lr": DUST3R_LR, "warmup": PRETRAIN_WARMUP,
                                          "betas": [0.9, 0.95], "weight_decay": 0.05},
           "lr": [float(tx.lr_fn(i)) for i in range(DUST3R_STEPS)],
           "steps": DUST3R_STEPS, "data_s": data_s, "valid_share": valid,
           "setup_s": setup_s,
           "step_s": [r["s"] for r in recs],
           "s_per_step": statistics.median([r["s"] for r in recs[1:]]), "peak_mem_gib": peak,
           "loss": [r["loss"] for r in recs], "grad_norm": [r["grad_norm"] for r in recs],
           "parts": [r["parts"] for r in recs], "weights_changed_at_step_2": run["changed_at_step_2"],
           "fullkv_launches_per_step": [r["launches"]["fullkv_attention"] for r in recs],
           "fullkv_backward_plain_per_step": [r["backward_plain"]["fullkv_attention"]
                                              for r in recs],
           "fullkv_expected_per_step": sum(want.values()),
           "fullkv_sites_per_step": [[[list(k), n] for k, n in f.items()] for f in fk_sites],
           "fullkv_backward_sites_per_step": [[[list(k), n] for k, n in f.items()]
                                              for f in fk_back],
           "fullkv_sites_expected": [[list(k), n] for k, n in want.items()],
           "other_kernel_launches": others,
           "profiled_step": DUST3R_STEPS, "split": run["split"], "profile": run["profile"],
           "cuts": [f"{DUST3R_STEPS} steps", "seeded random weights",
                    "synthetic scenes in place of CO3D / the reference's training mix"],
           "nvidia_smi": smi}
    emit(res)
    # the sites as launched, and per site the launches and backward passes
    # of each step, as counted
    sites = merge_sites(*(r["sites"] for r in recs))
    per_step = {k: {"launches": [f.get(k, 0) for f in fk_sites],
                    "backward_plain": [f.get(k, 0) for f in fk_back]}
                for k in set().union(*fk_sites, *fk_back)}
    del model, state, step, batch, run
    torch.cuda.empty_cache()
    bad = [i for i in range(len(recs))
           if fk_sites[i] != want or fk_back[i] != want or others[i]]
    if not all(math.isfinite(x) for x in res["loss"]) or not res["weights_changed_at_step_2"] \
            or bad:
        raise AssertionError(f"dust3r_train: losses {res['loss']}, weights changed "
                             f"{res['weights_changed_at_step_2']}, steps off the expected "
                             f"fullkv launches or backward passes {bad}")
    return res, sites, per_step


def run_croco_pretrain(smi: str) -> dict:
    """CroCo pretraining at the published width: `make_croco_pretrain_step`
    on the default `CroCoPretrainConfig` (ViT-B encoder 768/12/12, decoder
    512/8/16, 224x224, mask ratio 0.9), seeded weights in bf16 with float32
    master weights, the reference's AdamW (`reference_adamw`); CROCO_PAIRS pairs from
    `SyntheticMultiviewGenerator` at 224x224 drawn once, a new mask a step
    from a card generator; CROCO_STEPS steps. It launches no kernel: its
    196 tokens (20 visible) are no multiple of 64 and its decoder's heads
    are 32 wide, so fullkv's gate (the JAX package's) sends every attention
    to the plain path; the phase prints the gate's answer at each shape."""
    import math

    import numpy as np
    import torch

    from viewcrafter_tpu_torch.data.synth_multiview import SyntheticMultiviewGenerator
    from viewcrafter_tpu_torch.models.croco_pretrain import CroCoPretrain, CroCoPretrainConfig
    from viewcrafter_tpu_torch.ops.kernels.fullkv_attention import supports_fullkv
    from viewcrafter_tpu_torch.pretrain import make_croco_pretrain_step
    from viewcrafter_tpu_torch.training import create_train_state

    cfg = CroCoPretrainConfig()
    t0 = time.perf_counter()
    views = SyntheticMultiviewGenerator(resolution=cfg.img_size, seed=TRAIN_SEED + 1,
                                        device="cuda")
    pairs = [views.as_croco_pairs(i) for i in range(CROCO_PAIRS)]
    data_s = time.perf_counter() - t0
    batch = {f"img{j + 1}": torch.from_numpy(np.stack([p[j]["img"] for p in pairs])).cuda()
             for j in range(2)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.device("cuda"):
        model = CroCoPretrain(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    tx = reference_adamw(CROCO_LR)
    state = create_train_state(model, cfg, torch.Generator(device="cuda").manual_seed(TRAIN_SEED),
                               tx)
    step = make_croco_pretrain_step(model, tx)
    masks = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    run = pretrain_steps_on_card(lambda: step(state, batch, generator=masks), state.params,
                                 CROCO_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = (cfg.img_size[0] // cfg.patch_size) * (cfg.img_size[1] // cfg.patch_size)
    vis, b = n - cfg.num_mask(n), CROCO_PAIRS
    de, dd = cfg.enc_embed_dim // cfg.enc_num_heads, cfg.dec_embed_dim // cfg.dec_num_heads
    gate = {"encoder_visible": [b, vis, cfg.enc_num_heads, de],
            "encoder_whole": [b, n, cfg.enc_num_heads, de],
            "decoder": [b, n, cfg.dec_num_heads, dd]}
    recs = run["records"]
    res = {"phase": "croco_pretrain", "config": str(cfg), "params": n_params, "pairs": b,
           "optimizer": {"peak_lr": CROCO_LR, "warmup": PRETRAIN_WARMUP, "betas": [0.9, 0.95],
                         "weight_decay": 0.05},
           "lr": [float(tx.lr_fn(i)) for i in range(CROCO_STEPS)],
           "steps": CROCO_STEPS, "data_s": data_s, "setup_s": setup_s,
           "step_s": [r["s"] for r in recs],
           "s_per_step": statistics.median([r["s"] for r in recs[1:]]), "peak_mem_gib": peak,
           "loss": [r["loss"] for r in recs], "grad_norm": [r["grad_norm"] for r in recs],
           "weights_changed_at_step_2": run["changed_at_step_2"],
           "kernel_launches_per_step": [sum(r["launches"].values()) for r in recs],
           "fullkv_gate": {k: {"q_shape": v, "takes_kernel": supports_fullkv(v, v)}
                           for k, v in gate.items()},
           "no_kernel_because": f"{n} tokens ({vis} visible) are no multiple of 64 and the "
                                f"decoder's heads are {dd} wide: fullkv's gate (the JAX "
                                "package's) sends every attention to the plain path",
           "split": run["split"], "profile": run["profile"],
           "cuts": [f"batch {b} pairs (the reference's 64 a GPU)", f"{CROCO_STEPS} steps",
                    "seeded random weights", "synthetic scenes in place of habitat-sim"],
           "nvidia_smi": smi}
    emit(res)
    del model, state, step, batch, run
    torch.cuda.empty_cache()
    if (not all(math.isfinite(x) for x in res["loss"]) or not res["weights_changed_at_step_2"]
            or any(res["kernel_launches_per_step"])
            or any(g["takes_kernel"] for g in res["fullkv_gate"].values())):
        raise AssertionError(f"croco_pretrain: {res}")
    return res


# --------------------------------------------------------------------------
# CroCo downstream stereo and flow
# --------------------------------------------------------------------------


def stereoflow_wiring_configs() -> dict:
    """A small CroCo downstream whose every attention passes fullkv's gate:
    128 wide with 2 heads of 64, the crop 128x256 (128 tokens), decoder
    depth 8 (one of the depths `default_hooks` takes), small DPT widths; a
    stereo head (1 + conf), a flow head (2 + conf) and the monocular
    encoder (4 blocks, its hooks 0..3)."""
    from viewcrafter_tpu_torch.models.croco_downstream import CroCoDownstreamConfig

    small = dict(img_size=(128, 256), enc_embed_dim=128, enc_depth=2, enc_num_heads=2,
                 dec_embed_dim=128, dec_depth=8, dec_num_heads=2,
                 dpt_layer_dims=(16, 16, 32, 64), dpt_feature_dim=32, dpt_last_dim=16)
    return {"stereo": CroCoDownstreamConfig(**small, num_channels=2),
            "flow": CroCoDownstreamConfig(**small, num_channels=3),
            "mono": CroCoDownstreamConfig(**dict(small, enc_depth=4), num_channels=2)}


def downstream_model(kind: str, cfg, device, dtype):
    """The binocular model ("stereo", "flow") or the monocular encoder
    ("mono") of `cfg` on `device`, its weights in `dtype`."""
    import torch

    from viewcrafter_tpu_torch.models.croco_downstream import (
        CroCoDownstreamBinocular, CroCoDownstreamMonocularEncoder)

    cls = CroCoDownstreamMonocularEncoder if kind == "mono" else CroCoDownstreamBinocular
    with torch.device(device):
        return cls(cfg, dtype=dtype)


def fullkv_per_forward(kind: str, cfg) -> int:
    """fullkv launches of one forward: one per encoder block (both views in
    one batch), and a self and a cross attention per decoder block."""
    return cfg.enc_depth + (0 if kind == "mono" else 2 * cfg.dec_depth)


def stereo_batch(b: int, h: int, w: int, seed: int, invalid: float = 0.0) -> tuple:
    """A seeded numpy training batch: two ImageNet-normalized images
    (B, H, W, 3) and a disparity (B, H, W, 1) in [0, 64), a share `invalid`
    of it +inf."""
    import numpy as np

    from viewcrafter_tpu_torch.stereoflow.data import to_model_input

    rng = np.random.default_rng(seed)
    img1, img2 = (to_model_input(rng.integers(0, 256, (b, h, w, 3))) for _ in range(2))
    gt = rng.uniform(0, 64, (b, h, w, 1)).astype(np.float32)
    gt[rng.uniform(size=(b, h, w)) < invalid] = np.inf
    return img1, img2, gt


def stereoflow_steps(cfg, weights: dict, batches: list, device, dtype) -> dict:
    """`make_stereoflow_train_step` (laplacian_loss_bounded2, with the
    confidence) on the stereo model of `cfg` from `weights`, one step a batch,
    with `train_loop.adamw(PRETRAIN_LR)`, on `device` in `dtype`: per step the
    loss and the gradient norm, and the final master weights (CPU float32)."""
    import torch

    from viewcrafter_tpu_torch._dryrun import PRETRAIN_LR
    from viewcrafter_tpu_torch.stereoflow.criterion import laplacian_loss_bounded2
    from viewcrafter_tpu_torch.stereoflow.engine import make_stereoflow_train_step
    from viewcrafter_tpu_torch.train_loop import adamw
    from viewcrafter_tpu_torch.training import create_train_state

    model = downstream_model("stereo", cfg, device, dtype)
    tx = adamw(PRETRAIN_LR)
    state = create_train_state(model, cfg, weights, tx)
    step = make_stereoflow_train_step(model, tx, laplacian_loss_bounded2, with_conf=True)
    losses, norms = [], []
    for batch in batches:
        _, loss, grad_norm = step(state, *(torch.from_numpy(x) for x in batch))
        losses.append(float(loss))
        norms.append(float(grad_norm))
    return {"loss": losses, "grad_norm": norms,
            "params": {k: v.detach().float().cpu() for k, v in state.params.items()}}


def run_stereoflow_wiring(gen, steps: int = STEREO_WIRING_STEPS) -> tuple:
    """The small downstream models (`stereoflow_wiring_configs`), seeded on
    the card (bf16), against the same weights on the CPU in float32 and in
    bf16 (the yardstick): `tiled_pred` of the stereo and flow models on a
    160x320 pair (4 tiles of 128x256) and on a 96x200 pair smaller than the
    crop (the cubic upscale to 128x267, 2 tiles, and the antialiased resize
    back), the monocular encoder on a 128x256 pair; then `steps` steps of
    `make_stereoflow_train_step` on the stereo model (laplacian_loss_bounded2)
    on the card and on the CPU from the same weights and batches, within
    `compare_runs`' tolerance. fullkv must launch enc_depth + 2 dec_depth
    times a forward (the encoder's depth alone for the monocular model),
    and run as many backward passes a step, and no other kernel launch.
    Returns (result, every launch site, the training's launch sites)."""
    import torch

    from viewcrafter_tpu_torch._dryrun import PRETRAIN_LR
    from viewcrafter_tpu_torch.models.layers import init_random_
    from viewcrafter_tpu_torch.ops import kernels
    from viewcrafter_tpu_torch.stereoflow.engine import tiled_pred

    cfgs = stereoflow_wiring_configs()
    crop = cfgs["stereo"].img_size
    res, sites, ok = {"phase": "stereoflow_wiring", "crop": list(crop), "outputs": {}}, [], True
    for i, (kind, cfg) in enumerate(cfgs.items()):
        card = downstream_model(kind, cfg, "cuda", torch.bfloat16).eval()
        init_random_(card, torch.Generator(device="cuda").manual_seed(TRAIN_SEED + i))
        state = {k: v.float().cpu() for k, v in card.state_dict().items()}
        cpu = [downstream_model(kind, cfg, "cpu", dt).eval() for dt in (torch.float32,
                                                                         torch.bfloat16)]
        for m in cpu:
            m.load_state_dict(state)
        if kind == "mono":
            cases = {"forward_128x256": (128, 256)}
        else:
            cases = {"tiled_160x320": (160, 320), "upscaled_96x200": (96, 200)}
        for case, (h, w) in cases.items():
            imgs = [torch.rand((1, h, w, 3), generator=gen, device="cuda") * 2 - 1
                    for _ in range(1 if kind == "mono" else 2)]

            def run(model, xs):
                if kind == "mono":
                    return {"pred": model(*xs)}
                pred, _, conf = tiled_pred(model, *xs, crop=crop, overlap=0.5,
                                           conf_mode="conf_expsigmoid_10_5", with_conf=True)
                return {"pred": pred, "conf": conf}

            kernels.reset_launches()
            with torch.no_grad():
                out = run(card, imgs)
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                sites.append(kernels.launch_sites())
                refs = [run(m, [x.cpu() for x in imgs]) for m in cpu]
            line = {k: against_cpu(out[k], refs[0][k], refs[1][k]) for k in out}
            line.update(shape=list(out["pred"].shape), fullkv_launches=counts["fullkv_attention"],
                        fullkv_expected=fullkv_per_forward(kind, cfg),
                        other_launches=sum(counts.values()) - counts["fullkv_attention"])
            ok &= (all(v["ok"] for k, v in line.items() if k in out)
                   and line["fullkv_launches"] == line["fullkv_expected"]
                   and line["other_launches"] == 0)
            res["outputs"][f"{kind}_{case}"] = line
        del card, cpu
    # the train steps: the card against the CPU from the same weights
    cfg = cfgs["stereo"]
    seeded = init_random_(downstream_model("stereo", cfg, "cpu", torch.float32),
                          torch.Generator().manual_seed(TRAIN_SEED))
    weights = {k: v.detach().clone() for k, v in seeded.state_dict().items()}
    batches = [stereo_batch(2, *crop, seed=TRAIN_SEED + s, invalid=0.1) for s in range(steps)]
    runs = {}
    for name, device, dtype in (("card", "cuda", torch.bfloat16), ("cpu_f32", "cpu", torch.float32),
                                ("cpu_bf16", "cpu", torch.bfloat16)):
        kernels.reset_launches()
        runs[name] = with_delta(stereoflow_steps(cfg, weights, batches, device, dtype), weights)
        if name == "card":
            counts, back = kernels.launch_counts(), kernels.backward_plain_counts()
            train_sites = kernels.launch_sites()
    cmp = compare_runs(runs["card"], runs["cpu_f32"], (runs["cpu_bf16"], runs["cpu_f32"]),
                       PRETRAIN_LR)
    want = steps * fullkv_per_forward("stereo", cfg)
    res["train"] = {"steps": steps, "lr": PRETRAIN_LR, "loss_fn": "laplacian_loss_bounded2",
                    **{f"{k}_loss": runs[k]["loss"] for k in runs},
                    **{f"{k}_grad_norm": runs[k]["grad_norm"] for k in runs}, **cmp,
                    "fullkv_launches": counts["fullkv_attention"],
                    "fullkv_backward_plain": back["fullkv_attention"], "fullkv_expected": want,
                    "other_launches": sum(counts.values()) - counts["fullkv_attention"]}
    ok &= (cmp["ok"] and counts["fullkv_attention"] == back["fullkv_attention"] == want
           and res["train"]["other_launches"] == 0)
    emit(res)
    if not ok:
        raise AssertionError(f"stereoflow_wiring: {res}")
    return res, merge_sites(*sites, train_sites), train_sites


def run_stereo_tiled(smi: str) -> tuple:
    """Tiled inference at the released width: CroCo-Stereo (1 + conf) with
    seeded weights in bf16 on a seeded numpy pair of KITTI 2015's size
    (375x1242) at the released crop 352x704 (6 tiles of 968 tokens in one
    forward: fullkv's gate, the JAX package's, takes none, so no launch) and
    at 384x768 (the pair upscaled to 384x1272, 3 tiles of 1152 tokens: fullkv
    24 times at (6, 1152, 1152, 16, 64) and 24 at (3, 1152, 1152, 12, 64));
    CroCo-Flow (2 + conf) on a pair of MPI-Sintel's size (436x1024) at
    352x704 (4 tiles). Overlap 0.5, conf_expsigmoid_10_5. Per case: seconds
    per pair (median of STEREO_TILED_REPS after a warm-up call, whose
    launches are counted), peak memory, tiles, launches and sites against
    the expected ones, finiteness. Returns (result, launch sites)."""
    import numpy as np
    import torch

    from viewcrafter_tpu_torch.models.croco_downstream import CroCoDownstreamConfig
    from viewcrafter_tpu_torch.models.layers import init_random_
    from viewcrafter_tpu_torch.ops import kernels
    from viewcrafter_tpu_torch.ops.kernels.fullkv_attention import supports_fullkv
    from viewcrafter_tpu_torch.stereoflow.data import to_model_input
    from viewcrafter_tpu_torch.stereoflow.engine import tiled_pred

    enc, dec = (6, 1152, 1152, 16, 64), (3, 1152, 1152, 12, 64)
    cases = (("stereo_kitti_352x704", 2, KITTI_SIZE, RELEASED_CROP, 6, {}),
             ("stereo_kitti_384x768", 2, KITTI_SIZE, GATED_CROP, 3, {enc: 24, dec: 24}),
             ("flow_sintel_352x704", 3, SINTEL_SIZE, RELEASED_CROP, 4, {}))
    res, sites, ok, models = {"phase": "stereo_tiled", "cases": {}, "nvidia_smi": smi}, [], True, {}
    for case, nch, size, crop, tiles_want, want in cases:
        built = nch not in models
        if built:
            models.clear()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            # the released topology (CroCoDownstreamConfig's defaults)
            models[nch] = downstream_model("stereo", CroCoDownstreamConfig(num_channels=nch),
                                           "cuda", torch.bfloat16).eval()
            init_random_(models[nch], torch.Generator(device="cuda").manual_seed(TRAIN_SEED + nch))
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
        model = models[nch]
        rng = np.random.default_rng(TRAIN_SEED)
        pair = [torch.from_numpy(to_model_input(rng.integers(0, 256, (1, *size, 3)))).cuda()
                for _ in range(2)]
        tokens = (crop[0] // 16) * (crop[1] // 16)
        batches = []  # the batch of each forward: the tiles, one pair each

        def call():
            with torch.no_grad():
                return tiled_pred(lambda a, b: batches.append(a.shape[0]) or model(a, b), *pair,
                                  crop=crop, overlap=0.5, conf_mode="conf_expsigmoid_10_5",
                                  with_conf=True)

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        pred, _, conf = call()
        torch.cuda.synchronize()
        counts, launched = kernels.launch_counts(), kernels.launch_sites()
        tiles, forwards = sum(batches), len(batches)
        sites.append(launched)
        times = []
        for _ in range(STEREO_TILED_REPS):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        line = {"size": list(size), "crop": list(crop), "tiled_size": list(conf.shape[1:]),
                "tiles": tiles, "tiles_expected": tiles_want, "forwards": forwards,
                "tokens_per_tile": tokens,
                "fullkv_gate": supports_fullkv((2 * tiles, tokens, 16, 64),
                                               (2 * tiles, tokens, 16, 64)),
                "s_per_pair": statistics.median(times),
                "s_per_pair_runs": times, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "pred_shape": list(pred.shape), "conf_shape": list(conf.shape),
                "finite": bool(torch.isfinite(pred).all() and torch.isfinite(conf).all()),
                "fullkv_launches": counts["fullkv_attention"],
                "fullkv_expected": sum(want.values()),
                "fullkv_sites": [[list(k), n] for k, n in launched["fullkv_attention"].items()],
                "fullkv_sites_expected": [[list(k), n] for k, n in want.items()],
                "other_launches": sum(counts.values()) - counts["fullkv_attention"]}
        if built:  # the case after it reuses this model
            line["model_setup_s"] = setup_s
        ok &= (tiles == tiles_want and forwards == 1 and line["finite"] and launched["fullkv_attention"] == want
               and line["other_launches"] == 0 and line["fullkv_gate"] == bool(want)
               and line["pred_shape"] == [1, *size, nch - 1])
        res["cases"][case] = line
        del pair, pred, conf
    models.clear()
    torch.cuda.empty_cache()
    res["params"] = sum(p.numel() for p in downstream_model(
        "stereo", CroCoDownstreamConfig(), "meta", torch.bfloat16).parameters())
    res["cuts"] = ["seeded random weights", "seeded numpy pairs of the data sets' sizes in place "
                   "of KITTI 2015 and MPI-Sintel", f"{STEREO_TILED_REPS} timed calls a case"]
    emit(res)
    if not ok:
        raise AssertionError(f"stereo_tiled: {res}")
    return res, merge_sites(*sites)


def run_stereo_train(smi: str) -> dict:
    """CroCo-Stereo training at the released width: `make_stereoflow_train_step`
    on the default `CroCoDownstreamConfig` (1 + conf), seeded weights in bf16 with float32
    master weights, laplacian_loss_bounded2, the references' AdamW (betas
    0.9 / 0.95, weight decay 0.05, no clip) at CroCo-Stereo's lr STEREO_LR,
    held constant (the seeded model's losses stay finite without
    `reference_adamw`'s warmup), STEREO_PAIRS seeded pairs at the released crop 352x704 with
    finite random disparities, STEREO_TRAIN_STEPS steps, the last one
    profiled into forward, backward and optimizer. No kernel launches: 968
    tokens fail fullkv's gate."""
    import math

    import torch

    from viewcrafter_tpu_torch.models.croco_downstream import CroCoDownstreamConfig
    from viewcrafter_tpu_torch.ops.kernels.fullkv_attention import supports_fullkv
    from viewcrafter_tpu_torch.stereoflow.criterion import laplacian_loss_bounded2
    from viewcrafter_tpu_torch.stereoflow.engine import make_stereoflow_train_step
    from viewcrafter_tpu_torch.train_loop import AdamW, constant_schedule
    from viewcrafter_tpu_torch.training import create_train_state

    cfg = CroCoDownstreamConfig()  # CroCo-Stereo's released topology, 1 + conf
    batch = [torch.from_numpy(x).cuda() for x in stereo_batch(STEREO_PAIRS, *RELEASED_CROP,
                                                                seed=TRAIN_SEED)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = downstream_model("stereo", cfg, "cuda", torch.bfloat16)
    tx = AdamW(constant_schedule(STEREO_LR), grad_clip=float("inf"), weight_decay=0.05, b2=0.95)
    state = create_train_state(model, cfg, torch.Generator(device="cuda").manual_seed(TRAIN_SEED),
                               tx)
    step = make_stereoflow_train_step(model, tx, laplacian_loss_bounded2, with_conf=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    run = pretrain_steps_on_card(lambda: step(state, *batch), state.params, STEREO_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    recs = run["records"]
    tokens = (RELEASED_CROP[0] // 16) * (RELEASED_CROP[1] // 16)
    res = {"phase": "stereo_train", "params": sum(p.numel() for p in model.parameters()),
           "pairs": STEREO_PAIRS, "crop": list(RELEASED_CROP), "tokens": tokens,
           "loss_fn": "laplacian_loss_bounded2",
           "optimizer": {"lr": STEREO_LR, "schedule": "constant", "betas": [0.9, 0.95],
                         "weight_decay": 0.05},
           "lr": [float(tx.lr_fn(i)) for i in range(STEREO_TRAIN_STEPS)],
           "steps": STEREO_TRAIN_STEPS, "setup_s": setup_s, "step_s": [r["s"] for r in recs],
           "s_per_step": statistics.median([r["s"] for r in recs[1:]]), "peak_mem_gib": peak,
           "loss": [r["loss"] for r in recs], "grad_norm": [r["grad_norm"] for r in recs],
           "weights_changed_at_step_2": run["changed_at_step_2"],
           "fullkv_launches_per_step": [r["launches"]["fullkv_attention"] for r in recs],
           "kernel_launches_per_step": [sum(r["launches"].values()) for r in recs],
           "fullkv_gate": supports_fullkv((2 * STEREO_PAIRS, tokens, 16, 64),
                                          (2 * STEREO_PAIRS, tokens, 16, 64)),
           "profiled_step": STEREO_TRAIN_STEPS, "split": run["split"], "profile": run["profile"],
           "cuts": [f"{STEREO_TRAIN_STEPS} steps", f"batch {STEREO_PAIRS} pairs",
                    "seeded random weights and pairs in place of the references' data mix"],
           "nvidia_smi": smi}
    emit(res)
    del model, state, step, batch, run
    torch.cuda.empty_cache()
    if (not all(math.isfinite(x) for x in res["loss"]) or not res["weights_changed_at_step_2"]
            or any(res["kernel_launches_per_step"]) or res["fullkv_gate"]):
        raise AssertionError(f"stereo_train: {res}")
    return res


def wgmma_kernel_resources(log: str) -> list:
    """ptxas's registers and spill bytes for each instance of the kernels in
    WGMMA_FUNCTIONS, read from the `-Xptxas -v` build log."""
    import re

    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            name = m.group(1)
            cur = next(({"function": name} for f in WGMMA_FUNCTIONS if f in name), None)
            if cur is not None and not any(r["function"] == name for r in out):
                out.append(cur)
            elif cur is not None:
                cur = next(r for r in out if r["function"] == name)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return [r for r in out if "registers" in r and "spill_stores" in r]


def merge_sites(*site_maps) -> dict:
    """Per kernel, the union of the input shapes several phases launched."""
    merged = {}
    for sites in site_maps:
        for name, shapes in sites.items():
            for shape, n in shapes.items():
                merged.setdefault(name, {})
                merged[name][shape] = merged[name].get(shape, 0) + n
    return merged


def main() -> int:
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from viewcrafter_tpu_torch.config import get_model_config
        from viewcrafter_tpu_torch.ops import kernels
        from viewcrafter_tpu_torch.ops.kernels import _lib
        from viewcrafter_tpu_torch.sampling.ddim import GuidanceConfig
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 2

    t_all = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    peaks = card_peaks(name)
    max_sm_mhz = float(nvidia_smi("clocks.max.sm", "nounits"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mufu_rate = mufu_exp_per_s(max_sm_mhz)
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "sms": sms, "max_sm_mhz": max_sm_mhz, "mufu_exp_per_s": mufu_rate,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "peak_bf16_tflops": peaks[0] / 1e12, "peak_tb_s": peaks[1] / 1e12})

    t0 = time.perf_counter()
    _lib.lib()
    ptxas = [ln.strip() for ln in _lib.build_log.splitlines()
             if "registers" in ln or ("spill" in ln and " 0 bytes spill stores" not in ln)]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})
    regs = wgmma_kernel_resources(_lib.build_log)
    emit({"phase": "build_wgmma_kernels", "ptxas": regs,
          "wgmma_notes": sorted({ln.strip() for ln in _lib.build_log.splitlines()
                                 if "gmma" in ln.lower()})})
    if len(regs) < 2 * len(WGMMA_FUNCTIONS) or any(r["spill_stores"] or r["spill_loads"] for r in regs):
        raise AssertionError(f"build: ptxas resources of the wgmma kernels {regs}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    wiring_sites = [run_wiring(gen)[1], run_wiring(gen, routes=True)[1],
                    run_wiring(gen, routes=True, frames=LONG_FRAMES)[1],
                    run_wiring(gen, unet_flags=RELPOS_CAUSAL)[1]]

    flagship = get_model_config("viewcrafter_25")
    main_res, main_sites, eng = drive("main", flagship, gen, FLAGSHIP_STEPS, routes=False,
                                      profile_what="one UNet eval, K=2 batched, flagship")
    # the default route: the main path's four kernels and the fused
    # GroupNorm at every GroupNorm, no dual cross-attention
    require_launches("main", main_res, {"fullkv_attention": 15, "fused_temporal_layer": 34,
                                        "fused_ff_layer": 33, "temporal_conv3": 88,
                                        "group_norm_fused": UNET_GROUP_NORMS})
    del eng
    torch.cuda.empty_cache()

    routes_res, routes_sites, eng = drive(
        "routes", flagship, gen, ROUTE_STEPS, routes=True,
        profile_what="one UNet eval, K=2 batched, flagship, both routes on")
    require_launches("routes", routes_res, {
        "fullkv_attention": None, "fused_temporal_layer": 34, "fused_ff_layer": 33,
        "temporal_conv3": 88, "group_norm_fused": UNET_GROUP_NORMS,
        "dual_cross_attention": None})
    emit({"phase": "routes_vs_main", "main_s_per_step": main_res["s_per_step"],
          "routes_s_per_step": routes_res["s_per_step"],
          "main_prepare_decode_s": [main_res["prepare_s"], main_res["decode_s"]],
          "routes_prepare_decode_s": [routes_res["prepare_s"], routes_res["decode_s"]],
          "main_peak_mem_gib": main_res["peak_mem_gib"],
          "routes_peak_mem_gib": routes_res["peak_mem_gib"]})

    # PAB reuse with the K = 2 branches batched (bf16 and f8 cache), then with
    # sequential CFG (one UNet call per branch, each with its own cache)
    pab_sites, pab_batched = [], {}
    for cache_dtype, sequential in (("bf16", False), ("f8", False), ("bf16", True)):
        guidance = GuidanceConfig(sequential=sequential)
        phase = f"pab_{cache_dtype}" + ("_sequential" if sequential else "")
        pab_res, sites, _ = drive(
            phase, flagship, gen, PAB_STEPS, routes=True, eng=eng, guidance=guidance,
            attn_reuse_interval=PAB_INTERVAL, attn_reuse_sites=PAB_SITES,
            attn_reuse_dtype=cache_dtype)
        pab_sites.append(sites)
        if pab_res["step_kinds"] != ["full", "reuse", "reuse"] * (PAB_STEPS // PAB_INTERVAL):
            raise AssertionError(f"{phase}: step kinds {pab_res['step_kinds']}")
        for k in ("group_norm_fused", "dual_cross_attention", "fullkv_attention"):
            if pab_res["launches"][k] == 0:
                raise AssertionError(f"{phase}: {k} never launched")
        line = {"phase": "pab_cache", "dtype": cache_dtype, "sequential_cfg": sequential,
                **cache_bytes(eng, gen, cache_dtype, guidance),
                "s_per_full_step": pab_res["s_per_full_step"],
                "s_per_reuse_step": pab_res["s_per_reuse_step"],
                "peak_mem_gib": pab_res["peak_mem_gib"],
                "routes_s_per_step": routes_res["s_per_step"]}
        if sequential:  # the batched run's numbers beside
            line["batched"] = pab_batched[cache_dtype]
        else:
            pab_batched[cache_dtype] = {k: line[k] for k in (
                "gib", "s_per_full_step", "s_per_reuse_step", "peak_mem_gib")}
        emit(line)
    del eng
    torch.cuda.empty_cache()

    long_cfg = dataclasses.replace(get_model_config("viewcrafter_25_512"), name="long_clip_40",
                                   video_length=LONG_FRAMES)
    long_res, long_sites, eng = drive("long", long_cfg, gen, ROUTE_STEPS, routes=True)
    require_launches("long", long_res, {
        "fullkv_attention": None, "temporal_attention_fused": 34, "fused_ff_layer": 33,
        "temporal_conv3": None, "group_norm_fused": None, "dual_cross_attention": None})
    del eng
    torch.cuda.empty_cache()

    op_res, op_sites = run_spatial_op(gen)

    _, geo_wiring_sites = run_geometry_wiring(gen)
    # the photo-to-video path, then the other modes: their DUSt3R passes
    # launch fullkv at batch sizes of up to 8 images and 8 pairs
    h, w = flagship.height, flagship.width
    clip, clip_source = eval_clip(EVAL_FRAMES, h, w)
    mode_sites, dust3r_passes = [], []
    steps_cut = f"DDIM steps {PIPELINE_STEPS} of 50"
    for phase, mode, images, fullkv, frames, cuts, covered in (
            ("pipeline", "single_view_target", [pipeline_input(0, h, w)], [(24, 48)], 25,
             [steps_cut], slice(1, None)),
            ("sparse_interp", "sparse_view_interp", shifted_views(3, 24, h, w), [(24, 48)], 50,
             [f"{steps_cut} per segment"], slice(1, None)),
            ("iterative", "single_view_nbv", [pipeline_input(0, h, w)],
             [(24, 48), (24, 192)][:NBV_PASSES], 25,
             [f"{steps_cut} per pass", f"{NBV_PASSES} of the mode's 3 passes"], slice(1, None)),
            # the eval render's frame 0 is the cloud at the identity camera,
            # where the two alignments meet (see eval_geometry)
            ("eval", "single_view_eval", clip, [(24, 192), (24, 48)], EVAL_FRAMES,
             [steps_cut, f"{EVAL_FRAMES} frames of the clip ({clip_source})"], slice(0, 1))):
        _, sites_, passes = run_mode(phase, mode, images, fullkv, frames, cuts, covered,
                                     nbv_passes=NBV_PASSES)
        mode_sites.append(sites_)
        dust3r_passes += [(phase, k, geo) for k, geo in passes]

    _, checkpoint_sites = run_checkpoint(gen, smi)

    # training: the small all-kernel config card against CPU (and its
    # deterministic resume), the full-width train phase, every kernel's
    # backward at the sites those launched, then dp x sp on 4 ranks
    torch.cuda.empty_cache()
    _, train_wiring_sites = run_train_wiring()
    train_res, train_sites = run_train(smi)
    # DUSt3R and CroCo training: the small models card against CPU and at
    # dp 2, DUSt3R fine-tuning at full width (fullkv forward and backward at
    # every attention), CroCo pretraining at the published width
    _, pretrain_sites = run_pretrain_wiring()
    dust3r_res, dust3r_train_sites, dust3r_site_steps = run_dust3r_train(smi)
    run_croco_pretrain(smi)
    # CroCo downstream stereo and flow: the small models card against CPU
    # (tiled inference and train steps, fullkv at every attention), tiled
    # inference and training at the released width
    _, stereo_wiring_sites, stereo_wiring_train_sites = run_stereoflow_wiring(gen)
    stereo_res, stereo_sites = run_stereo_tiled(smi)
    run_stereo_train(smi)
    grad_worst, grad_checks = run_kernel_grads(
        gen, [train_sites, train_wiring_sites, pretrain_sites, dust3r_train_sites,
              stereo_wiring_train_sites])
    _, train_sharded_sites = run_train_sharded_wiring()

    # multi-device sampling: ranks spawned from here, each phase after the
    # models before it are freed
    torch.cuda.empty_cache()
    flagship_ref = unsharded_reference("sharded_cfg_dp", flagship, smi)
    sharded_sites = run_sharded("sharded_cfg_dp", flagship, dp=2, world=2, smi=smi, nccl=True,
                                reference=flagship_ref)
    sharded_sites += run_sharded("sharded_sp", get_model_config("viewcrafter_16"), dp=1,
                                 world=2, smi=smi)
    sharded_sites += run_sharded_wiring(gen)
    # tensor parallelism: the flagship's UNet over 2 ranks against its own
    # unsharded reference of TP_STEPS steps, then every kernel on local
    # slices at dp 2 x sp 2 x tp 2
    tp_rank_sites = run_sharded("sharded_tp", flagship, dp=1, world=2, smi=smi, nccl=True, tp=2,
                                steps=TP_STEPS)
    sharded_sites += tp_rank_sites
    sharded_sites += run_sharded_wiring(gen, "sharded_tp_wiring", tp_wiring_config(), world=8,
                                        tp=2, routes=True)

    # every kernel is held against its twin at every shape any driven path
    # launched it with (the wiring runs included); GroupNorm also at one
    # float32 shape (the paths are bf16 throughout). ROW_PATH only says which
    # path's launch count a kernel's row reports.
    sites = merge_sites(*wiring_sites, geo_wiring_sites, *mode_sites, checkpoint_sites,
                        train_wiring_sites, train_sites, *train_sharded_sites, pretrain_sites,
                        dust3r_train_sites, stereo_wiring_sites, stereo_sites,
                        *sharded_sites, *(s["all"] for s in (main_sites, routes_sites, *pab_sites,
                                                             long_sites, op_sites)))
    sites["group_norm_fused"][(2, 9216, 320, 32, 4, 1)] = 0
    sites["fullkv_attention"].setdefault(NBV_PASS3_SITE, 0)
    emit({"phase": "kernel_sites", "count": {k: len(v) for k, v in sites.items()}})
    path_res = {"main": main_res, "routes": routes_res, "long": long_res, "op": op_res}
    path_sites = {"main": main_sites, "routes": routes_sites, "long": long_sites, "op": op_sites}
    path_steps = {"main": FLAGSHIP_STEPS, "routes": ROUTE_STEPS, "long": ROUTE_STEPS, "op": 1}
    results = {}
    for res in kernel_sites(peaks, gen, sites, mufu_rate):
        results.setdefault(res["name"], []).append(res)

    rows = []
    for kname in kernels.KERNEL_MODULES:
        # a row reports the launches of one path (ROW_PATH) and the times of
        # the site that costs that path's sampling steps the most (launches x
        # bound); the per-eval sums cover every site of those steps (the VAE's
        # GroupNorms, in prepare and decode, are in `launches` only)
        path = ROW_PATH[kname]
        on_path = [dict(r, n=path_sites[path]["steps"][kname].get(tuple(r["site"]), 0))
                   for r in results[kname] if not r["variant"]]
        top = max(on_path, key=lambda r: r["n"] * r["bound_ms"])
        per_eval = {key: sum(r["n"] * r[key] for r in on_path) / path_steps[path]
                    for key in ("kernel_ms", "bound_ms")}
        rows.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname], "replaces": REPLACES[kname],
            "path": path, "site": top["site"], "launches": path_res[path]["launches"][kname],
            "max_abs_err": max(r["max_abs_err"] for r in results[kname]),
            "max_err": max(r["max_abs_err"] for r in results[kname]),
            "ms": top["kernel_ms"], "kernel_ms": top["kernel_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "mufu_bound_ms": top.get("mufu_bound_ms"),
            "library_ms": top["library_ms"],
            **{key: top[key] for key in ("gemm_library_ms", "attn_library_ms",
                                         "composed_library_ms") if key in top},
            "ms_per_unet_eval": per_eval["kernel_ms"], "bound_ms_per_unet_eval": per_eval["bound_ms"],
            "backward": backward_row(kname, grad_worst, train_res),
        })
        if rows[-1]["launches"] <= 0:
            raise AssertionError(f"{kname} was never launched on the {path} path")
    # GroupNorm at a large group mean, kernel against twin (float32, bf16)
    next(r for r in rows if r["name"] == "group_norm_fused")["large_mean_sites"] = [
        {k: r[k] for k in ("site", "max_abs_err", "tol", "rms_rel_err", "rms_tol", "kernel_ms")}
        for r in results["group_norm_fused"] if r["variant"] == "large_mean"]
    # fullkv's DUSt3R sites: the launches of each geometry pass beside the times
    fullkv_row = next(r for r in rows if r["name"] == "fullkv_attention")
    fullkv_row["dust3r_sites"] = [
        {"site": r["site"], "launches_per_geometry_pass": [
            [phase, k, geo[tuple(r["site"])]] for phase, k, geo in dust3r_passes
            if tuple(r["site"]) in geo],
         **{k: r[k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                              "mufu_bound_ms")}}
        for r in results["fullkv_attention"]
        if not r["variant"] and any(tuple(r["site"]) in geo for _, _, geo in dust3r_passes)]
    # fullkv's backward at the DUSt3R fine-tuning sites: the launches and
    # twin backward passes of each step, as counted, beside the forward's
    # and the backward's times
    fullkv_row["backward"]["dust3r_train_sites"] = [
        {"site": list(site), "launches_per_step": dust3r_site_steps[site]["launches"],
         "backward_plain_per_step": dust3r_site_steps[site]["backward_plain"],
         "backward_ms": grad_checks["fullkv_attention"][site]["backward_ms"],
         "forward_ms_under_grad": grad_checks["fullkv_attention"][site]["forward_ms"],
         "grads_bit_equal": grad_checks["fullkv_attention"][site]["grads_bit_equal"],
         **{k: r[k] for r in results["fullkv_attention"]
            if not r["variant"] and tuple(r["site"]) == site
            for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}
        for site in dust3r_train_sites["fullkv_attention"]]
    fullkv_row["backward"]["dust3r_train_backward_plain_per_step"] = \
        dust3r_res["fullkv_backward_plain_per_step"]
    fullkv_row["backward"]["dust3r_train_s_per_step"] = dust3r_res["s_per_step"]
    # fullkv at the released CroCo-Stereo's 1152-token sites (crop 384x768),
    # with the launches of one tiled pair there
    fullkv_row["stereo_sites"] = [
        {"site": r["site"], "launches_per_pair": {
            case: n for case, c in stereo_res["cases"].items()
            for k, n in c["fullkv_sites"] if tuple(k) == tuple(r["site"])},
         **{k: r[k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                              "mufu_bound_ms", "max_abs_err", "tol")}}
        for r in results["fullkv_attention"]
        if not r["variant"] and tuple(r["site"]) in stereo_sites.get("fullkv_attention", {})]
    # the main path's kernels at the local heads and widths of `sharded_tp`'s
    # ranks, with the launches of both ranks together
    tp_launches = merge_sites(*tp_rank_sites)
    for row in rows:
        on_tp = tp_launches.get(row["name"], {})
        row["tp_sites"] = [
            {"site": r["site"], "launches_all_ranks": on_tp[tuple(r["site"])],
             **{k: r[k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                  "max_abs_err", "tol")}}
            for r in results[row["name"]] if not r["variant"] and tuple(r["site"]) in on_tp]
    emit({"kernels": rows})
    emit({"phase": "end", "seconds": time.perf_counter() - t_all})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
