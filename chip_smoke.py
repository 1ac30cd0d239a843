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
           the CPU; three times: default routes, both opt-in routes on, and
           routes on at 40 frames (where the temporal attentions leave the layer kernel for
           `temporal_attention_fused`)
  main     `VideoDiffusionEngine.generate` on the flagship `viewcrafter_25`
           (576x1024x25, B=1, K=2 CFG, 3 DDIM steps, seeded random weights),
           default routes: stage times, peak memory, output checks, launches
           per UNet eval, and a torch.profiler breakdown of one more UNet
           eval by kernel
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
           three flagship shapes
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
           single_view_nbv from the seeded photo: 3 passes of 2, 6 and 10
           images (2, 30 and 90 pairs, the decoder in chunks of 8 pairs);
           per pass the chosen candidate and fullkv's 24/48, 24/192 and
           48/576 launches (encoder/decoder)
  eval     single_view_eval on the first 6 frames of test/eval1 (6 seeded
           numpy views without PIL): 30 pairs, then frame 0 duplicated
           (fullkv 24/192, then 24/48). Its render must cover pixels in
           frame 0, the identity camera where its two alignments meet; an
           "eval_geometry" line says what the render sees from each camera
           (`eval_geometry`)
  kernels  each kernel against its plain torch twin at every input shape any
           phase above launched it with (all eight kernels, all paths, the
           wiring runs included), the two attention kernels once more near
           one-hot (q scaled by 8) and the temporal layer once more near
           one-hot (Wqkv scaled by 4): max_abs_err and rms_rel_err beside
           their tolerances, kernel_ms (CUDA events, median of 10 after
           warm-up), plain_ms, library_ms (one PyTorch call computing the same
           function, or null), bound_ms (the DUSt3R sites of fullkv, up to
           batch 8, with SDPA as library_ms, like every fullkv site); for the
           two attention kernels also
           mufu_bound_ms, their exponentials over the card's MUFU rate (16
           per SM per clock at the card's maximum SM clock); for the FF,
           temporal and spatial layers also gemm_library_ms, their two
           products as F.linear calls (cuBLAS), and for the temporal layer
           attn_library_ms, F.scaled_dot_product_attention over the frames of
           permuted (B, S, H, T, D) views: yardsticks for the layer's parts,
           not library calls for the whole function (library_ms stays null)
Every phase that drives a path sets the launch counts to 0 just before it and
reads them just after.
Then one {"kernels": [...]} line (the fullkv row also lists its DUSt3R sites
under "dust3r_sites", with the launches of each geometry pass that ran them),
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
EVAL_FRAMES = 6  # frames of the eval phase's clip (test/eval1 has 25)
SPATIAL_OP_SHAPES = ((50, 9216, 5, 64), (50, 2304, 10, 64), (50, 576, 20, 64))  # (B, S, heads, D)
# the near one-hot sites of the attention kernels (main-path ds2 sites, the
# routes path's ds1 site)
PEAKY_SITES = {"fullkv_attention": (50, 2304, 2304, 10, 64),
               "dual_cross_attention": (50, 9216, 5, 64, 77, 256),
               "fused_temporal_layer": (2, 25, 2304, 10, 64)}
# the kernels built around wgmma and TMA: their ptxas registers and spills
# get a line of their own, and a spill fails the build phase
WGMMA_FUNCTIONS = ("fullkv_kernel", "dual_cross_kernel", "gemm_sm90_kernel",
                   "frame_attention_kernel")
MAIN_KERNELS = ("temporal_conv3", "fused_ff_layer", "fullkv_attention", "fused_temporal_layer")
# the path whose launch count a kernel's row reports
ROW_PATH = {**{k: "main" for k in MAIN_KERNELS}, "group_norm_fused": "routes",
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


def bound(flops: float, nbytes: float, peaks) -> dict:
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "gbytes": nbytes / 1e9}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --------------------------------------------------------------------------
# kernel phases
# --------------------------------------------------------------------------


def kernel_sites(peaks, gen, sites, mufu_rate):
    """Yield one result dict per (kernel, input shape) of `sites`, the shapes
    the path phases launched each kernel with (`kernels.launch_sites()`)."""
    import torch
    import torch.nn.functional as F

    from viewcrafter_tpu_torch.ops.kernels import (
        cross_attention, ff_layer, fullkv_attention, groupnorm, spatial_layer,
        temporal_attention, temporal_conv, temporal_layer)

    dev, bf = "cuda", torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def check(name, site, got, ref, kernel, plain, library, flops, nb, plain_reps=3,
              max_rel=4 * 2.0 ** -8, rms_tol=2.0 ** -7, variant=None, exps=None, extra=None):
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
               "path_launches": 0 if variant else sites[name][site], "max_abs_err": err, "tol": tol,
               "rms_rel_err": rms_rel, "rms_tol": rms_tol, "kernel_ms": time_ms(kernel),
               "plain_ms": time_ms(plain, reps=plain_reps, warmup=1),
               "library_ms": time_ms(library) if library is not None else None,
               **bound(flops, nb, peaks)}
        if exps is not None:
            res["mufu_bound_ms"] = exps / mufu_rate * 1e3
        for key, fn in (extra or {}).items():
            res[key] = time_ms(fn)
        emit(res)
        if not (err <= tol and rms_rel <= rms_tol):  # also catches NaN
            raise AssertionError(f"{name} at {site}: max_abs_err {err} (tol {tol}), "
                                 f"rms_rel_err {rms_rel} (tol {rms_tol})")
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
    for site, w_mul in ([(s, None) for s in sites["fused_temporal_layer"]]
                        + [(PEAKY_SITES["fused_temporal_layer"], 4.0)]):
        b, t, s, h, d = site
        c = h * d
        x = randn(b, t, s, c)
        lw, lb = 1 + randn(c, scale=0.1, dtype=torch.float32), randn(c, scale=0.1, dtype=torch.float32)
        wqkv = randn(3 * c, c, scale=(w_mul or 1.0) * c ** -0.5)
        wo, bo = randn(c, c, scale=c ** -0.5), randn(c, scale=0.1)
        kw = dict(heads=h, dim_head=d)
        args = (x, lw, lb, wqkv, wo, bo)
        y = temporal_layer.fused_temporal_layer(*args, **kw)
        ref = temporal_layer.fused_temporal_layer_plain(*args, **kw)
        n = b * t * s
        # yardsticks on operands of the parts' shapes: the two products
        # through cuBLAS, the frame attention through SDPA on permuted views
        xn, att = randn(n, c), randn(n, c)
        q5, k5, v5 = (randn(b, t, s, h, d).permute(0, 2, 3, 1, 4) for _ in range(3))
        yield check("fused_temporal_layer", site, y, ref,
                    lambda: temporal_layer.fused_temporal_layer(*args, **kw),
                    lambda: temporal_layer.fused_temporal_layer_plain(*args, **kw), None,
                    2.0 * n * c * 3 * c + 4.0 * b * s * h * t * t * d + 2.0 * n * c * c,
                    nbytes(*args, y), variant=w_mul and f"peaky_wqkv{w_mul:g}",
                    extra={"gemm_library_ms": lambda: (F.linear(xn, wqkv), F.linear(att, wo)),
                           "attn_library_ms": lambda: F.scaled_dot_product_attention(q5, k5, v5)})
        del x, wqkv, wo, y, ref, args, xn, att, q5, k5, v5
    torch.cuda.empty_cache()

    for site in sites["group_norm_fused"]:
        n, s, c, itemsize, silu = site
        dtype = bf if itemsize == 2 else torch.float32
        x = randn(n, s, c, scale=1.5, dtype=dtype) + 0.3
        w = 1 + randn(c, scale=0.1, dtype=torch.float32)
        b = randn(c, scale=0.1, dtype=torch.float32)
        args = (x, w, b, 32, 1e-5, bool(silu))
        y = groupnorm.group_norm_fused(*args)
        ref = groupnorm.group_norm_fused_plain(*args)
        xcf, wl, bl = x.permute(0, 2, 1), w.to(dtype), b.to(dtype)  # channels-first view

        def library(xcf=xcf, wl=wl, bl=bl, silu=silu):
            out = F.group_norm(xcf, 32, wl, bl, 1e-5)
            return F.silu(out) if silu else out
        # float32 input rounds nowhere: kernel and twin differ by the order of
        # their f32 sums and the kernel's fast exp in the SiLU
        tols = {} if itemsize == 2 else {"max_rel": 2.0 ** -14, "rms_tol": 2.0 ** -16}
        yield check("group_norm_fused", site, y, ref,
                    lambda: groupnorm.group_norm_fused(*args),
                    lambda: groupnorm.group_norm_fused_plain(*args), library,
                    8.0 * n * s * c, nbytes(x, w, b, y), **tols)
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

    for site in sites["fused_spatial_layer"]:
        b, s, h, d = site
        c = h * d
        x = randn(b, s, c, scale=0.5)
        lw, lb = 1 + randn(c, scale=0.1, dtype=torch.float32), randn(c, scale=0.1, dtype=torch.float32)
        wqkv, wo, bo = randn(3 * c, c, scale=c ** -0.5), randn(c, c, scale=c ** -0.5), randn(c, scale=0.1)
        kw = dict(heads=h, dim_head=d)
        args = (x, lw, lb, wqkv, wo, bo)
        y = spatial_layer.fused_spatial_layer(*args, **kw)
        ref = spatial_layer.fused_spatial_layer_plain(*args, **kw)
        n = b * s
        xn, att = randn(n, c), randn(n, c)  # the two products alone through cuBLAS
        yield check("fused_spatial_layer", site, y, ref,
                    lambda: spatial_layer.fused_spatial_layer(*args, **kw),
                    lambda: spatial_layer.fused_spatial_layer_plain(*args, **kw), None,
                    2.0 * n * c * 3 * c + 4.0 * b * h * s * s * d + 2.0 * n * c * c,
                    nbytes(*args, y), plain_reps=2,
                    extra={"gemm_library_ms": lambda: (F.linear(xn, wqkv), F.linear(att, wo))})
        del x, wqkv, wo, y, ref, args, xn, att
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# wiring and main path
# --------------------------------------------------------------------------


def wiring_config(frames: int = 8):
    """A small ModelConfig whose UNet passes every kernel gate: head dim 64,
    two levels, a 16x16 latent (S = 256 and 64) and `frames` frames (8: the
    layer kernel's gate; 33 to 64: `temporal_attention_fused`'s)."""
    from viewcrafter_tpu_torch.config import (
        CLIPTextConfig, CLIPVisionConfig, DiffusionConfig, ModelConfig, ResamplerConfig,
        UNetConfig, VAEConfig)

    return ModelConfig(
        name="wiring",
        diffusion=DiffusionConfig(latent_size=(16, 16)),
        unet=UNetConfig(model_channels=64, num_res_blocks=1, attention_resolutions=(1, 2),
                        channel_mult=(1, 2), num_head_channels=64, context_dim=64,
                        temporal_length=frames),
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


def run_wiring(gen, routes: bool = False, frames: int = 8, guidance=None, **staged) -> tuple:
    """`generate_staged` (without `staged` arguments such as attention reuse,
    the same as `generate`) with every kernel on the card against the plain
    path on the CPU: same weights, same
    noise, same routes, same `guidance` (default K = 2 batched). The
    yardstick for the tolerance is the CPU run's own bf16 distance from its
    float32 run. Returns (result, launch sites)."""
    import torch

    from viewcrafter_tpu_torch.models.lvdm import SUBMODELS, VideoDiffusionEngine
    from viewcrafter_tpu_torch.ops import kernels
    from viewcrafter_tpu_torch.sampling.ddim import GuidanceConfig

    cfg = wiring_config(frames)
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
    res = {"phase": "wiring", "routes": routes, "frames": frames, "shape": list(out.shape),
           "sequential_cfg": kw["guidance"].sequential, "staged": staged,
           "max_abs_err_vs_cpu_f32": err,
           "mean_abs_err_vs_cpu_f32": mean_err, "cpu_bf16_vs_f32": yard,
           "cpu_bf16_vs_f32_mean": yard_mean, "tol": tol, "mean_tol": mean_tol,
           "max_abs_err_vs_cpu_bf16": (out - o16).abs().max().item(),
           "output_abs_mean": o32.abs().mean().item(), "launches": counts}
    sites = kernels.launch_sites()
    emit(res)
    if not (err <= tol and mean_err <= mean_tol):
        raise AssertionError(f"wiring: card vs CPU f32 max {err} (tol {tol}), "
                             f"mean {mean_err} (tol {mean_tol})")
    # the kernels this configuration must reach: the four of the default
    # route (the layer kernel only up to 32 frames), the two route kernels
    # when asked for, the temporal attention kernel past 32 frames
    expect = set(MAIN_KERNELS) - ({"fused_temporal_layer"} if frames > 32 else set())
    if routes:
        expect |= {"group_norm_fused", "dual_cross_attention"}
    if frames > 32:
        expect.add("temporal_attention_fused")
    wrong = [k for k, v in counts.items() if (v > 0) != (k in expect)]
    if wrong:
        raise AssertionError(f"wiring: launches {counts} do not match the expected set "
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
    kernels, cats = {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
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
    return {"phase": "profile", "what": what, "wall_ms": wall_ms,
            "device_ms": device_ms, "idle_share": max(0.0, 1 - device_ms / wall_ms),
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
    res = {"phase": "op", "op": "fused_spatial_layer", "outputs": outs, "launches": counts}
    emit(res)
    if counts["fused_spatial_layer"] != len(SPATIAL_OP_SHAPES) or not all(
            o["finite"] and o["abs_mean"] > 0 for o in outs):
        raise AssertionError(f"op: {res}")
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
        got, o32, o16 = out[key].float().cpu(), cpu[0][key], cpu[1][key]
        scale = o32.abs().max().item()
        err, yard = (got - o32).abs().max().item() / scale, (o16 - o32).abs().max().item() / scale
        tol = 2 * yard + 1e-2
        res["outputs"][key] = {"rel_err_vs_cpu_f32": err, "cpu_bf16_vs_f32": yard, "tol": tol,
                               "finite": bool(torch.isfinite(got).all())}
        ok &= err <= tol and res["outputs"][key]["finite"]
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
             cuts: list, covered: slice, **opt_kw) -> tuple:
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
    a line says what its render sees (`eval_geometry`). Returns (result,
    launch sites, [(pass, DUSt3R fullkv sites)])."""
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
        pipe = ViewCrafterPipeline(opts, on_stage=on_stage)  # device=None: the card
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
                                  "fused_ff_layer": 33, "temporal_conv3": 88})
    del pipe
    torch.cuda.empty_cache()
    return res, sites, pass_sites


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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    peaks = card_peaks(name)
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mufu_rate = 16.0 * sms * max_sm_mhz * 1e6  # exponentials per second
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
                    run_wiring(gen, routes=True, frames=LONG_FRAMES)[1]]

    flagship = get_model_config("viewcrafter_25")
    main_res, main_sites, eng = drive("main", flagship, gen, FLAGSHIP_STEPS, routes=False,
                                      profile_what="one UNet eval, K=2 batched, flagship")
    # the default route launches what it launched before the opt-in routes
    # existed, and none of their kernels
    require_launches("main", main_res, {"fullkv_attention": 15, "fused_temporal_layer": 34,
                                        "fused_ff_layer": 33, "temporal_conv3": 88})
    del eng
    torch.cuda.empty_cache()

    routes_res, routes_sites, eng = drive(
        "routes", flagship, gen, ROUTE_STEPS, routes=True,
        profile_what="one UNet eval, K=2 batched, flagship, both routes on")
    require_launches("routes", routes_res, {
        "fullkv_attention": None, "fused_temporal_layer": 34, "fused_ff_layer": 33,
        "temporal_conv3": 88, "group_norm_fused": None, "dual_cross_attention": None})
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
             [(24, 48), (24, 192), (48, 576)], 25, [f"{steps_cut} per pass"], slice(1, None)),
            # the eval render's frame 0 is the cloud at the identity camera,
            # where the two alignments meet (see eval_geometry)
            ("eval", "single_view_eval", clip, [(24, 192), (24, 48)], EVAL_FRAMES,
             [steps_cut, f"{EVAL_FRAMES} frames of the clip ({clip_source})"], slice(0, 1))):
        _, sites_, passes = run_mode(phase, mode, images, fullkv, frames, cuts, covered)
        mode_sites.append(sites_)
        dust3r_passes += [(phase, k, geo) for k, geo in passes]

    # every kernel is held against its twin at every shape any driven path
    # launched it with (the wiring runs included); GroupNorm also at one
    # float32 shape (the paths are bf16 throughout). ROW_PATH only says which
    # path's launch count a kernel's row reports.
    sites = merge_sites(*wiring_sites, geo_wiring_sites, *mode_sites, *(
        s["all"] for s in (main_sites, routes_sites, *pab_sites, long_sites, op_sites)))
    sites["group_norm_fused"][(2, 9216, 320, 4, 1)] = 0
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
            **{key: top[key] for key in ("gemm_library_ms", "attn_library_ms") if key in top},
            "ms_per_unet_eval": per_eval["kernel_ms"], "bound_ms_per_unet_eval": per_eval["bound_ms"],
        })
        if rows[-1]["launches"] <= 0:
            raise AssertionError(f"{kname} was never launched on the {path} path")
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
    emit({"kernels": rows})
    emit({"phase": "end", "seconds": time.perf_counter() - t_all})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
