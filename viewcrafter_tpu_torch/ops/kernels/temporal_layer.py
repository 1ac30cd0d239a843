"""Temporal self-attention layer (LayerNorm -> QKV -> attention over frames
per (pixel, head) -> out projection): hand-written CUDA kernels + plain twin.

Replaces the TPU kernel
`viewcrafter_tpu/ops/pallas/temporal_layer.py:fused_temporal_layer`.

The model width C and the attention width inner = heads * dim_head are
apart: Wqkv is (3 inner, C) and Wo (C, inner). Unsharded inner == C; a
tensor-parallel rank (`parallel/tp.py`) passes its block of the heads, and
the layer returns its partial of the out projection.

Kernels (`csrc/temporal_layer.cu`), four launches per call:
  1. the LayerNorm, f32 statistics, normalised rows stored in bf16;
  2. the QKV product on the Hopper GEMM core (`csrc/gemm_sm90.cuh`: TMA,
     mbarrier ring, wgmma, persistent); Q|K|V (N, 3 inner) stored in bf16
     (the TPU kernel rounds them to bf16 too);
  3. the frame attention on the tensor cores: Q|K|V mapped for TMA as
     (3 inner, T, S, B), frames inside pixels, so one box of 64 columns, 32 frames
     and 4 pixels lands as one 32-row block per pixel (frames past T
     zero-filled); one warp per pixel: f32 logits of Q K^T (mma.sync
     m16n8k16) scaled by d^-1/2, f32 softmax over the T real keys (the TPU
     kernel padded T to 16 and masked the padded keys), probabilities
     normalised and then rounded to bf16, f32 P V, bf16 out, written back by
     one TMA store that skips the padded frames;
  4. the out-projection product on the GEMM core + bias (bias added in bf16,
     as the TPU kernel).
The normalised x, Q|K|V and the attention output cross device memory: 12 C
elements per row in all (x in; xn, Q|K|V and att each out and in; out),
3.54 GB at the ds1 site below, ~1.06 ms at 3.35 TB/s, above the function's
own bound. Keeping Q|K|V on chip (the attention inside the QKV product's
epilogue) was built and timed on the card and was no faster over a UNet
eval (PERF.md).

Bound on an H100 SXM (989 TF/s bf16, 3.35 TB/s) at the flagship ds1 site
(2, 25, 9216, 320), 5 heads of 64: 2*N*C*3C + 2*N*C*C + 4*B*S*H*T*T*D
= 392 GFLOP ~= 0.40 ms against 0.59 GB of input/output traffic: bound by
operations.
"""

from __future__ import annotations

import sys
from functools import partial

import torch

from viewcrafter_tpu_torch.ops.kernels import _lib
from viewcrafter_tpu_torch.ops.kernels.ff_layer import _layer_norm

launches = 0  # wrapper calls that launched the CUDA kernels
sites: dict = {}  # (B, T, S, C, heads, dim_head) -> launches at that shape
backward_plain = 0  # backward passes through the plain twin's VJP
backward_sites: dict = {}  # launch site -> backward passes of launches there


def fused_temporal_layer_plain(x, ln_w, ln_b, wqkv, wo, bo, *, heads: int,
                               dim_head: int, eps: float = 1e-5):
    """The kernels' arithmetic in plain torch. x (B, T, S, C); wqkv
    (3 inner, C) = cat(to_q, to_k, to_v weights), inner = heads*dim_head;
    wo (C, inner); bo (C,)."""
    b, t, s, _ = x.shape
    dt, inner = x.dtype, heads * dim_head
    xn = _layer_norm(x, ln_w, ln_b, eps)
    y = (xn.float() @ wqkv.to(dt).float().t()).to(dt)
    q, k, v = (y[..., i * inner:(i + 1) * inner].reshape(b, t, s, heads, dim_head)
               for i in range(3))
    logits = torch.einsum("bqshd,bkshd->bshqk", q.float(), k.float()) * (dim_head ** -0.5)
    probs = torch.softmax(logits, dim=-1).to(dt)
    o = torch.einsum("bshqk,bkshd->bqshd", probs.float(), v.float()).to(dt)
    return (o.reshape(b, t, s, inner).float() @ wo.to(dt).float().t()).to(dt) + bo.to(dt)


def fused_temporal_layer(x, ln_w, ln_b, wqkv, wo, bo, *, heads: int, dim_head: int,
                         eps: float = 1e-5):
    """x: (B, T, S, C), C a multiple of 8. Returns LayerNorm ->
    self-attention over T per (b, s) of `heads` heads of `dim_head` -> out
    projection, shaped like x (the caller adds the residual). Weights in
    nn.Linear layout, inner = heads*dim_head: wqkv (3 inner, C), wo
    (C, inner), bo (C,). A CPU tensor takes the plain twin; a CUDA tensor
    launches the kernels or raises. Under grad the backward is the twin's
    VJP for x and every weight."""
    kw = dict(heads=heads, dim_head=dim_head, eps=eps)
    if not x.is_cuda:
        return fused_temporal_layer_plain(x, ln_w, ln_b, wqkv, wo, bo, **kw)
    spec = _lib.KernelSpec(partial(_launch, **kw), partial(fused_temporal_layer_plain, **kw),
                           sys.modules[__name__])
    return _lib.launch(spec, x, ln_w, ln_b, wqkv, wo, bo)


def _launch(x, ln_w, ln_b, wqkv, wo, bo, *, heads: int, dim_head: int, eps: float):
    global launches
    b, t, s, c = x.shape
    inner = heads * dim_head
    if c % 8 or heads < 1:
        raise ValueError(f"fused_temporal_layer needs C divisible by 8 and a head, got C={c}, "
                         f"{heads} heads")
    if dim_head not in (64, 128) or t > 32:
        raise ValueError(f"fused_temporal_layer supports dim_head 64/128 and T<=32, got {dim_head}, {t}")
    bf = torch.bfloat16
    _lib.require(x, "x", bf)
    ln_w, ln_b = ln_w.float().contiguous(), ln_b.float().contiguous()
    wqkv, wo, bo = wqkv.to(bf).contiguous(), wo.to(bf).contiguous(), bo.to(bf).contiguous()
    _lib.require(ln_w, "ln_w", torch.float32, (c,))
    _lib.require(ln_b, "ln_b", torch.float32, (c,))
    _lib.require(wqkv, "wqkv", bf, (3 * inner, c))
    _lib.require(wo, "wo", bf, (c, inner))
    _lib.require(bo, "bo", bf, (c,))
    n = b * t * s
    xn = torch.empty((n, c), dtype=bf, device=x.device)
    qkv = torch.empty((n, 3 * inner), dtype=bf, device=x.device)
    att = torch.empty((n, inner), dtype=bf, device=x.device)
    out = torch.empty_like(x)
    err = _lib.lib().vc_temporal_layer(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wqkv.data_ptr(), wo.data_ptr(),
        bo.data_ptr(), xn.data_ptr(), qkv.data_ptr(), att.data_ptr(), out.data_ptr(),
        b, t, s, c, heads, dim_head, eps, dim_head ** -0.5, _lib.stream_ptr())
    _lib.check(err, "fused_temporal_layer")
    launches += 1
    key = (b, t, s, c, heads, dim_head)
    sites[key] = sites.get(key, 0) + 1
    return out


# -- the TPU package's gate, copied so the same sites take the kernel ------


def _pad_t(t: int) -> int:
    return -(-t // 16) * 16


def _pick_tile(s: int, t: int, c: int, inner: int, budget: int = 80 * 1024 * 1024,
               itemsize: int = 2) -> int:
    """The JAX package's VMEM rule with the attention width `inner` apart
    from C (the same numbers at inner == C)."""
    es = itemsize
    t_pad = _pad_t(t)
    w_bytes = (3 * inner * c + c * inner) * es
    for tile in (512, 384, 256, 192, 128, 96, 64, 48, 32, 16, 8):
        if s % tile:
            continue
        blocks = 2 * 2 * (t * tile * c * es)
        inter = tile * t_pad * (c * 2 * es + 3 * inner * es + inner * es + c * es)
        logits = tile * t_pad * t_pad * 4 * 2
        if blocks + inter + logits + w_bytes <= budget:
            return tile
    return 0


def supports_fused_layer(x_shape, heads: int, dim_head: int,
                         max_t: int = 32, itemsize: int = 2) -> bool:
    """Mirror of `temporal_layer.supports_fused_layer` of the JAX package,
    which asks for C == heads*dim_head; here a tensor-parallel rank asks at
    its local shape (its block of the heads, inner < C), so the width test
    is the kernel's own (C a multiple of 8, a head at least)."""
    if len(x_shape) != 4:
        return False
    b, t, s, c = x_shape
    return (heads >= 1 and c % 8 == 0 and t <= max_t and dim_head in (64, 128)
            and _pick_tile(s, t, c, heads * dim_head, itemsize=itemsize) > 0)
