"""Non-causal, unmasked softmax attention: hand-written CUDA kernel + plain twin.

Replaces the TPU kernel
`viewcrafter_tpu/ops/pallas/fullkv_attention.py:fullkv_attention`.

Semantics kept from the TPU kernel: d^-1/2 * log2(e) is folded into q, which
is rounded back to the activation type (`fullkv_attention.py:196-198`); the
softmax runs in base 2 on f32 logits; probabilities go to bf16 for the PV
product; the division by the row sum comes after PV.

Kernel (`csrc/fullkv_attention.cu`), FlashAttention-3 style for Hopper: one
block of three warpgroups per (b, h, 128-row query tile). A producer
warpgroup loads the query tile and a ring of 128-key K/V tiles by TMA
(mbarriers: full and empty per stage); two consumer warpgroups of 64 rows
each run S = Q K^T and O += P V on wgmma (P the register A operand, V read
transposed from shared memory) and the online base-2 softmax in registers,
the softmax of tile t under the P V product of tile t - 1, and take turns
(ping-pong) to issue their products. Any Sk is handled: keys past the end
read as zeros (TMA) and are masked (the TPU kernel's chunked variant dropped
trailing keys when Sk % n_chunks != 0).

Bound on an H100 SXM (989 TF/s bf16, 3.35 TB/s) at the flagship ds1 site
(50, 9216, 5, 64): 4 * 50 * 5 * 9216^2 * 64 = 5.4 TFLOP ~= 5.5 ms against
0.24 GB of traffic: bound by operations. The 2.1e10 exponentials take ~5.7 ms
of the MUFU (16 per SM per clock), so the softmax must run under the
products. The design keeps the (Sq, Sk) logits out of device memory entirely
and reads K/V once per query tile.
"""

from __future__ import annotations

import math
import sys

import torch

from viewcrafter_tpu_torch.ops.kernels import _lib

launches = 0  # wrapper calls that launched the CUDA kernel
sites: dict = {}  # (B, Sq, Sk, H, D) -> launches at that shape
backward_plain = 0  # backward passes through the plain twin's VJP
backward_sites: dict = {}  # launch site -> backward passes of launches there
PLAIN_LOGIT_BYTES = 1 << 31  # the plain twin's f32 logits per batch chunk


def _q_scale(d: int) -> float:
    return d ** -0.5 * math.log2(math.e)


def fullkv_attention_plain(q, k, v, q_scale=None):
    """The kernel's arithmetic in plain torch, batch-chunked so that the f32
    logits of one chunk stay under PLAIN_LOGIT_BYTES. q/k/v (B, S, H, D).
    q_scale: the factor folded into q, d^-1/2 * log2(e) unless given (the
    fused spatial layer rounds it to the activation type first)."""
    b, s, h, d = q.shape
    sk = k.shape[1]
    qs = (q.float() * (_q_scale(d) if q_scale is None else q_scale)).to(q.dtype)
    chunk = plain_chunk(q.shape, sk)
    outs = []
    for i in range(0, b, chunk):
        logits = torch.einsum("bqhd,bkhd->bhqk", qs[i:i + chunk].float(), k[i:i + chunk].float())
        e = torch.exp2(logits - logits.amax(-1, keepdim=True))
        ssum = e.sum(-1, keepdim=True)
        out = torch.einsum("bhqk,bkhd->bhqd", e.to(q.dtype).float(), v[i:i + chunk].float())
        outs.append((out / ssum).to(q.dtype).transpose(1, 2))
    return torch.cat(outs, dim=0)


def plain_chunk(q_shape, sk: int) -> int:
    """Batch rows per chunk of the plain twin (and of its VJP)."""
    _, s, h, _ = q_shape
    return max(1, PLAIN_LOGIT_BYTES // (h * s * sk * 4))


def fullkv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, H, D), D in {64, 128}. Returns
    softmax(q k^T / sqrt(D)) v as (B, Sq, H, D). A CPU tensor takes the plain
    twin; a CUDA tensor launches the kernel or raises. Under grad the
    backward is the twin's VJP, one batch chunk of the twin at a time
    (`_lib.KernelFunction`)."""
    if not q.is_cuda:
        return fullkv_attention_plain(q, k, v)
    spec = _lib.KernelSpec(_launch, fullkv_attention_plain, sys.modules[__name__],
                           plain_chunk(q.shape, k.shape[1]))
    return _lib.launch(spec, q, k, v)


def _launch(q, k, v):
    global launches
    b, s, h, d = q.shape
    sk = k.shape[1]
    _lib.require(q, "q", torch.bfloat16)
    _lib.require(k, "k", torch.bfloat16, (b, sk, h, d))
    _lib.require(v, "v", torch.bfloat16, (b, sk, h, d))
    if d not in (64, 128):
        raise ValueError(f"fullkv_attention supports head dim 64 or 128, got {d}")
    if sk < 1:
        raise ValueError("fullkv_attention needs at least one key")
    out = torch.empty_like(q)
    err = _lib.lib().vc_fullkv_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, sk, h, d, _q_scale(d), _lib.stream_ptr())
    _lib.check(err, "fullkv_attention")
    launches += 1
    key = (b, s, sk, h, d)
    sites[key] = sites.get(key, 0) + 1
    return out


# -- the TPU package's gate, copied so the same sites take the kernel ------


def _pick_block_q(s: int, sk: int) -> int:
    budget = 6 * 1024 * 1024
    if s == 9216 and sk == 9216:
        return 384
    cands = (1024, 768, 512, 384, 256, 192, 128)
    if s <= 1024 and s % 16 == 0:
        cands = (s,) + cands
    for cand in cands:
        if s % cand == 0 and cand * sk * 4 <= budget:
            return cand
    return 0


def supports_fullkv(q_shape, k_shape) -> bool:
    """Mirror of `fullkv_attention.supports_fullkv` of the JAX package."""
    _, s, _, d = q_shape
    sk = k_shape[1]
    return (
        d in (64, 128)
        and sk % 64 == 0
        and sk * d * 2 <= (3 << 20) // 2
        and _pick_block_q(s, sk) > 0
    )
