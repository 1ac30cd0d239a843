"""Attention over the frame axis for every (batch, pixel, head):
hand-written CUDA kernel + plain twin.

Replaces the TPU kernel
`viewcrafter_tpu/ops/pallas/temporal_attention.py:temporal_attention_fused`.
The model reaches it where the whole-layer kernel's gate fails and this
one's holds: clips of 33 to 64 frames.

Semantics kept from the TPU kernel: f32 logits of the bf16 q and k scaled by
d^-1/2 after the product, softmax normalised in f32 and then rounded to
bf16, P V accumulated in f32, output rounded to bf16.

Kernel (`csrc/temporal_attention.cu`): in (B, T, S*H, D) the T rows of one
problem lie S*H*D elements apart, each one contiguous line of D*2 bytes; one
block of four warps copies the T lines of q, k and v of one problem into
shared memory (rows up to the next multiple of 16 are zeros there: T is not
padded in device memory), each warp takes 16 query rows through Q K^T, the
softmax and P V on the tensor cores (mma.sync m16n8k16) with all T <= 64 keys
in one tile, so no online rescale. The TPU kernel's block-diagonal packing
of several problems into one 128 x 128 product is a matrix-unit rule and is
not carried over: keys are exactly the T real frames.

Bound on an H100 SXM (989 TF/s bf16, 3.35 TB/s) at the long clip's ds1 site
(2, 40, 2560, 5, 64): 4 * 2 * 2560 * 5 * 40 * 40 * 64 = 10.5 GFLOP ~= 0.011 ms
against 0.52 GB of traffic (three reads, one write) ~= 0.16 ms: bound by
bytes.
"""

from __future__ import annotations

import sys

import torch

from viewcrafter_tpu_torch.ops.kernels import _lib

launches = 0  # wrapper calls that launched the CUDA kernel
sites: dict = {}  # (B, T, S, H, D) -> launches at that shape
backward_plain = 0  # backward passes through the plain twin's VJP
backward_sites: dict = {}  # launch site -> backward passes of launches there
MAX_T = 64


def temporal_attention_fused_plain(q, k, v):
    """The kernel's arithmetic in plain torch. q, k, v (B, T, S, H, D)."""
    d = q.shape[-1]
    logits = torch.einsum("bqshd,bkshd->bshqk", q.float(), k.float()) * (d ** -0.5)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bshqk,bkshd->bqshd", probs.float(), v.float()).to(q.dtype)


def temporal_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, T, S, H, D), T <= 64, D in {64, 128}; attention over T for
    each (b, s, h). Returns (B, T, S, H, D) in q's type. A CPU tensor takes
    the plain twin; a CUDA tensor launches the kernel or raises. Under grad
    the backward is the twin's VJP."""
    if not q.is_cuda:
        return temporal_attention_fused_plain(q, k, v)
    spec = _lib.KernelSpec(_launch, temporal_attention_fused_plain, sys.modules[__name__])
    return _lib.launch(spec, q, k, v)


def _launch(q, k, v):
    global launches
    if q.ndim != 5:
        raise ValueError(f"temporal_attention_fused takes (B, T, S, H, D), got {tuple(q.shape)}")
    b, t, s, h, d = q.shape
    bf = torch.bfloat16
    _lib.require(q, "q", bf)
    _lib.require(k, "k", bf, q.shape)
    _lib.require(v, "v", bf, q.shape)
    if d not in (64, 128) or not 1 <= t <= MAX_T:
        raise ValueError(f"temporal_attention_fused supports head dim 64/128 and T <= {MAX_T}, "
                         f"got D={d}, T={t}")
    out = torch.empty_like(q)
    err = _lib.lib().vc_temporal_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, s * h, d, d ** -0.5,
        _lib.stream_ptr())
    _lib.check(err, "temporal_attention_fused")
    launches += 1
    key = (b, t, s, h, d)
    sites[key] = sites.get(key, 0) + 1
    return out


# -- the TPU package's gate, copied so the same sites take the kernel ------


def _pad_t(t: int) -> int:
    return -(-t // 16) * 16


def _pack_group(t: int) -> int:
    return max(1, 128 // _pad_t(t))


def _pick_tile(n: int, t: int = 25, upper: int = 96) -> int:
    g = _pack_group(t)
    for k in (16, 12, 8, 6, 4, 2, 1):
        tile = g * k
        if tile <= upper and n % tile == 0:
            return tile
    for tile in (64, 32, 16, 8):
        if tile <= upper and n % tile == 0:
            return tile
    return 0


def supports_fused(q_shape, mask=None, max_t: int = MAX_T) -> bool:
    """Mirror of `temporal_attention.supports_fused` of the JAX package."""
    _, t, s, h, d = q_shape
    return mask is None and t <= max_t and _pick_tile(s * h, t) > 0 and d in (64, 128)
