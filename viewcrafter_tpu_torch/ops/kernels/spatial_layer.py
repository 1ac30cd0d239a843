"""Spatial self-attention layer (LayerNorm -> QKV -> full attention over the
tokens of each batch row -> out projection, no residual): hand-written CUDA
kernels + plain twin.

Replaces the TPU kernel
`viewcrafter_tpu/ops/pallas/spatial_layer.py:fused_spatial_layer`. As in the
JAX package, no model calls it: it is a stand-alone op (the branch comes back
without the residual so that an attention-reuse cache could hold it).

Semantics kept from the TPU kernel: two-pass f32 LayerNorm rounded to the
activation type; Q|K|V rounded to the activation type; q multiplied by
d^-1/2 * log2(e) *in the activation type* (the factor itself is rounded to
bf16 first, then the product); base-2 softmax on f32 logits; the
unnormalised exponentials rounded to bf16 for P V; 1/rowsum applied to the
f32 (rows, D) result; heads concatenated in bf16; out projection with the
bias (rounded to bf16) added in f32 before the one output rounding.

Kernels (`csrc/spatial_layer.cu`), staged in four launches: the TPU kernel
holds a row's whole (S, 3C) Q|K|V on chip, 17.7 MB at the flagship; an SM
has 227 KB. So: the LayerNorm; the QKV GEMM into one (B*S, 3C) buffer that
crosses device memory once; the flash-style attention kernel of
`csrc/fullkv_attention.cu`, which takes row strides and reads q, k, v as
column blocks of that buffer (its online softmax rounds P against the
running maximum, the twin against the final one); the out-projection GEMM.
The two products run on the Hopper GEMM core `csrc/gemm_sm90.cuh` (TMA,
mbarrier ring, wgmma, persistent).

Bound on an H100 SXM (989 TF/s bf16, 3.35 TB/s) at (50, 9216, 320), 5 heads
of 64: 2*N*C*3C + 4*B*H*S*S*D + 2*N*C*C = 5.81 TFLOP ~= 5.9 ms against
0.59 GB of input/output traffic: bound by operations.
"""

from __future__ import annotations

import math

import torch

from viewcrafter_tpu_torch.ops.kernels import _lib
from viewcrafter_tpu_torch.ops.kernels.ff_layer import _layer_norm
from viewcrafter_tpu_torch.ops.kernels.fullkv_attention import fullkv_attention_plain

launches = 0  # wrapper calls that launched the CUDA kernels
sites: dict = {}  # (B, S, heads, dim_head) -> launches at that shape


def _q_scale(dim_head: int, dtype: torch.dtype) -> float:
    """d^-1/2 * log2(e), rounded to the activation type as the TPU kernel's
    `jnp.asarray(scale, dtype=...)` does."""
    return torch.tensor(dim_head ** -0.5 * math.log2(math.e)).to(dtype).item()


def fused_spatial_layer_plain(x, ln_w, ln_b, wqkv, wo, bo, *, heads: int, dim_head: int,
                              eps: float = 1e-5):
    """The kernels' arithmetic in plain torch. x (B, S, C); wqkv (3C, C) =
    cat(to_q, to_k, to_v weights); wo (C, C); bo (C,)."""
    b, s, c = x.shape
    dt = x.dtype
    xn = _layer_norm(x, ln_w, ln_b, eps)
    y = (xn.float() @ wqkv.to(dt).float().t()).to(dt)
    q, k, v = (y[..., i * c:(i + 1) * c].reshape(b, s, heads, dim_head) for i in range(3))
    att = fullkv_attention_plain(q, k, v, q_scale=_q_scale(dim_head, dt)).reshape(b, s, c)
    return (att.float() @ wo.to(dt).float().t() + bo.to(dt).float()).to(dt)


def fused_spatial_layer(x, ln_w, ln_b, wqkv, wo, bo, *, heads: int, dim_head: int,
                        eps: float = 1e-5):
    """x: (B, S, C) with C == heads*dim_head. Returns LayerNorm ->
    self-attention over S per batch row -> out projection, shaped like x (the
    caller adds the residual). Weights in nn.Linear layout: wqkv (3C, C),
    wo (C, C), bo (C,). A CPU tensor takes the plain twin; a CUDA tensor
    launches the kernels or raises. It has no backward (no model calls it):
    on a CUDA input that requires grad under grad mode it raises."""
    global launches
    if not x.is_cuda:
        return fused_spatial_layer_plain(x, ln_w, ln_b, wqkv, wo, bo, heads=heads,
                                         dim_head=dim_head, eps=eps)
    if x.ndim != 3:
        raise ValueError(f"fused_spatial_layer takes (B, S, C), got {tuple(x.shape)}")
    b, s, c = x.shape
    if c != heads * dim_head:
        raise ValueError(f"C={c} must equal heads*dim_head={heads * dim_head}")
    if dim_head not in (64, 128):
        raise ValueError(f"fused_spatial_layer supports dim_head 64/128, got {dim_head}")
    bf = torch.bfloat16
    _lib.require(x, "x", bf)
    ln_w, ln_b = ln_w.float().contiguous(), ln_b.float().contiguous()
    wqkv, wo, bo = wqkv.to(bf).contiguous(), wo.to(bf).contiguous(), bo.to(bf).contiguous()
    _lib.require(ln_w, "ln_w", torch.float32, (c,))
    _lib.require(ln_b, "ln_b", torch.float32, (c,))
    _lib.require(wqkv, "wqkv", bf, (3 * c, c))
    _lib.require(wo, "wo", bf, (c, c))
    _lib.require(bo, "bo", bf, (c,))
    n = b * s
    xn = torch.empty((n, c), dtype=bf, device=x.device)
    qkv = torch.empty((n, 3 * c), dtype=bf, device=x.device)
    att = torch.empty((n, c), dtype=bf, device=x.device)
    out = torch.empty_like(x)
    err = _lib.lib().vc_spatial_layer(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wqkv.data_ptr(), wo.data_ptr(),
        bo.data_ptr(), xn.data_ptr(), qkv.data_ptr(), att.data_ptr(), out.data_ptr(),
        b, s, c, heads, dim_head, eps, _q_scale(dim_head, bf), _lib.stream_ptr())
    _lib.check(err, "fused_spatial_layer")
    launches += 1
    key = (b, s, heads, dim_head)
    sites[key] = sites.get(key, 0) + 1
    return out


# -- the TPU package's gate, copied ----------------------------------------


def _pick_block_q(s: int, c: int, budget: int = 96 * 1024 * 1024, itemsize: int = 2) -> int:
    es = itemsize
    w_bytes = (3 * c * c + c * c) * es
    resident = s * c * es * 2 + s * 3 * c * es
    for bq in (768, 576, 512, 384, 288, 256, 192, 128, 96, 64, 32, 16, 8):
        if s % bq:
            continue
        logits = bq * s * 4 * 2
        out = 2 * bq * c * es + bq * c * 4
        if resident + logits + out + w_bytes <= budget:
            return bq
    return 0


def supports_fused_spatial(x_shape, heads: int, dim_head: int, max_s: int = 9216,
                           itemsize: int = 2) -> bool:
    """Mirror of `spatial_layer.supports_fused_spatial` of the JAX package."""
    if len(x_shape) != 3:
        return False
    _, s, c = x_shape
    return (c == heads * dim_head and s <= max_s and dim_head in (64, 128)
            and s % 8 == 0 and _pick_block_q(s, c, itemsize=itemsize) > 0)
