"""Transformer FeedForward layer (LayerNorm -> GEGLU -> out projection):
hand-written CUDA kernels + plain twin.

Replaces the TPU kernel `viewcrafter_tpu/ops/pallas/ff_layer.py:fused_ff_layer`.

Kernels (`csrc/ff_layer.cu`), three launches per call:
  1. the LayerNorm, f32 statistics in two passes over the row (as the TPU
     kernel), normalised rows stored in bf16;
  2. GEMM1, whose B tile holds 80 rows of W1's `h` half and the 80 matching
     rows of its `gate` half, so one 160-wide accumulator holds both values
     of every output it gates; the epilogue adds b1 (in bf16, as the TPU
     kernel), applies h * GELU(gate) with the exact erf GELU in f32 (`erff`;
     the TPU kernel used an A&S polynomial) and stores the gated hidden g
     (N, 4C) in bf16;
  3. GEMM2 g @ W2 + b2.
Both products run on the Hopper GEMM core (`csrc/gemm_sm90.cuh`: TMA loads
into a ring of mbarrier-guarded stages, one producer warpgroup, two wgmma
consumer warpgroups of 64 rows, a persistent grid of one block per SM;
tiles of 128 rows x 160 columns). The normalised x (N, C) and the (N, 4C)
intermediate g cross device memory (g is 4x the activation bytes, written
and read once): an output tile of 128 rows at C_out = 1280 does not fit the
registers, so the product of g is not fused into GEMM1.

Bound on an H100 SXM (989 TF/s bf16, 3.35 TB/s) at the flagship ds1 site
N = 460800, C = 320: 2*N*C*8C + 2*N*4C*C = 1.13 TFLOP ~= 1.15 ms against
0.59 GB of input/output traffic: bound by operations. The three launches
have their own floors at that site: the LayerNorm 0.59 GB of bytes
(0.18 ms), GEMM1 0.75 TFLOP (0.76 ms), GEMM2 the 1.18 GB read of g plus its
output (0.44 ms): about 1.4 ms for this design.
"""

from __future__ import annotations

import sys
from functools import partial

import torch

from viewcrafter_tpu_torch.ops.kernels import _lib

launches = 0  # wrapper calls that launched the CUDA kernels
sites: dict = {}  # (N, C, I, C_out) -> launches at that shape
backward_plain = 0  # backward passes through the plain twin's VJP
backward_sites: dict = {}  # launch site -> backward passes of launches there


def _layer_norm(x, w, b, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * w.float() + b.float()).to(x.dtype)


def fused_ff_layer_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5):
    """The kernels' arithmetic in plain torch. x (..., C); w1 (2I, C) and
    w2 (C_out, I) in nn.Linear layout. Returns (..., C_out) in x.dtype."""
    dt = x.dtype
    inner = w2.shape[1]
    xn = _layer_norm(x, ln_w, ln_b, eps)
    y = (xn.float() @ w1.to(dt).float().t()).to(dt) + b1.to(dt)
    h, gate = y[..., :inner], y[..., inner:]
    gelu = torch.nn.functional.gelu(gate.float(), approximate="none").to(dt)
    g = h * gelu
    return (g.float() @ w2.to(dt).float().t()).to(dt) + b2.to(dt)


def fused_ff_layer(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-5):
    """x: (..., C). ln_w, ln_b: (C,) f32. w1: (2I, C), b1: (2I,);
    w2: (C_out, I), b2: (C_out,). Returns LayerNorm -> GEGLU -> out
    projection, shaped (..., C_out), without the residual. A CPU tensor
    takes the plain twin; a CUDA tensor launches the kernels or raises.
    Under grad the backward is the twin's VJP for x and every weight."""
    if not x.is_cuda:
        return fused_ff_layer_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps)
    spec = _lib.KernelSpec(partial(_launch, eps=eps), partial(fused_ff_layer_plain, eps=eps),
                           sys.modules[__name__])
    return _lib.launch(spec, x, ln_w, ln_b, w1, b1, w2, b2)


def _launch(x, ln_w, ln_b, w1, b1, w2, b2, eps):
    global launches
    c = x.shape[-1]
    inner, c_out = w2.shape[1], w2.shape[0]
    n = x.numel() // c
    _lib.require(x, "x", torch.bfloat16)
    if c % 8 or inner % 8 or c_out % 8:
        raise ValueError(f"fused_ff_layer needs C, I, C_out divisible by 8, got {c}, {inner}, {c_out}")
    bf = torch.bfloat16
    ln_w, ln_b = ln_w.float().contiguous(), ln_b.float().contiguous()
    w1, b1 = w1.to(bf).contiguous(), b1.to(bf).contiguous()
    w2, b2 = w2.to(bf).contiguous(), b2.to(bf).contiguous()
    for t, name, shape in ((ln_w, "ln_w", (c,)), (ln_b, "ln_b", (c,))):
        _lib.require(t, name, torch.float32, shape)
    for t, name, shape in ((w1, "w1", (2 * inner, c)), (b1, "b1", (2 * inner,)),
                           (w2, "w2", (c_out, inner)), (b2, "b2", (c_out,))):
        _lib.require(t, name, bf, shape)
    xn = torch.empty((n, c), dtype=bf, device=x.device)
    g = torch.empty((n, inner), dtype=bf, device=x.device)
    out = torch.empty(x.shape[:-1] + (c_out,), dtype=bf, device=x.device)
    err = _lib.lib().vc_ff_layer(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), xn.data_ptr(), g.data_ptr(), out.data_ptr(),
        n, c, inner, c_out, eps, _lib.stream_ptr())
    _lib.check(err, "fused_ff_layer")
    launches += 1
    key = (n, c, inner, c_out)
    sites[key] = sites.get(key, 0) + 1
    return out


# -- the TPU package's gate, copied so the same sites take the kernel ------


def _pick_tile(n: int, c: int, inner: int, budget: int = 80 * 1024 * 1024,
               itemsize: int = 2) -> int:
    es = itemsize
    w_bytes = (c * 2 * inner + inner * c) * es
    for tile in (2048, 1024, 512, 256, 128, 64, 32, 16, 8):
        if n % tile:
            continue
        blocks = 2 * 2 * tile * c * es
        inter = tile * (c * 4 + 2 * inner * 2 * es + inner * es)
        if blocks + inter + w_bytes <= budget:
            return tile
    return 0


def supports_fused_ff(x_shape, c: int, inner: int, itemsize: int = 2) -> bool:
    """Mirror of `ff_layer.supports_fused_ff` of the JAX package."""
    n = 1
    for dim in x_shape[:-1]:
        n *= dim
    return x_shape[-1] == c and _pick_tile(n, c, inner, itemsize=itemsize) > 0
