"""GroupNorm with an optional SiLU on channels-last (N, S, C): hand-written
CUDA kernel + plain twin.

Replaces the TPU kernel
`viewcrafter_tpu/ops/pallas/groupnorm.py:group_norm_fused`.

Semantics: f32 sums per (sample, channel), folded per group, as the TPU
kernel takes them, but about a shift k, the group's first element (row 0,
its first channel): mean = k + E[x - k], var = E[(x - k)^2] - E[x - k]^2
clamped at 0. The TPU kernel's E[x^2] - mean^2 cancels on a group whose mean
is large against its spread (x = 100 + N(0, 1) in f32: 6.3e-3 from the JAX
package's default path, the shifted form 4.6e-5); the shift keeps one pass
and lands on the mean of squared deviations that
`models/layers.py:group_norm_silu` and the JAX default path take.
y = (x - mean) * rsqrt(var + eps) * scale + bias in f32; SiLU in f32 before
the cast to the input type. Input bf16 or f32, output the same type.

Kernel (`csrc/groupnorm.cu`), one launch per call: a cooperative grid of
N x chunks blocks, as many as can be resident at once (two 256-thread blocks
per SM, asked of the card once per device: `target_blocks`), so that a
grid-wide barrier cannot deadlock. Each block owns `chunk_rows` rows of one
sample:
  1. statistics: the block reads its rows coalesced (16 bytes per thread,
     eight loads in flight), keeps the first rows of its chunk in shared
     memory (about 94 KB a block, 25 MB over an H100), sums per channel in
     registers, folds its threads' partials through shared memory in a fixed
     order, and writes one (sum, sumsq) pair per group;
  2. a grid-wide barrier;
  3. fold: every block adds its sample's partials in chunk order (no float
     atomics anywhere, so a rerun gives the same bits) into (mean,
     rsqrt(var + eps)) per group;
  4. normalize: the rows kept in shared memory, then the rest of the chunk
     re-read from its end backwards (the rows step 1 read last are still in
     L2); applies the affine and the SiLU, writes y.

The gate is wider than the TPU's. There `c % 128 == 0` and the S-tile rule
are Mosaic lane and VMEM rules; they would send the 320- and 960-channel
norms of `model_channels=320` to the plain path. `supports_group_norm` asks
only what the kernel needs: C divisible by the group count, and rows that
start 16-byte aligned (C % 8 == 0 for bf16, C % 4 == 0 for f32). A group
need not be a whole vector (C / G = 10 at C = 320): channels are reduced per
channel first, then per group. The arithmetic is the same on both sides of
the TPU's gate, so parity with the JAX package is untouched.

Bound on an H100 SXM (3.35 TB/s): bytes, what the function needs: the
activation read once and written once; at the routes path's top site
(2, 230400, 320) bf16 that is 0.59 GB ~= 0.18 ms. Traffic of the kernel per
call: one write, and one read where the call's activation fits the blocks'
shared memory (up to ~25 MB: the UNet's deepest levels, the wiring sizes);
above that a second read of what neither shared memory nor L2 kept, at the
top site roughly 0.25 of the 0.30 GB of x (an estimate: ~0.84 GB in all,
~0.25 ms).
"""

from __future__ import annotations

import sys
from functools import partial

import torch

from viewcrafter_tpu_torch.ops.kernels import _lib

launches = 0  # wrapper calls that launched the CUDA kernel
sites: dict = {}  # (N, S, C, groups, itemsize, with_silu) -> launches at that shape
backward_plain = 0  # backward passes through the plain twin's VJP
backward_sites: dict = {}  # launch site -> backward passes of launches there
MIN_CHUNK_ROWS = 8
MAX_CHANNELS = 3840


def group_norm_fused_plain(x, scale, bias, num_groups: int = 32, eps: float = 1e-5,
                           with_silu: bool = False):
    """The kernel's arithmetic in plain torch. x (N, S, C); scale, bias (C,)."""
    n, s, c = x.shape
    cg = c // num_groups
    xf = x.float()
    count = float(s * cg)
    shift = xf[:, 0, ::cg]  # (N, G): each group's first element
    d = xf - shift.repeat_interleave(cg, dim=1)[:, None, :]
    sums = d.sum(1).reshape(n, num_groups, cg).sum(-1)
    sqs = (d * d).sum(1).reshape(n, num_groups, cg).sum(-1)
    mean_d = sums / count
    var = sqs / count - mean_d * mean_d
    mean = shift + mean_d
    inv = torch.rsqrt(var.clamp_min(0.0) + eps)
    mean_c = mean.repeat_interleave(cg, dim=1)[:, None, :]
    inv_c = inv.repeat_interleave(cg, dim=1)[:, None, :]
    y = (xf - mean_c) * inv_c * scale.float() + bias.float()
    if with_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def target_blocks(itemsize: int) -> int:
    """Blocks of one launch that the card holds at once (the cooperative
    grid may not exceed it): two per SM, from the kernel's occupancy (the
    library asks the card once per device and type)."""
    blocks = _lib.lib().vc_group_norm_blocks(itemsize)
    if blocks <= 0:
        _lib.check(-blocks or 1, "group_norm_fused occupancy")
    return blocks


def chunk_rows(n: int, s: int, blocks: int) -> int:
    """Rows of a sample that one block handles, with at most `blocks` blocks
    in all."""
    if n > blocks:
        raise ValueError(f"group_norm_fused takes at most {blocks} samples per call, got {n}")
    chunks = max(1, min(blocks // n, s // MIN_CHUNK_ROWS))
    return -(-s // chunks)


def group_norm_fused(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-5,
                     with_silu: bool = False) -> torch.Tensor:
    """x: (N, S, C) bf16 or f32, channels last; scale, bias: (C,). Returns
    GroupNorm(num_groups) with the affine and the optional SiLU, in x's type.
    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel or
    raises. Under grad the backward is the twin's VJP for x, scale and
    bias."""
    if not x.is_cuda:
        return group_norm_fused_plain(x, scale, bias, num_groups, eps, with_silu)
    kw = dict(num_groups=num_groups, eps=eps, with_silu=with_silu)
    spec = _lib.KernelSpec(partial(_launch, **kw), partial(group_norm_fused_plain, **kw),
                           sys.modules[__name__])
    return _lib.launch(spec, x, scale, bias)


def _launch(x, scale, bias, num_groups: int, eps: float, with_silu: bool):
    global launches
    if x.ndim != 3:
        raise ValueError(f"group_norm_fused takes (N, S, C), got {tuple(x.shape)}")
    n, s, c = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"group_norm_fused takes bf16 or f32, got {x.dtype}")
    if not supports_group_norm(x.shape, num_groups, x.element_size()):
        raise ValueError(f"group_norm_fused does not take C={c} with {num_groups} groups "
                         f"at {x.element_size()} bytes per element")
    _lib.require(x, "x", x.dtype)
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    _lib.require(scale, "scale", torch.float32, (c,))
    _lib.require(bias, "bias", torch.float32, (c,))
    rows = chunk_rows(n, s, target_blocks(x.element_size()))
    chunks = -(-s // rows)
    partial = torch.empty((n, chunks, num_groups, 2), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    err = _lib.lib().vc_group_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), partial.data_ptr(), out.data_ptr(),
        n, s, c, num_groups, rows, chunks, x.element_size(), int(with_silu), eps,
        _lib.stream_ptr())
    _lib.check(err, "group_norm_fused")
    launches += 1
    key = (n, s, c, num_groups, x.element_size(), int(with_silu))
    sites[key] = sites.get(key, 0) + 1
    return out


def supports_group_norm(x_shape, num_groups: int = 32, itemsize: int = 2) -> bool:
    """What the CUDA kernel needs (wider than the TPU kernel's gate, see the
    module docstring): (N, S, C) with C a multiple of the group count and of
    one 16-byte vector; at most MAX_CHANNELS channels (the per-channel sums of
    a block live in shared memory) and 256 groups (one fold thread each)."""
    if len(x_shape) != 3 or itemsize not in (2, 4):
        return False
    n, s, c = x_shape
    return (n > 0 and s > 0 and c % num_groups == 0 and c % (16 // itemsize) == 0
            and c <= MAX_CHANNELS and num_groups <= 256)
