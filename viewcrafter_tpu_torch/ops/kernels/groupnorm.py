"""GroupNorm with an optional SiLU on channels-last (N, S, C): hand-written
CUDA kernels + plain twin.

Replaces the TPU kernel
`viewcrafter_tpu/ops/pallas/groupnorm.py:group_norm_fused`.

Semantics kept from the TPU kernel: f32 sum and sum of squares per (sample,
channel), folded per group; var = E[x^2] - mean^2 clamped at 0 (not the mean
of squared deviations, which `models/layers.py:group_norm_silu` computes);
y = (x - mean) * rsqrt(var + eps) * scale + bias in f32; SiLU in f32 before
the cast to the input type. Input bf16 or f32, output the same type.

Kernels (`csrc/groupnorm.cu`), three launches per call:
  1. statistics: the rows of each sample are cut into chunks so that about
     four blocks per SM run however small N is (N is 1 or 2 at the VAE's and
     the temporal norms); a block reads whole rows coalesced (16 bytes per
     thread), sums per channel in registers, folds its threads' partials
     through shared memory in a fixed order, and writes one (sum, sumsq)
     pair per group;
  2. fold: one block per sample adds the chunks' partials in chunk order (no
     float atomics anywhere, so a rerun gives the same bits) and writes
     (mean, rsqrt(var + eps)) per group;
  3. normalize: the same chunking; reads x again, applies the affine and the
     SiLU, writes y.

The gate is wider than the TPU's. There `c % 128 == 0` and the S-tile rule
are Mosaic lane and VMEM rules; they would send the 320- and 960-channel
norms of `model_channels=320` to the plain path. `supports_group_norm` asks
only what these kernels need: C divisible by the group count, and rows that
start 16-byte aligned (C % 8 == 0 for bf16, C % 4 == 0 for f32). A group
need not be a whole vector (C / G = 10 at C = 320): channels are reduced per
channel first, then per group. The arithmetic is the same on both sides of
the TPU's gate, so parity with the JAX package is untouched.

Bound on an H100 SXM (3.35 TB/s): bytes, what the function needs: the
activation read once and written once; at the flagship (50, 9216, 320) bf16
that is 0.59 GB ~= 0.18 ms. These kernels read x twice (statistics, then
normalize), a third pass over the bound by design: a sample's slab (5.9 MB
there) would fit the 50 MB L2, which a one-launch design could use.
"""

from __future__ import annotations

import torch

from viewcrafter_tpu_torch.ops.kernels import _lib

launches = 0  # wrapper calls that launched the CUDA kernels
sites: dict = {}  # (N, S, C, itemsize, with_silu) -> launches at that shape
TARGET_BLOCKS = 528  # statistics / normalize blocks per call: four per SM of an H100
MIN_CHUNK_ROWS = 8
MAX_CHANNELS = 3840


def group_norm_fused_plain(x, scale, bias, num_groups: int = 32, eps: float = 1e-5,
                           with_silu: bool = False):
    """The kernels' arithmetic in plain torch. x (N, S, C); scale, bias (C,)."""
    n, s, c = x.shape
    cg = c // num_groups
    xf = x.float()
    count = float(s * cg)
    sums = xf.sum(1).reshape(n, num_groups, cg).sum(-1)
    sqs = (xf * xf).sum(1).reshape(n, num_groups, cg).sum(-1)
    mean = sums / count
    var = sqs / count - mean * mean
    inv = torch.rsqrt(var.clamp_min(0.0) + eps)
    mean_c = mean.repeat_interleave(cg, dim=1)[:, None, :]
    inv_c = inv.repeat_interleave(cg, dim=1)[:, None, :]
    y = (xf - mean_c) * inv_c * scale.float() + bias.float()
    if with_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def chunk_rows(n: int, s: int) -> int:
    """Rows of a sample that one statistics / normalize block handles."""
    chunks = max(1, min(-(-TARGET_BLOCKS // n), s // MIN_CHUNK_ROWS))
    return -(-s // chunks)


def group_norm_fused(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-5,
                     with_silu: bool = False) -> torch.Tensor:
    """x: (N, S, C) bf16 or f32, channels last; scale, bias: (C,). Returns
    GroupNorm(num_groups) with the affine and the optional SiLU, in x's type.
    A CPU tensor takes the plain twin; a CUDA tensor launches the kernels or
    raises."""
    global launches
    if not x.is_cuda:
        return group_norm_fused_plain(x, scale, bias, num_groups, eps, with_silu)
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
    rows = chunk_rows(n, s)
    chunks = -(-s // rows)
    partial = torch.empty((n, chunks, num_groups, 2), dtype=torch.float32, device=x.device)
    stats = torch.empty((n, num_groups, 2), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    err = _lib.lib().vc_group_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), partial.data_ptr(), stats.data_ptr(),
        out.data_ptr(), n, s, c, num_groups, rows, chunks, x.element_size(), int(with_silu),
        eps, _lib.stream_ptr())
    _lib.check(err, "group_norm_fused")
    launches += 1
    key = (n, s, c, x.element_size(), int(with_silu))
    sites[key] = sites.get(key, 0) + 1
    return out


def supports_group_norm(x_shape, num_groups: int = 32, itemsize: int = 2) -> bool:
    """What the CUDA kernels need (wider than the TPU kernel's gate, see the
    module docstring): (N, S, C) with C a multiple of the group count and of
    one 16-byte vector; at most MAX_CHANNELS channels (the per-channel sums of
    a block live in shared memory) and 256 groups (one fold thread each)."""
    if len(x_shape) != 3 or itemsize not in (2, 4):
        return False
    n, s, c = x_shape
    return (n > 0 and s > 0 and c % num_groups == 0 and c % (16 // itemsize) == 0
            and c <= MAX_CHANNELS and num_groups <= 256)
