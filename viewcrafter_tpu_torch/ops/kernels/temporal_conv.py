"""Conv3d((3,1,1)) over the frame axis: hand-written CUDA kernel + plain twin.

Replaces the TPU kernel `viewcrafter_tpu/ops/pallas/temporal_conv.py:temporal_conv3`.

Kernel (`csrc/temporal_conv.cu`): an implicit GEMM on the Hopper GEMM core
(`csrc/gemm_sm90.cuh`: TMA loads into a ring of mbarrier-guarded stages, one
producer warpgroup, two wgmma consumer warpgroups of 64 rows, a persistent
grid of one block per SM; tiles of 128 rows x 160 output channels). x is
seen as (B, T*S, Cin) rows; tap dt of the rows starting at flat row r0 is
the tile at row r0 + (dt-1)*S, and rows outside [0, T*S) read as zeros
(the tensor map's bounds), which is the SAME padding at both frame edges,
so the three shifted copies never exist in memory; f32 accumulation over
all three taps; the bias (rounded to the activation type, as the TPU kernel
casts it) is added to the f32 sum in the epilogue, then one bf16 store.

Bound on an H100 SXM (989 TF/s bf16, 3.35 TB/s) at the flagship ds1 site
(2, 25, 9216, 320) -> 320: 2 * 460800 * 960 * 320 = 283 GFLOP ~= 0.29 ms
against 0.59 GB of traffic ~= 0.18 ms: bound by operations. The design reads
each x row from device memory about once (the resident tiles share their
rows and their taps' rows in L2) and keeps the accumulator in registers.

Weights are taken in the kernel's layout, (Cout, 3*Cin): row o holds tap 0's
Cin weights, then tap 1's, then tap 2's, i.e. Conv3d's (Cout, Cin, 3, 1, 1)
weight transposed once to (Cout, 3, Cin) (`rows_from_conv3d`).
"""

from __future__ import annotations

import sys

import torch

from viewcrafter_tpu_torch.ops.kernels import _lib

launches = 0  # wrapper calls that launched the CUDA kernel
sites: dict = {}  # (B, T, S, Cin, Cout) -> launches at that shape
backward_plain = 0  # backward passes through the plain twin's VJP
backward_sites: dict = {}  # launch site -> backward passes of launches there


def rows_from_conv3d(weight: torch.Tensor) -> torch.Tensor:
    """Conv3d's (Cout, Cin, 3, 1, 1) weight -> the kernel's (Cout, 3*Cin)."""
    cout, cin = weight.shape[:2]
    return weight[:, :, :, 0, 0].transpose(1, 2).reshape(cout, 3 * cin)


def temporal_conv3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, in its formulation: x (B, T,
    S, Cin) as (B, T*S, Cin) rows with S zero rows on each side (frames -1
    and T), tap dt the rows shifted by (dt-1)*S; w (Cout, 3*Cin), b (Cout,)
    -> (B, T, S, Cout) in x.dtype."""
    bsz, t, s, cin = x.shape
    xp = torch.nn.functional.pad(x.reshape(bsz, t * s, cin), (0, 0, s, s))
    wf = w.to(x.dtype).float().view(-1, 3, cin)
    acc = sum(xp[:, dt * s:(dt + t) * s].float() @ wf[:, dt].t() for dt in range(3))
    return (acc + b.to(x.dtype).float()).to(x.dtype).view(bsz, t, s, -1)


def temporal_conv3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, T, S, Cin); w: (Cout, 3*Cin); b: (Cout,). SAME zero padding
    over T, as torch Conv3d((3,1,1), padding=(1,0,0)). Returns
    (B, T, S, Cout) in x.dtype. A CPU tensor takes the plain twin; a CUDA
    tensor launches the kernel or raises. Under grad the backward is the
    twin's VJP for x, w and b (a Conv3d weight reaches w through
    `rows_from_conv3d`, whose own backward then applies)."""
    if not x.is_cuda:
        return temporal_conv3_plain(x, w, b)
    spec = _lib.KernelSpec(_launch, temporal_conv3_plain, sys.modules[__name__])
    return _lib.launch(spec, x, w, b)


def _launch(x, w, b):
    global launches
    bsz, t, s, cin = x.shape
    cout = w.shape[0]
    _lib.require(x, "x", torch.bfloat16)
    w = w.to(torch.bfloat16).contiguous()
    _lib.require(w, "w", torch.bfloat16, (cout, 3 * cin))
    if cin % 8 or cout % 8:
        raise ValueError(f"temporal_conv3 needs Cin and Cout divisible by 8, got {cin}, {cout}")
    bb = b.to(torch.bfloat16).contiguous()
    _lib.require(bb, "b", torch.bfloat16, (cout,))
    y = torch.empty((bsz, t, s, cout), dtype=x.dtype, device=x.device)
    err = _lib.lib().vc_temporal_conv3(
        x.data_ptr(), w.data_ptr(), bb.data_ptr(), y.data_ptr(),
        bsz, t, s, cin, cout, _lib.stream_ptr())
    _lib.check(err, "temporal_conv3")
    launches += 1
    key = (bsz, t, s, cin, cout)
    sites[key] = sites.get(key, 0) + 1
    return y


# -- the TPU package's gate, copied so the same sites take the kernel ------


def _vmem_bytes(tile: int, t: int, cin: int, cout: int) -> int:
    blk_in = t * tile * cin * 2
    blk_out = t * tile * cout * 2
    w = 3 * cin * cout * 2
    xp = (t + 2) * tile * cin * 2
    acc = t * tile * cout * 4
    return 2 * blk_in + 2 * blk_out + w + xp + acc


def _pick_tile(s: int, t: int, cin: int, cout: int) -> int:
    for tile in (256, 192, 128, 96, 64, 48, 32, 16, 8):
        if s % tile == 0 and _vmem_bytes(tile, t, cin, cout) <= 13_500_000:
            return tile
    return 0


def supports_fused(x_shape, cin: int, cout: int, max_t: int = 64) -> bool:
    """Mirror of `temporal_conv.supports_fused` of the JAX package."""
    b, t, s, c = x_shape
    return t <= max_t and c == cin and _pick_tile(s, t, cin, cout) > 0
