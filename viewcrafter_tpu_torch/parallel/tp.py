"""Tensor parallelism over the UNet's heads and channels ("tp"): the
counterpart of the JAX package's parallel/tp.py, Megatron-style on
torch.distributed.

The JAX package marks where XLA's partitioner should split the UNet
(sharding constraints on heads and channels) and turns its Pallas kernels off
under a tp mesh, since the partitioner cannot split a custom call. The port
has no partitioner: each rank of the "tp" axis holds its own slice of the
split weights, runs every hand-written kernel on that slice, and makes the
one collective of each split module itself:

  - a column-parallel product (this rank's block of output features), the
    local work on it, then a row-parallel product (the same block of input
    features) whose partial sums one all-reduce over the axis adds up
    (`Axis.sum`); the row-parallel bias is added on tp index 0 only (zero on
    the others);
  - attention (`CrossAttention`, `TemporalSelfAttention`): to_q / to_k /
    to_v (and to_k_ip / to_v_ip) column-parallel by head block, to_out
    row-parallel. A rank whose block of heads is empty (more ranks than
    heads) launches nothing there and adds zeros;
  - `FeedForward`: the GEGLU product column-parallel over the hidden units,
    the rank's block taken from both the value half and the gate half of its
    (2I, C) weight; the out product row-parallel;
  - `ResBlock`: in_conv and emb_proj column-parallel over output channels,
    out_norm on the rank's channel groups, out_conv row-parallel; in_norm
    and skip replicated;
  - `TemporalConvBlock`: conv_0 and conv_2 column-parallel, norm_1 and norm_3
    on the rank's groups, conv_1 and conv_3 row-parallel, each followed by
    one all-reduce; norm_0 and norm_2 see the whole, replicated tensor.
Everything else (the transformers' norms and projections, the embeddings,
the input and output convs, the samplers) is replicated.

Blocks are contiguous, and with an uneven split the first `n % tp` ranks
take one more (`head_block`): 5 heads split 3/2 at tp = 2. Channels are
split by GroupNorm groups, and unlike the JAX package, which pads uneven
shards, the port requires tp to divide the 32 groups (a ValueError
otherwise), so that every rank's GroupNorm sees whole groups.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from viewcrafter_tpu_torch.models.layers import FeedForward, GroupNorm32
from viewcrafter_tpu_torch.models.unet3d import (
    CrossAttention,
    ResBlock,
    TemporalConvBlock,
    TemporalSelfAttention,
)
from viewcrafter_tpu_torch.parallel.mesh import Axis

GROUPS = 32  # the UNet's GroupNorm groups


def head_block(n: int, axis: Axis) -> slice:
    """This rank's contiguous block of `n` heads (or channel groups, or
    hidden units) along `axis`: the first n % size ranks take one more."""
    q, r = divmod(n, axis.size)
    start = axis.index * q + min(axis.index, r)
    return slice(start, start + q + (axis.index < r))


def _scaled(block: slice, unit: int) -> slice:
    return slice(block.start * unit, block.stop * unit)


@torch.no_grad()
def _take_(p: nn.Parameter, dim: int, *blocks: slice) -> None:
    """Keep `blocks` of `p` along `dim`, concatenated, in place (a conv
    weight stored channels-last stays so)."""
    data = p.data
    parts = [data.narrow(dim, b.start, b.stop - b.start) for b in blocks]
    fmt = (torch.channels_last if data.ndim == 4 and not data.is_contiguous()
           and data.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    p.data = torch.cat(parts, dim).contiguous(memory_format=fmt)


@torch.no_grad()
def _row_bias_(p: nn.Parameter, axis: Axis) -> None:
    """A row-parallel product's bias counts once: on tp index 0."""
    if axis.index:
        p.data.zero_()


def _shard_attention(mod, axis: Axis) -> None:
    cols = _scaled(head_block(mod.heads, axis), mod.dim_head)
    for name in ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip"):
        if hasattr(mod, name):
            _take_(getattr(mod, name).weight, 0, cols)
    _take_(mod.to_out.weight, 1, cols)
    _row_bias_(mod.to_out.bias, axis)
    mod.heads = (cols.stop - cols.start) // mod.dim_head


def _shard_ff(mod: FeedForward, axis: Axis) -> None:
    block = head_block(mod.inner, axis)
    value_gate = (block, slice(mod.inner + block.start, mod.inner + block.stop))
    _take_(mod.geglu.proj.weight, 0, *value_gate)
    _take_(mod.geglu.proj.bias, 0, *value_gate)
    _take_(mod.out.weight, 1, block)
    _row_bias_(mod.out.bias, axis)
    mod.inner = block.stop - block.start


def _channel_block(channels: int, axis: Axis) -> slice:
    return _scaled(head_block(GROUPS, axis), channels // GROUPS)


def _column_(conv_or_linear, block: slice) -> None:
    _take_(conv_or_linear.weight, 0, block)
    _take_(conv_or_linear.bias, 0, block)


def _row_(conv_or_linear, block: slice, axis: Axis) -> None:
    _take_(conv_or_linear.weight, 1, block)
    _row_bias_(conv_or_linear.bias, axis)


def _local_norm_(norm: GroupNorm32, block: slice) -> None:
    """The norm on the channel `block`: its whole groups, local statistics."""
    per_group = norm.weight.shape[0] // norm.num_groups
    _take_(norm.weight, 0, block)
    _take_(norm.bias, 0, block)
    norm.num_groups = (block.stop - block.start) // per_group


def _shard_resblock(mod: ResBlock, axis: Axis) -> None:
    block = _channel_block(mod.out_conv.weight.shape[0], axis)
    _column_(mod.in_conv, block)
    _column_(mod.emb_proj, block)
    _local_norm_(mod.out_norm, block)
    _row_(mod.out_conv, block, axis)


def _shard_temporal_convs(mod: TemporalConvBlock, axis: Axis) -> None:
    block = _channel_block(mod.conv_0.features, axis)
    for col, norm, row in ((mod.conv_0, mod.norm_1, mod.conv_1),
                           (mod.conv_2, mod.norm_3, mod.conv_3)):
        _column_(col, block)
        col.features = block.stop - block.start
        _local_norm_(norm, block)
        _row_(row, block, axis)


_SHARD = ((CrossAttention, _shard_attention), (TemporalSelfAttention, _shard_attention),
          (FeedForward, _shard_ff), (ResBlock, _shard_resblock),
          (TemporalConvBlock, _shard_temporal_convs))


def shard_unet_(unet: nn.Module, axis: Axis) -> nn.Module:
    """Cut the whole, loaded `unet` (a UNet3D, or any module holding split
    modules) to this rank's slice along the "tp" axis `axis`, in place, and
    give every split module the axis for its all-reduce. A no-op at tp = 1;
    a ValueError where tp does not divide the 32 GroupNorm groups. Returns
    `unet`."""
    if axis.size == 1:
        return unet
    if GROUPS % axis.size:
        raise ValueError(f"tensor parallelism needs tp to divide the {GROUPS} GroupNorm groups, "
                         f"got tp={axis.size}")
    for mod in unet.modules():
        for cls, shard in _SHARD:
            if isinstance(mod, cls):
                shard(mod, axis)
                mod.tp = axis
    return unet
