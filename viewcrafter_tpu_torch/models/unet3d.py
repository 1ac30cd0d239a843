"""3D U-Net video denoiser with factorized spatial/temporal attention: the
port of the JAX package's models/unet3d.py (same structure, same submodule
names, same tensor layouts).

Channels-last tensors; frames ride the batch axis for spatial ops
((B*T, H, W, C)) and temporal ops run on (B, T, S, C). On a CUDA tensor the
sites that run a Pallas kernel on the TPU run the hand-written kernels:
spatial self-attention (`fullkv_attention`), both temporal attentions
(`fused_temporal_layer`), every GEGLU FF (`fused_ff_layer`) and every
temporal conv (`temporal_conv3`). Where the layer kernel's gate fails but
`temporal_attention_fused`'s holds (clips of 33 to 64 frames), the temporal
attentions run that kernel between plain projections. The sites that fail a
kernel's gate take plain torch ops, as the JAX package takes XLA there.

Two routes, off by default here as in the JAX package (which selects them
by environment variable; here they are constructor arguments):
`cross_attn_impl` other than "xla" sends every image cross-attention whose
shape passes the gate through `dual_cross_attention`, and `gn_fused=True`
every GroupNorm through `group_norm_fused`. `VideoDiffusionEngine` builds
its UNet with `gn_fused=True`.

PAB-style attention reuse: `AttnCacheCtx` and the `attn_cache` /
`collect_cache` arguments of `UNet3D.forward`, with the JAX package's site
names.

The two temporal-attention options of the reference (off in every shipped
config): `use_relative_position`, a Shaw-style learned relative-position bias
(two float32 (2*temporal_length+1, dim_head) tables per attention, named
`rel_k_table` and `rel_v_table` as in the JAX package), and
`use_causal_attention`, a lower-triangular mask over the frames. As in the
JAX package, a temporal attention with either takes the plain path, not the
layer kernel nor `temporal_attention_fused`.

Frame sharding (`frames`, an "sp" mesh axis of `parallel/mesh.py`): x holds
this rank's block of the clip's frames. Spatial stages treat frames as batch
entries and run on the local block; the two modules that read across frames,
`TemporalTransformer` (the temporal attentions and `init_attn`, whose
GroupNorm statistics span all frames) and `TemporalConvBlock` (its GroupNorms
and the conv's 3-frame window), gather the clip's frames over the axis, run
on all of them, kernels included, and keep this rank's block: the temporal
work is repeated on every rank of the axis, as the all-gathers XLA inserts
around those stages in the JAX package amount to.

Tensor parallelism (a "tp" mesh axis, `parallel/tp.py`): `shard_unet_` cuts
the loaded weights of the split modules (`CrossAttention`,
`TemporalSelfAttention`, `FeedForward`, `ResBlock`, `TemporalConvBlock`) to
this rank's heads and channels and sets their `tp` axis; each then runs its
kernels on its slice and ends its row-parallel product with one all-reduce
(`tp.sum`), so that what it returns, and what an attention-cache site
stores, is the whole, replicated output. Under "sp" the tp modules run
inside the gathered clip. Unsharded, `tp` is NO_AXIS and the sums are the
identity.

Gradient checkpointing (`remat=True`, the JAX package's per-block `nn.remat`
and the reference's per-block checkpointing): every `SpatialTransformer`,
`TemporalTransformer` and `ResBlock` runs under
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`, which keeps its
inputs and recomputes its inside in the backward; the kernels it launches
are launched again there. As in the JAX package it is off when an attention
cache is read or collected, and the CFG shared-prefix dedup is off under it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from viewcrafter_tpu_torch.config import UNetConfig
from viewcrafter_tpu_torch.models.layers import (
    Conv,
    FeedForward,
    GroupNorm32,
    LayerNormF32,
    layer_norm_f32,
    set_group_norm_fused,
    silu,
)
from viewcrafter_tpu_torch.ops.attention import attention
from viewcrafter_tpu_torch.ops.kernels import cross_attention as _dual
from viewcrafter_tpu_torch.ops.kernels import temporal_attention as _tattn
from viewcrafter_tpu_torch.ops.kernels import temporal_conv as _tconv
from viewcrafter_tpu_torch.ops.kernels import temporal_layer as _tlayer
from viewcrafter_tpu_torch.ops.schedule import timestep_embedding
from viewcrafter_tpu_torch.parallel.mesh import NO_AXIS, Axis


class CrossAttention(nn.Module):
    """Multi-head attention with optional dual-stream image cross-attention
    (separate k/v for the tokens past `text_context_len`, out = out_text +
    out_img). Self-attention when context is None. With `attn_impl` other
    than "xla", no mask and a shape that passes `supports_dual`, the two
    image-conditioned streams run as one `dual_cross_attention` call (the
    CUDA kernel on a CUDA tensor, its plain twin on a CPU tensor). `tp`: the
    head split (`parallel/tp.py`); with no heads left on this rank it adds
    zeros to the sum."""

    tp: Axis = NO_AXIS

    def __init__(self, heads: int, dim_head: int, query_dim: int,
                 context_dim: Optional[int] = None, image_cross_attention: bool = False,
                 text_context_len: int = 77, attn_impl: str = "auto"):
        super().__init__()
        inner = heads * dim_head
        kv_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.image_cross_attention = image_cross_attention
        self.text_context_len = text_context_len
        self.attn_impl = attn_impl
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        if image_cross_attention:
            self.to_k_ip = nn.Linear(kv_dim, inner, bias=False)
            self.to_v_ip = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x, context=None, mask=None):
        if self.heads == 0:
            return self.tp.sum(x.new_zeros(x.shape[:-1] + (self.to_out.out_features,)))
        return self.tp.sum(self._local(x, context, mask))

    def _local(self, x, context, mask):
        """This rank's heads: the whole output unsharded, else a partial sum
        of the out projection."""
        h, d = self.heads, self.dim_head
        b, n, _ = x.shape
        q = self.to_q(x).view(b, n, h, d)
        ctx = x if context is None else context
        ctx_img = None
        if context is not None:
            ctx_img = ctx[:, self.text_context_len:] if self.image_cross_attention else None
            ctx = ctx[:, :self.text_context_len]
        k = self.to_k(ctx).view(b, -1, h, d)
        v = self.to_v(ctx).view(b, -1, h, d)
        if ctx_img is not None:
            k_ip = self.to_k_ip(ctx_img).view(b, -1, h, d)
            v_ip = self.to_v_ip(ctx_img).view(b, -1, h, d)
            if (mask is None and self.attn_impl != "xla"
                    and _dual.supports_dual(q.shape, k.shape[1], k_ip.shape[1])):
                out = _dual.dual_cross_attention(q, k, v, k_ip, v_ip)
                return self.to_out(out.reshape(b, n, h * d))
        out = attention(q, k, v, mask=mask, impl=self.attn_impl).reshape(b, n, h * d)
        if ctx_img is not None:
            out = out + attention(q, k_ip, v_ip, impl=self.attn_impl).reshape(b, n, h * d)
        return self.to_out(out)


class AttnCacheCtx:
    """Attention-output caching (Pyramid-Attention-Broadcast-style reuse):
    attention deltas drift slowly across adjacent DDIM steps, so a step may
    reuse the previous step's attention outputs instead of recomputing them.

    `reads`: site name -> cached tensor consumed instead of computing that
    site; `writes` collects this pass's outputs when `collect`. The flags
    pick the site families (spatial self-attention, cross-attention, temporal
    self-attention, feed-forward). `store_dtype`: what `writes` holds (e.g.
    torch.float8_e4m3fn halves the cache); `compute_dtype`: what reads are
    cast back to."""

    def __init__(self, reads=None, collect=False, spatial=True, cross=True, temporal=True,
                 ff=False, store_dtype=None, compute_dtype=None):
        self.reads = reads or {}
        self.writes = {} if collect else None
        self.spatial, self.cross, self.temporal, self.ff = spatial, cross, temporal, ff
        self.store_dtype, self.compute_dtype = store_dtype, compute_dtype

    def site(self, kind: str, name: str, compute):
        enabled = getattr(self, kind)
        if enabled and name in self.reads:
            out = self.reads[name]
            if self.compute_dtype is not None:
                out = out.to(self.compute_dtype)
        else:
            out = compute()
        if self.writes is not None and enabled:
            self.writes[name] = out if self.store_dtype is None else out.to(self.store_dtype)
        return out


_NO_CACHE = AttnCacheCtx()


class TransformerBlock(nn.Module):
    """norm->self-attn, norm->cross-attn (`cross_attn_impl`: "xla", the
    default as in the JAX package, is plain ops), norm->GEGLU-FF, each
    residual and each a cache site."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 image_cross_attention: bool, cross_attn_impl: str = "xla"):
        super().__init__()
        self.norm1 = LayerNormF32(dim)
        self.attn1 = CrossAttention(heads, dim_head, dim)
        self.norm2 = LayerNormF32(dim)
        self.attn2 = CrossAttention(heads, dim_head, dim, context_dim=context_dim,
                                    image_cross_attention=image_cross_attention,
                                    attn_impl=cross_attn_impl)
        self.norm3 = LayerNormF32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, cache: AttnCacheCtx = _NO_CACHE, site: str = "",
                tile_k: int = 1):
        x = x + cache.site("spatial", site + "/attn1", lambda: self.attn1(self.norm1(x)))
        if tile_k > 1:
            # CFG-prefix dedup tile point (see UNet3D shared_prefix)
            x = x.repeat(tile_k, 1, 1)
        x = x + cache.site("cross", site + "/attn2",
                           lambda: self.attn2(self.norm2(x), context=context))
        return x + cache.site("ff", site + "/ff", lambda: self.ff(x, ln=self.norm3))


class SpatialTransformer(nn.Module):
    """Per-frame transformer over (h*w) tokens with linear projections."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int,
                 context_dim: int, image_cross_attention: bool, cross_attn_impl: str = "xla"):
        super().__init__()
        inner = heads * dim_head
        self.depth = depth
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        for i in range(depth):
            self.add_module(f"block_{i}", TransformerBlock(
                inner, heads, dim_head, context_dim, image_cross_attention, cross_attn_impl))
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x, context, cache: AttnCacheCtx = _NO_CACHE, site: str = "",
                tile_k: int = 1):
        # x: (BT, H, W, C); context: (BT, L, context_dim). tile_k > 1: x holds
        # ONE of tile_k identical CFG branches, replicated inside block_0
        bt, hh, ww, c = x.shape
        h = self.proj_in(self.norm(x).reshape(bt, hh * ww, c))
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context, cache=cache, site=f"{site}/block_{i}",
                                            tile_k=tile_k if i == 0 else 1)
        h = self.proj_out(h)
        if tile_k > 1:
            x = x.repeat(tile_k, 1, 1, 1)
            bt = x.shape[0]
        return x + h.reshape(bt, hh, ww, c)


def _temporal_attention(q, k, v, mask=None, k2=None, v2=None):
    """Self-attention over the t axis of (B, T, S, H, D) tensors: the
    `temporal_attention_fused` kernel on a CUDA tensor whose shape passes
    the gate that sends the JAX package to its Pallas kernel on a TPU (no
    mask, no relative-position bias, T <= 64, head dim 64 or 128), else
    plain ops. As in the JAX package, the gate is asked at any T: a site of
    up to 32 frames gets here only where the layer kernel's gate failed,
    which at the full-width presets (25 frames, or 16) happens at no
    temporal site (tests/test_torch_routes.py enumerates them), so their
    default path launches this kernel nowhere.

    mask: (Tq, Tk) bool, True where a query may attend. k2 / v2: the
    gathered relative-position tables (Tq, Tk, D), shared across batch,
    pixels and heads: q.k2 adds to the logits, probs.v2 to the output
    (reference attention.py:20-39,104-123)."""
    if q.is_cuda and mask is None and k2 is None and _tattn.supports_fused(q.shape):
        return _tattn.temporal_attention_fused(q, k, v)
    d = q.shape[-1]
    logits = torch.einsum("bqshd,bkshd->bshqk", q.float(), k.float())
    if k2 is not None:
        logits = logits + torch.einsum("bqshd,qkd->bshqk", q.float(), k2.to(q.dtype).float())
    logits = logits * (d ** -0.5)
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if v2 is None:
        return torch.einsum("bshqk,bkshd->bqshd", probs, v).to(q.dtype)
    out = torch.einsum("bshqk,bkshd->bqshd", probs.float(), v.float())
    out = out + torch.einsum("bshqk,qkd->bqshd", probs.float(), v2.to(q.dtype).float())
    return out.to(q.dtype)


def _gather_relative(table, tq: int, tk: int, max_rel: int):
    """(2*max_rel+1, D) table -> (Tq, Tk, D): row clip(k - q) + max_rel."""
    pos = torch.arange(max(tq, tk), device=table.device)
    dist = pos[None, :tk] - pos[:tq, None]
    return table[dist.clamp(-max_rel, max_rel) + max_rel]


class TemporalSelfAttention(nn.Module):
    """Self-attention over T on (B, T, S, C) with CrossAttention's parameter
    names. `ln`: the preceding LayerNormF32, applied inside so that on the
    card the whole layer runs through the `fused_temporal_layer` kernels
    where the JAX package's gate takes its Pallas kernel: never with a mask
    or with `relative_position`, whose tables `rel_k_table` / `rel_v_table`
    stay float32 under `cast_weights`. `tp`: the head split, as in
    CrossAttention; the layer kernel then runs at the local attention width
    (heads * dim_head < C)."""

    float32_params = ("rel_k_table", "rel_v_table")
    tp: Axis = NO_AXIS

    def __init__(self, heads: int, dim_head: int, query_dim: int,
                 relative_position: bool = False, temporal_length: int = 0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.query_dim = heads, dim_head, query_dim
        self.relative_position, self.temporal_length = relative_position, temporal_length
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(query_dim, inner, bias=False)
        self.to_v = nn.Linear(query_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)
        if relative_position:
            self.rel_k_table = nn.Parameter(torch.zeros(2 * temporal_length + 1, dim_head))
            self.rel_v_table = nn.Parameter(torch.zeros(2 * temporal_length + 1, dim_head))

    def forward(self, x, ln: Optional[LayerNormF32] = None, mask=None):
        if self.heads == 0:
            return self.tp.sum(torch.zeros_like(x))
        return self.tp.sum(self._local(x, ln, mask))

    def _local(self, x, ln, mask):
        b, t, s, c = x.shape
        h, d = self.heads, self.dim_head
        inner = h * d
        k2 = v2 = None
        if self.relative_position:
            k2 = _gather_relative(self.rel_k_table, t, t, self.temporal_length)
            v2 = _gather_relative(self.rel_v_table, t, t, self.temporal_length)
        fuse = (
            ln is not None and mask is None and k2 is None
            and self.query_dim == c and x.is_cuda
            and _tlayer.supports_fused_layer(x.shape, h, d, itemsize=x.element_size())
        )
        if fuse:
            wqkv = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight], dim=0)
            return _tlayer.fused_temporal_layer(
                x, ln.weight, ln.bias, wqkv, self.to_out.weight, self.to_out.bias,
                heads=h, dim_head=d)
        if ln is not None:
            x = layer_norm_f32(x, ln.weight, ln.bias)
        q = self.to_q(x).view(b, t, s, h, d)
        k = self.to_k(x).view(b, t, s, h, d)
        v = self.to_v(x).view(b, t, s, h, d)
        o = _temporal_attention(q, k, v, mask, k2=k2, v2=v2)
        return self.to_out(o.reshape(b, t, s, inner))


class TemporalTransformerBlock(nn.Module):
    """TransformerBlock twin for the (B,T,S,C) layout: attn1 and attn2 are
    both self-attention over T."""

    def __init__(self, dim: int, heads: int, dim_head: int, relative_position: bool = False,
                 temporal_length: int = 0):
        super().__init__()
        self.norm1 = LayerNormF32(dim)
        self.attn1 = TemporalSelfAttention(heads, dim_head, dim, relative_position, temporal_length)
        self.norm2 = LayerNormF32(dim)
        self.attn2 = TemporalSelfAttention(heads, dim_head, dim, relative_position, temporal_length)
        self.norm3 = LayerNormF32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, mask=None, cache: AttnCacheCtx = _NO_CACHE, site: str = ""):
        x = x + cache.site("temporal", site + "/attn1",
                           lambda: self.attn1(x, ln=self.norm1, mask=mask))
        x = x + cache.site("temporal", site + "/attn2",
                           lambda: self.attn2(x, ln=self.norm2, mask=mask))
        return x + cache.site("ff", site + "/ff", lambda: self.ff(x, ln=self.norm3))


class TemporalTransformer(nn.Module):
    """Transformer over the t axis per pixel, in the (B, T, S, C) layout;
    `causal`: each frame attends to itself and the frames before it."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int,
                 causal: bool = False, relative_position: bool = False,
                 temporal_length: int = 0):
        super().__init__()
        inner = heads * dim_head
        self.depth, self.causal = depth, causal
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        for i in range(depth):
            self.add_module(f"block_{i}", TemporalTransformerBlock(
                inner, heads, dim_head, relative_position, temporal_length))
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x, cache: AttnCacheCtx = _NO_CACHE, site: str = "",
                frames: Axis = NO_AXIS):
        # x: (B, T, H, W, C); GroupNorm statistics span all frames, so a
        # frame-sharded clip is gathered whole and this rank's block kept
        x = frames.gather(x, 1)
        b, t, hh, ww, c = x.shape
        h = self.proj_in(self.norm(x).reshape(b, t, hh * ww, c))
        mask = None
        if self.causal:
            mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, mask=mask, cache=cache, site=f"{site}/block_{i}")
        h = self.proj_out(h)
        return frames.local(x + h.reshape(b, t, hh, ww, c), 1)


class TemporalConv3(nn.Module):
    """Conv3d((3,1,1)) with torch Conv3d's parameter layout (Cout, Cin, 3, 1,
    1); runs the `temporal_conv3` kernel where the JAX package's gate takes
    its Pallas kernel, else the same arithmetic in plain torch."""

    def __init__(self, channels: int, features: int):
        super().__init__()
        self.features = features
        self.weight = nn.Parameter(torch.zeros(features, channels, 3, 1, 1))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        b, t, hh, ww, c = x.shape
        xf = x.reshape(b, t, hh * ww, c)
        w = _tconv.rows_from_conv3d(self.weight)
        if x.is_cuda and _tconv.supports_fused(xf.shape, c, self.features):
            y = _tconv.temporal_conv3(xf, w, self.bias)
        else:
            y = _tconv.temporal_conv3_plain(xf, w, self.bias)
        return y.reshape(b, t, hh, ww, self.features)


class TemporalConvBlock(nn.Module):
    """4x (GroupNorm -> SiLU -> Conv3d(3,1,1)) residual stack; a
    frame-sharded clip (`frames`) is gathered whole and this rank's block
    kept. `tp`: conv_0 / conv_2 column-parallel, conv_1 / conv_3 row-parallel,
    each of those two followed by one all-reduce."""

    tp: Axis = NO_AXIS

    def __init__(self, channels: int):
        super().__init__()
        for i in range(4):
            self.add_module(f"norm_{i}", GroupNorm32(channels, with_silu=True))
            self.add_module(f"conv_{i}", TemporalConv3(channels, channels))

    def forward(self, x, frames: Axis = NO_AXIS):
        x = frames.gather(x, 1)
        h = x
        for i in range(4):
            h = getattr(self, f"conv_{i}")(getattr(self, f"norm_{i}")(h))
            if i % 2:
                h = self.tp.sum(h)
        return frames.local(x + h, 1)


class ResBlock(nn.Module):
    """GN-SiLU-conv, +time-emb, GN-SiLU-conv, skip; then temporal convs.
    `tp`: in_conv and emb_proj column-parallel, out_conv row-parallel and
    one all-reduce after it."""

    tp: Axis = NO_AXIS

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int, use_temporal_conv: bool):
        super().__init__()
        self.in_norm = GroupNorm32(in_ch, with_silu=True)
        self.in_conv = Conv(in_ch, out_ch, 3, padding=1)
        self.emb_proj = nn.Linear(emb_dim, out_ch)
        self.out_norm = GroupNorm32(out_ch, with_silu=True)
        self.out_conv = Conv(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.skip = Conv(in_ch, out_ch, 1)
        if use_temporal_conv:
            self.temporal_conv = TemporalConvBlock(out_ch)

    def forward(self, x, emb, batch_size: int, frames: Axis = NO_AXIS):
        # x: (BT, H, W, C); emb: (BT, D)
        h = self.in_conv(self.in_norm(x))
        h = h + self.emb_proj(silu(emb))[:, None, None, :].to(h.dtype)
        h = self.tp.sum(self.out_conv(self.out_norm(h)))
        if hasattr(self, "skip"):
            x = self.skip(x)
        h = x + h
        if hasattr(self, "temporal_conv"):
            bt, hh, ww, c = h.shape
            hv = self.temporal_conv(h.reshape(batch_size, bt // batch_size, hh, ww, c), frames)
            h = hv.reshape(bt, hh, ww, c)
        return h


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        # explicit (1,1) padding: torch stride-2 pad-1 conv semantics
        self.op = Conv(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


class UNet3D(nn.Module):
    """Full denoiser. x: (B, T, H, W, in_channels), the noisy latent
    channel-concatenated with the guidance latent. Returns the v-prediction
    (B, T, H, W, out_channels) in float32.

    cross_attn_impl, gn_fused: the two opt-in kernel routes (module
    docstring); the defaults are the JAX package's. remat: per-block
    gradient checkpointing (module docstring), off by default as in the JAX
    package."""

    def __init__(self, cfg: UNetConfig, dtype: torch.dtype = torch.bfloat16,
                 cross_attn_impl: str = "xla", gn_fused: bool = False, remat: bool = False):
        super().__init__()
        if cross_attn_impl not in ("xla", "auto"):
            raise ValueError(f"unknown cross_attn_impl {cross_attn_impl!r}")
        self.cfg, self.dtype, self.remat = cfg, dtype, remat
        mc = cfg.model_channels
        ted = mc * 4
        nhc = cfg.num_head_channels
        self.time_embed_0 = nn.Linear(mc, ted)
        self.time_embed_2 = nn.Linear(ted, ted)
        if cfg.fs_condition:
            self.fps_embed_0 = nn.Linear(mc, ted)
            self.fps_embed_2 = nn.Linear(ted, ted)
        self.in_conv = Conv(cfg.in_channels, mc, 3, padding=1)

        def temporal(ch, heads=None):
            return TemporalTransformer(ch, heads or ch // nhc, nhc, cfg.transformer_depth,
                                       causal=cfg.use_causal_attention,
                                       relative_position=cfg.use_relative_position,
                                       temporal_length=cfg.temporal_length)

        def spatial(ch):
            return SpatialTransformer(ch, ch // nhc, nhc, cfg.transformer_depth,
                                      cfg.context_dim, cfg.image_cross_attention,
                                      cross_attn_impl)

        def res(cin, cout):
            return ResBlock(cin, cout, ted, cfg.temporal_conv)

        if cfg.addition_attention:
            self.init_attn = temporal(mc, heads=8)
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for j in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_{j}_res", res(ch, mult * mc))
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    self.add_module(f"down_{level}_{j}_spatial", spatial(ch))
                    if cfg.temporal_attention:
                        self.add_module(f"down_{level}_{j}_temporal", temporal(ch))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.add_module(f"down_{level}_downsample", Downsample(ch))
                chans.append(ch)
                ds *= 2
        self.mid_res1 = res(ch, ch)
        self.mid_spatial = spatial(ch)
        if cfg.temporal_attention:
            self.mid_temporal = temporal(ch)
        self.mid_res2 = res(ch, ch)
        for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
            for j in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{level}_{j}_res", res(ch + chans.pop(), mult * mc))
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    self.add_module(f"up_{level}_{j}_spatial", spatial(ch))
                    if cfg.temporal_attention:
                        self.add_module(f"up_{level}_{j}_temporal", temporal(ch))
                if level and j == cfg.num_res_blocks:
                    self.add_module(f"up_{level}_upsample", Upsample(ch))
                    ds //= 2
        self.out_norm = GroupNorm32(mc, with_silu=True)
        self.out_conv = Conv(mc, cfg.out_channels, 3, padding=1)
        set_group_norm_fused(self, gn_fused)

    def forward(self, x, timesteps, context, fs=None, attn_cache=None,
                collect_cache: bool = False,
                cache_kinds=("spatial", "cross", "temporal"), cache_dtype=None,
                shared_prefix: int = 1, frames: Axis = NO_AXIS):
        """attn_cache / collect_cache: PAB-style attention-output reuse (see
        AttnCacheCtx). attn_cache is a dict of site name -> tensor consumed
        instead of computing those sites; collect_cache=True returns
        (y, {site: output}) for the caller to feed to the next step;
        cache_kinds picks the site families and cache_dtype the storage type.
        Both off: the baseline pass.

        shared_prefix=K asserts that the K leading-axis guidance branches of
        x / timesteps / fs are identical (the batched-CFG layout; only
        `context` differs per branch). The context-free prefix of the net,
        up to the first cross-attention, then runs once at batch B/K and is
        replicated there: the same output for less work. Off whenever a
        cache is read or collected, and under remat, as in the JAX package.

        frames: the "sp" axis when x holds this rank's block of the clip's
        frames (module docstring); `context` then still covers the whole
        clip, and its per-frame image tokens are sliced to the block."""
        cache = _NO_CACHE
        if attn_cache is not None or collect_cache:
            cache = AttnCacheCtx(
                reads=attn_cache, collect=collect_cache, spatial="spatial" in cache_kinds,
                cross="cross" in cache_kinds, temporal="temporal" in cache_kinds,
                ff="ff" in cache_kinds, store_dtype=cache_dtype, compute_dtype=self.dtype)
        cfg, dtype = self.cfg, self.dtype
        b, t, hh, ww, _ = x.shape
        mc = cfg.model_channels

        # --- embeddings -----------------------------------------------------
        emb = self.time_embed_0(timestep_embedding(timesteps.float(), mc).to(dtype))
        emb = self.time_embed_2(silu(emb))
        if cfg.fs_condition:
            if fs is None:
                fs = torch.full((b,), float(cfg.default_fs), device=x.device)
            fs_emb = self.fps_embed_0(timestep_embedding(fs.float(), mc).to(dtype))
            emb = emb + self.fps_embed_2(silu(fs_emb))
        emb = emb.repeat_interleave(t, dim=0)  # (B*T, ted)

        # --- context: per-frame image tokens when L == 77 + 16*T -------------
        tcl = cfg.text_context_len
        t_all = t * frames.size
        if context.shape[1] == tcl + t_all * 16:
            ctx_text = context[:, :tcl].repeat_interleave(t, dim=0)
            ctx_img = context[:, tcl:].reshape(b, t_all, 16, context.shape[-1])
            ctx_img = ctx_img[:, frames.block(t_all)].reshape(b * t, 16, context.shape[-1])
            ctx = torch.cat([ctx_text, ctx_img], dim=1)
        else:
            ctx = context.repeat_interleave(t, dim=0)
        ctx = ctx.to(dtype)

        h = x.reshape(b * t, hh, ww, x.shape[-1]).to(dtype)

        # gradient checkpointing: only the cache-free call is wrapped (so the
        # dedup below is off under it and every block sees tile_k = 1)
        use_remat = self.remat and cache is _NO_CACHE

        def call(mod, *args, **kw):
            if use_remat:
                return checkpoint(mod, *args, use_reentrant=False, **kw)
            return mod(*args, **kw)

        # CFG-prefix dedup: run the context-independent prefix once for the K
        # identical guidance branches, replicate at the first cross-attention
        k_sh = shared_prefix
        if k_sh > 1 and (b % k_sh or cache is not _NO_CACHE or use_remat):
            k_sh = 1
        state = {"b": b // k_sh, "tiled": k_sh == 1}
        if k_sh > 1:
            h = h[: state["b"] * t]

        def cur_emb():
            return emb if state["tiled"] else emb[: state["b"] * t]

        def run_res(name, h):
            return call(getattr(self, name), h, cur_emb(), state["b"], frames)

        def run_spatial(name, h):
            tk = 1 if state["tiled"] else k_sh
            out = call(getattr(self, name), h, ctx, cache=cache, site=name, tile_k=tk)
            if tk > 1:
                state["b"], state["tiled"] = b, True
            return out

        def run_temporal(name, h):
            bt, sh, sw, c = h.shape
            hv = h.reshape(state["b"], t, sh, sw, c)
            return call(getattr(self, name), hv, cache=cache, site=name,
                        frames=frames).reshape(bt, sh, sw, c)

        def pop_skip(h):
            skip = hs.pop()
            if skip.shape[0] != h.shape[0]:  # pushed before the dedup tile point
                skip = skip.repeat(k_sh, 1, 1, 1)
            return torch.cat([h, skip], dim=-1)

        # --- input blocks ----------------------------------------------------
        hs = []
        h = self.in_conv(h)
        if cfg.addition_attention:
            h = run_temporal("init_attn", h)
        hs.append(h)
        ds = 1
        for level, _ in enumerate(cfg.channel_mult):
            for j in range(cfg.num_res_blocks):
                h = run_res(f"down_{level}_{j}_res", h)
                if ds in cfg.attention_resolutions:
                    h = run_spatial(f"down_{level}_{j}_spatial", h)
                    if cfg.temporal_attention:
                        h = run_temporal(f"down_{level}_{j}_temporal", h)
                hs.append(h)
            if level != len(cfg.channel_mult) - 1:
                h = getattr(self, f"down_{level}_downsample")(h)
                hs.append(h)
                ds *= 2

        # --- middle ----------------------------------------------------------
        h = run_res("mid_res1", h)
        h = run_spatial("mid_spatial", h)
        if cfg.temporal_attention:
            h = run_temporal("mid_temporal", h)
        h = run_res("mid_res2", h)

        # --- output blocks ---------------------------------------------------
        for level, _ in list(enumerate(cfg.channel_mult))[::-1]:
            for j in range(cfg.num_res_blocks + 1):
                h = run_res(f"up_{level}_{j}_res", pop_skip(h))
                if ds in cfg.attention_resolutions:
                    h = run_spatial(f"up_{level}_{j}_spatial", h)
                    if cfg.temporal_attention:
                        h = run_temporal(f"up_{level}_{j}_temporal", h)
                if level and j == cfg.num_res_blocks:
                    h = getattr(self, f"up_{level}_upsample")(h)
                    ds //= 2

        h = self.out_conv(self.out_norm(h))
        if not state["tiled"]:  # degenerate config with no spatial transformer
            h = h.repeat(k_sh, 1, 1, 1)
        y = h.reshape(b, t, hh, ww, cfg.out_channels).float()
        if collect_cache:
            return y, cache.writes
        return y

