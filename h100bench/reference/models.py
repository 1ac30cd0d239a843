"""The networks of ViewCrafter's diffusion stage in plain float32 PyTorch.

Written from the published architecture (DynamiCrafter's
`lvdm/modules/networks/openaimodel3d.py`, `attention.py`, `ae_modules.py`,
`encoders/condition.py` and `resampler.py`, as `configs/inference_pvd_*.yaml`
instantiates them). Tensors are channels-last: images (N, H, W, C), videos
(B, T, H, W, C), tokens (N, S, C). Parameter names are the program's
state-dict keys. Every product goes through the `Numerics` the module is
given (`numerics.py`); GroupNorm, LayerNorm, softmax, SiLU and GELU are
float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .numerics import Numerics


class Ctx:
    """What every module reads: the arithmetic of its products."""

    def __init__(self, num: Numerics):
        self.num = num


def _p(*shape):
    return nn.Parameter(torch.empty(*shape))


class Norm(nn.Module):
    """A norm's scale and shift; `group_norm` / `layer_norm` apply them."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = _p(channels)
        self.bias = _p(channels)


def group_norm(x, norm: Norm, groups: int, eps: float, silu: bool):
    """Statistics over every axis but the first, per group of channels."""
    shape = x.shape
    c = shape[-1]
    xs = x.float().reshape(shape[0], -1, groups, c // groups)
    mean = xs.mean(dim=(1, 3), keepdim=True)
    var = (xs - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xs - mean) / torch.sqrt(var + eps)).reshape(shape) * norm.weight + norm.bias
    return F.silu(y) if silu else y


def layer_norm(x, norm: Norm, eps: float = 1e-5):
    return F.layer_norm(x.float(), x.shape[-1:], norm.weight.float(), norm.bias.float(), eps)


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = _p(cout, cin)
        self.bias = _p(cout) if bias else None

    def __call__(self, ctx: Ctx, x):
        return ctx.num.linear(x, self.weight, self.bias)


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = _p(cout, cin, k, k)
        self.bias = _p(cout) if bias else None

    def __call__(self, ctx: Ctx, x):
        return ctx.num.conv2d(x, self.weight, self.bias, self.stride, self.padding)


# ---------------------------------------------------------------------------
# UNet3D
# ---------------------------------------------------------------------------


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """[cos | sin] sinusoidal embedding of t (N,) -> (N, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class Cache:
    """Attention-output reuse (Pyramid Attention Broadcast): `collect` keeps
    the outputs of a full step's sites; `reads` gives them back on a reuse
    step, in place of computing those sites. `kinds`: the site families;
    `sites`: the name prefixes kept (all when empty)."""

    def __init__(self, kinds=(), reads=None, collect=False, sites=()):
        self.kinds, self.reads, self.sites = tuple(kinds), reads or {}, tuple(sites)
        self.writes = {} if collect else None

    def site(self, kind, name, compute):
        if kind in self.kinds and name in self.reads:
            out = self.reads[name]
        else:
            out = compute()
        if (self.writes is not None and kind in self.kinds
                and (not self.sites or name.startswith(self.sites))):
            self.writes[name] = out
        return out


NO_CACHE = Cache()


class CrossAttention(nn.Module):
    """Self-attention, or cross-attention to text tokens plus (dual stream)
    image tokens: out = attn(q, k, v) + attn(q, k_ip, v_ip)."""

    def __init__(self, heads, dim_head, query_dim, context_dim=None, image=False, text_len=77):
        super().__init__()
        inner, kv = heads * dim_head, context_dim or query_dim
        self.heads, self.dim_head, self.image, self.text_len = heads, dim_head, image, text_len
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(kv, inner, bias=False)
        self.to_v = Linear(kv, inner, bias=False)
        if image:
            self.to_k_ip = Linear(kv, inner, bias=False)
            self.to_v_ip = Linear(kv, inner, bias=False)
        self.to_out = Linear(inner, query_dim)

    def __call__(self, ctx: Ctx, x, context=None):
        n, s, _ = x.shape
        h, d = self.heads, self.dim_head
        q = self.to_q(ctx, x).view(n, s, h, d)
        src, img = x, None
        if context is not None:
            src = context[:, :self.text_len]
            img = context[:, self.text_len:] if self.image else None
        k = self.to_k(ctx, src).view(n, -1, h, d)
        v = self.to_v(ctx, src).view(n, -1, h, d)
        out = ctx.num.attention(q, k, v).reshape(n, s, h * d)
        if img is not None:
            k2 = self.to_k_ip(ctx, img).view(n, -1, h, d)
            v2 = self.to_v_ip(ctx, img).view(n, -1, h, d)
            out = out + ctx.num.attention(q, k2, v2).reshape(n, s, h * d)
        return self.to_out(ctx, out)


class FeedForward(nn.Module):
    """LayerNorm'd input -> Linear(dim, 2*inner) -> h * GELU(gate) -> Linear."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.geglu = nn.Module()
        self.geglu.proj = Linear(dim, 2 * dim * mult)
        self.out = Linear(dim * mult, dim)

    def __call__(self, ctx: Ctx, x):
        h, gate = self.geglu.proj(ctx, x).chunk(2, dim=-1)
        return self.out(ctx, h * F.gelu(gate))


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim, image):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = Norm(dim), Norm(dim), Norm(dim)
        self.attn1 = CrossAttention(heads, dim_head, dim)
        self.attn2 = CrossAttention(heads, dim_head, dim, context_dim, image)
        self.ff = FeedForward(dim)

    def __call__(self, ctx, x, context, cache, site):
        x = x + cache.site("spatial", site + "/attn1",
                           lambda: self.attn1(ctx, layer_norm(x, self.norm1)))
        x = x + cache.site("cross", site + "/attn2",
                           lambda: self.attn2(ctx, layer_norm(x, self.norm2), context))
        return x + cache.site("ff", site + "/ff", lambda: self.ff(ctx, layer_norm(x, self.norm3)))


class SpatialTransformer(nn.Module):
    def __init__(self, channels, heads, dim_head, depth, context_dim, image):
        super().__init__()
        inner = heads * dim_head
        self.depth = depth
        self.norm = Norm(channels)
        self.proj_in = Linear(channels, inner)
        for i in range(depth):
            self.add_module(f"block_{i}", TransformerBlock(inner, heads, dim_head, context_dim,
                                                           image))
        self.proj_out = Linear(inner, channels)

    def __call__(self, ctx, x, context, cache, site):
        n, hh, ww, c = x.shape
        h = self.proj_in(ctx, group_norm(x, self.norm, 32, 1e-6, False).reshape(n, hh * ww, c))
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(ctx, h, context, cache, f"{site}/block_{i}")
        return x + self.proj_out(ctx, h).reshape(n, hh, ww, c)


class TemporalAttention(nn.Module):
    """Self-attention over the frames of each pixel: (B, T, S, C)."""

    def __init__(self, heads, dim_head, dim):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(dim, inner, bias=False)
        self.to_v = Linear(dim, inner, bias=False)
        self.to_out = Linear(inner, dim)

    def __call__(self, ctx, x, mask=None):
        b, t, s, _ = x.shape
        h, d = self.heads, self.dim_head

        def heads_of(lin):  # (B, T, S, C) -> (B*S, T, H, D)
            return lin(ctx, x).view(b, t, s, h, d).transpose(1, 2).reshape(b * s, t, h, d)

        o = ctx.num.attention(heads_of(self.to_q), heads_of(self.to_k), heads_of(self.to_v),
                              mask)
        o = o.reshape(b, s, t, h * d).transpose(1, 2)
        return self.to_out(ctx, o)


class TemporalBlock(nn.Module):
    def __init__(self, dim, heads, dim_head):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = Norm(dim), Norm(dim), Norm(dim)
        self.attn1 = TemporalAttention(heads, dim_head, dim)
        self.attn2 = TemporalAttention(heads, dim_head, dim)
        self.ff = FeedForward(dim)

    def __call__(self, ctx, x, mask, cache, site):
        x = x + cache.site("temporal", site + "/attn1",
                           lambda: self.attn1(ctx, layer_norm(x, self.norm1), mask))
        x = x + cache.site("temporal", site + "/attn2",
                           lambda: self.attn2(ctx, layer_norm(x, self.norm2), mask))
        return x + cache.site("ff", site + "/ff", lambda: self.ff(ctx, layer_norm(x, self.norm3)))


class TemporalTransformer(nn.Module):
    def __init__(self, channels, heads, dim_head, depth, causal):
        super().__init__()
        inner = heads * dim_head
        self.depth, self.causal = depth, causal
        self.norm = Norm(channels)
        self.proj_in = Linear(channels, inner)
        for i in range(depth):
            self.add_module(f"block_{i}", TemporalBlock(inner, heads, dim_head))
        self.proj_out = Linear(inner, channels)

    def __call__(self, ctx, x, cache, site):
        b, t, hh, ww, c = x.shape
        h = self.proj_in(ctx, group_norm(x, self.norm, 32, 1e-6, False).reshape(b, t, hh * ww, c))
        mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril() if self.causal else None
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(ctx, h, mask, cache, f"{site}/block_{i}")
        return x + self.proj_out(ctx, h).reshape(b, t, hh, ww, c)


class TemporalConv3(nn.Module):
    """Conv3d with kernel (3, 1, 1) and zero padding 1 over the frames."""

    def __init__(self, channels):
        super().__init__()
        self.weight = _p(channels, channels, 3, 1, 1)
        self.bias = _p(channels)

    def __call__(self, ctx, x):
        xp = F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))
        t = x.shape[1]
        w = self.weight[:, :, :, 0, 0]
        y = sum(ctx.num.linear(xp[:, dt:dt + t], w[:, :, dt]) for dt in range(3))
        return y + self.bias.float()


class TemporalConvBlock(nn.Module):
    def __init__(self, channels):
        super().__init__()
        for i in range(4):
            self.add_module(f"norm_{i}", Norm(channels))
            self.add_module(f"conv_{i}", TemporalConv3(channels))

    def __call__(self, ctx, x):
        h = x
        for i in range(4):
            h = getattr(self, f"conv_{i}")(ctx, group_norm(h, getattr(self, f"norm_{i}"), 32,
                                                         1e-5, True))
        return x + h


class ResBlock(nn.Module):
    def __init__(self, cin, cout, emb_dim, temporal_conv):
        super().__init__()
        self.in_norm = Norm(cin)
        self.in_conv = Conv(cin, cout, 3, padding=1)
        self.emb_proj = Linear(emb_dim, cout)
        self.out_norm = Norm(cout)
        self.out_conv = Conv(cout, cout, 3, padding=1)
        if cin != cout:
            self.skip = Conv(cin, cout, 1)
        if temporal_conv:
            self.temporal_conv = TemporalConvBlock(cout)

    def __call__(self, ctx, x, emb, b):
        h = self.in_conv(ctx, group_norm(x, self.in_norm, 32, 1e-5, True))
        h = h + self.emb_proj(ctx, F.silu(emb))[:, None, None, :]
        h = self.out_conv(ctx, group_norm(h, self.out_norm, 32, 1e-5, True))
        h = (self.skip(ctx, x) if hasattr(self, "skip") else x) + h
        if hasattr(self, "temporal_conv"):
            n, hh, ww, c = h.shape
            h = self.temporal_conv(ctx, h.reshape(b, n // b, hh, ww, c)).reshape(n, hh, ww, c)
        return h


class Down(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.op = Conv(ch, ch, 3, stride=2, padding=1)


class Up(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv(ch, ch, 3, padding=1)


def upsample2(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class UNet3D(nn.Module):
    """x (B, T, H, W, in_channels): the noisy latent and the guidance latent
    concatenated on channels; t (B,); context (B, L, context_dim); fs (B,).
    Returns the v-prediction (B, T, H, W, out_channels)."""

    def __init__(self, u: dict):
        super().__init__()
        self.u = u
        mc, nhc = u["model_channels"], u["num_head_channels"]
        ted = 4 * mc
        self.time_embed_0, self.time_embed_2 = Linear(mc, ted), Linear(ted, ted)
        if u["fs_condition"]:
            self.fps_embed_0, self.fps_embed_2 = Linear(mc, ted), Linear(ted, ted)
        self.in_conv = Conv(u["in_channels"], mc, 3, padding=1)

        def temporal(ch, heads=None):
            return TemporalTransformer(ch, heads or ch // nhc, nhc, u["transformer_depth"],
                                       u["use_causal_attention"])

        def spatial(ch):
            return SpatialTransformer(ch, ch // nhc, nhc, u["transformer_depth"],
                                      u["context_dim"], u["image_cross_attention"])

        def res(cin, cout):
            return ResBlock(cin, cout, ted, u["temporal_conv"])

        if u["addition_attention"]:
            self.init_attn = temporal(mc, heads=8)
        chans, ch, ds = [mc], mc, 1
        mult = u["channel_mult"]
        for level, m in enumerate(mult):
            for j in range(u["num_res_blocks"]):
                self.add_module(f"down_{level}_{j}_res", res(ch, m * mc))
                ch = m * mc
                if ds in u["attention_resolutions"]:
                    self.add_module(f"down_{level}_{j}_spatial", spatial(ch))
                    if u["temporal_attention"]:
                        self.add_module(f"down_{level}_{j}_temporal", temporal(ch))
                chans.append(ch)
            if level != len(mult) - 1:
                self.add_module(f"down_{level}_downsample", Down(ch))
                chans.append(ch)
                ds *= 2
        self.mid_res1 = res(ch, ch)
        self.mid_spatial = spatial(ch)
        if u["temporal_attention"]:
            self.mid_temporal = temporal(ch)
        self.mid_res2 = res(ch, ch)
        for level, m in list(enumerate(mult))[::-1]:
            for j in range(u["num_res_blocks"] + 1):
                self.add_module(f"up_{level}_{j}_res", res(ch + chans.pop(), m * mc))
                ch = m * mc
                if ds in u["attention_resolutions"]:
                    self.add_module(f"up_{level}_{j}_spatial", spatial(ch))
                    if u["temporal_attention"]:
                        self.add_module(f"up_{level}_{j}_temporal", temporal(ch))
                if level and j == u["num_res_blocks"]:
                    self.add_module(f"up_{level}_upsample", Up(ch))
                    ds //= 2
        self.out_norm = Norm(mc)
        self.out_conv = Conv(mc, u["out_channels"], 3, padding=1)

    def __call__(self, ctx: Ctx, x, t, context, fs, cache: Cache = NO_CACHE):
        u = self.u
        b, nt, hh, ww, _ = x.shape
        mc = u["model_channels"]
        emb = self.time_embed_2(ctx, F.silu(self.time_embed_0(ctx, timestep_embedding(t, mc))))
        if u["fs_condition"]:
            emb = emb + self.fps_embed_2(ctx, F.silu(self.fps_embed_0(ctx,
                                                                       timestep_embedding(fs, mc))))
        emb = emb.repeat_interleave(nt, dim=0)
        tl = u["text_context_len"]
        if context.shape[1] == tl + nt * 16:  # 16 image tokens per frame
            img = context[:, tl:].reshape(b * nt, 16, context.shape[-1])
            context = torch.cat([context[:, :tl].repeat_interleave(nt, dim=0), img], dim=1)
        else:
            context = context.repeat_interleave(nt, dim=0)

        def run(name, h):
            mod = getattr(self, name)
            if isinstance(mod, ResBlock):
                return mod(ctx, h, emb, b)
            if isinstance(mod, SpatialTransformer):
                return mod(ctx, h, context, cache, name)
            n, sh, sw, c = h.shape
            return mod(ctx, h.reshape(b, nt, sh, sw, c), cache, name).reshape(n, sh, sw, c)

        h = self.in_conv(ctx, x.reshape(b * nt, hh, ww, -1))
        if u["addition_attention"]:
            h = run("init_attn", h)
        hs, ds = [h], 1
        mult = u["channel_mult"]
        for level in range(len(mult)):
            for j in range(u["num_res_blocks"]):
                h = run(f"down_{level}_{j}_res", h)
                if ds in u["attention_resolutions"]:
                    h = run(f"down_{level}_{j}_spatial", h)
                    if u["temporal_attention"]:
                        h = run(f"down_{level}_{j}_temporal", h)
                hs.append(h)
            if level != len(mult) - 1:
                h = getattr(self, f"down_{level}_downsample").op(ctx, h)
                hs.append(h)
                ds *= 2
        h = run("mid_res1", h)
        h = run("mid_spatial", h)
        if u["temporal_attention"]:
            h = run("mid_temporal", h)
        h = run("mid_res2", h)
        for level in reversed(range(len(mult))):
            for j in range(u["num_res_blocks"] + 1):
                h = run(f"up_{level}_{j}_res", torch.cat([h, hs.pop()], dim=-1))
                if ds in u["attention_resolutions"]:
                    h = run(f"up_{level}_{j}_spatial", h)
                    if u["temporal_attention"]:
                        h = run(f"up_{level}_{j}_temporal", h)
                if level and j == u["num_res_blocks"]:
                    h = getattr(self, f"up_{level}_upsample").conv(ctx, upsample2(h))
                    ds //= 2
        h = self.out_conv(ctx, group_norm(h, self.out_norm, 32, 1e-5, True))
        return h.reshape(b, nt, hh, ww, -1)


# ---------------------------------------------------------------------------
# KL-VAE
# ---------------------------------------------------------------------------


class VaeRes(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1, self.conv1 = Norm(cin), Conv(cin, cout, 3, padding=1)
        self.norm2, self.conv2 = Norm(cout), Conv(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = Conv(cin, cout, 1)

    def __call__(self, ctx, x):
        h = self.conv1(ctx, group_norm(x, self.norm1, 32, 1e-6, True))
        h = self.conv2(ctx, group_norm(h, self.norm2, 32, 1e-6, True))
        return (self.nin_shortcut(ctx, x) if hasattr(self, "nin_shortcut") else x) + h


class VaeAttn(nn.Module):
    """One head over the whole grid, d = channels."""

    def __init__(self, c):
        super().__init__()
        self.norm = Norm(c)
        self.q, self.k, self.v, self.proj_out = (Conv(c, c, 1) for _ in range(4))

    def __call__(self, ctx, x):
        n, h, w, c = x.shape
        y = group_norm(x, self.norm, 32, 1e-6, False)
        q, k, v = (m(ctx, y).reshape(n, h * w, 1, c) for m in (self.q, self.k, self.v))
        return x + self.proj_out(ctx, ctx.num.attention(q, k, v).reshape(n, h, w, c))


class VaeDown(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv(ch, ch, 3, stride=2)


class Encoder(nn.Module):
    def __init__(self, ch, mult, nres, z):
        super().__init__()
        self.mult, self.nres = mult, nres
        self.conv_in = Conv(3, ch, 3, padding=1)
        cin = ch
        for i, m in enumerate(mult):
            for j in range(nres):
                self.add_module(f"down_{i}_block_{j}", VaeRes(cin, ch * m))
                cin = ch * m
            if i != len(mult) - 1:
                self.add_module(f"down_{i}_downsample", VaeDown(cin))
        self.mid_block_1, self.mid_attn_1, self.mid_block_2 = (VaeRes(cin, cin), VaeAttn(cin),
                                                               VaeRes(cin, cin))
        self.norm_out = Norm(cin)
        self.conv_out = Conv(cin, 2 * z, 3, padding=1)

    def __call__(self, ctx, x):
        h = self.conv_in(ctx, x)
        for i in range(len(self.mult)):
            for j in range(self.nres):
                h = getattr(self, f"down_{i}_block_{j}")(ctx, h)
            if i != len(self.mult) - 1:
                h = getattr(self, f"down_{i}_downsample").conv(ctx, F.pad(h, (0, 0, 0, 1, 0, 1)))
        h = self.mid_block_2(ctx, self.mid_attn_1(ctx, self.mid_block_1(ctx, h)))
        return self.conv_out(ctx, group_norm(h, self.norm_out, 32, 1e-6, True))


class Decoder(nn.Module):
    def __init__(self, ch, mult, nres, z):
        super().__init__()
        self.mult, self.nres = mult, nres
        cin = ch * mult[-1]
        self.conv_in = Conv(z, cin, 3, padding=1)
        self.mid_block_1, self.mid_attn_1, self.mid_block_2 = (VaeRes(cin, cin), VaeAttn(cin),
                                                               VaeRes(cin, cin))
        for i in reversed(range(len(mult))):
            for j in range(nres + 1):
                self.add_module(f"up_{i}_block_{j}", VaeRes(cin, ch * mult[i]))
                cin = ch * mult[i]
            if i != 0:
                self.add_module(f"up_{i}_upsample", Up(cin))
        self.norm_out = Norm(cin)
        self.conv_out = Conv(cin, 3, 3, padding=1)

    def __call__(self, ctx, z):
        h = self.conv_in(ctx, z)
        h = self.mid_block_2(ctx, self.mid_attn_1(ctx, self.mid_block_1(ctx, h)))
        for i in reversed(range(len(self.mult))):
            for j in range(self.nres + 1):
                h = getattr(self, f"up_{i}_block_{j}")(ctx, h)
            if i != 0:
                h = getattr(self, f"up_{i}_upsample").conv(ctx, upsample2(h))
        return self.conv_out(ctx, group_norm(h, self.norm_out, 32, 1e-6, True))


class AutoencoderKL(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        mult = tuple(v["ch_mult"])
        self.encoder = Encoder(v["ch"], mult, v["num_res_blocks"], v["z_channels"])
        self.decoder = Decoder(v["ch"], mult, v["num_res_blocks"], v["z_channels"])
        self.quant_conv = Conv(2 * v["z_channels"], 2 * v["embed_dim"], 1)
        self.post_quant_conv = Conv(v["embed_dim"], v["z_channels"], 1)

    def encode(self, ctx, x, noise):
        """Image (N, H, W, 3) in [-1, 1] -> posterior sample mean + std * noise."""
        mean, logvar = self.quant_conv(ctx, self.encoder(ctx, x)).chunk(2, dim=-1)
        return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise

    def decode(self, ctx, z):
        return self.decoder(ctx, self.post_quant_conv(ctx, z))


# ---------------------------------------------------------------------------
# OpenCLIP ViT-H/14 towers and the resampler
# ---------------------------------------------------------------------------


class ClipBlock(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.ln_1, self.ln_2 = Norm(width), Norm(width)
        self.in_proj = Linear(width, 3 * width)
        self.out_proj = Linear(width, width)
        self.c_fc = Linear(width, 4 * width)
        self.c_proj = Linear(4 * width, width)

    def __call__(self, ctx, x, mask=None):
        n, s, c = x.shape
        h, d = self.heads, c // self.heads
        q, k, v = (a.reshape(n, s, h, d)
                   for a in self.in_proj(ctx, layer_norm(x, self.ln_1)).chunk(3, dim=-1))
        x = x + self.out_proj(ctx, ctx.num.attention(q, k, v, mask).reshape(n, s, c))
        return x + self.c_proj(ctx, F.gelu(self.c_fc(ctx, layer_norm(x, self.ln_2))))


class ClipText(nn.Module):
    """Token ids (N, 77) -> (N, 77, width): the penultimate block's output
    through ln_final."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.token_embedding = nn.Module()
        self.token_embedding.weight = _p(c["vocab_size"], c["width"])
        self.positional_embedding = _p(c["context_length"], c["width"])
        for i in range(c["layers"]):
            self.add_module(f"block_{i}", ClipBlock(c["width"], c["heads"]))
        self.ln_final = Norm(c["width"])

    def __call__(self, ctx, ids):
        c = self.c
        x = self.token_embedding.weight[ids].float() + self.positional_embedding
        n = c["context_length"]
        causal = torch.ones(n, n, dtype=torch.bool, device=ids.device).tril()
        for i in range(c["layers"] - (1 if c["penultimate"] else 0)):
            x = getattr(self, f"block_{i}")(ctx, x, causal)
        return layer_norm(x, self.ln_final)


class ClipVision(nn.Module):
    """Preprocessed images (N, 224, 224, 3) -> all (N, 257, width) tokens
    before the pool, without ln_post."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        grid = c["image_size"] // c["patch_size"]
        self.conv1 = Conv(3, c["width"], c["patch_size"], stride=c["patch_size"], bias=False)
        self.class_embedding = _p(c["width"])
        self.positional_embedding = _p(grid * grid + 1, c["width"])
        self.ln_pre = Norm(c["width"])
        for i in range(c["layers"]):
            self.add_module(f"block_{i}", ClipBlock(c["width"], c["heads"]))

    def __call__(self, ctx, x):
        n, w = x.shape[0], self.c["width"]
        h = self.conv1(ctx, x).reshape(n, -1, w)
        h = torch.cat([self.class_embedding.float().expand(n, 1, w), h], dim=1)
        h = layer_norm(h + self.positional_embedding, self.ln_pre)
        for i in range(self.c["layers"]):
            h = getattr(self, f"block_{i}")(ctx, h)
        return h


class PerceiverAttention(nn.Module):
    def __init__(self, dim, heads, dim_head):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.norm1, self.norm2 = Norm(dim), Norm(dim)
        self.to_q = Linear(dim, heads * dim_head, bias=False)
        self.to_kv = Linear(dim, 2 * heads * dim_head, bias=False)
        self.to_out = Linear(heads * dim_head, dim, bias=False)

    def __call__(self, ctx, x, lat):
        x, lat = layer_norm(x, self.norm1), layer_norm(lat, self.norm2)
        n, l, _ = lat.shape
        h, d = self.heads, self.dim_head
        q = self.to_q(ctx, lat).reshape(n, l, h, d)
        k, v = self.to_kv(ctx, torch.cat([x, lat], dim=1)).chunk(2, dim=-1)
        o = ctx.num.attention(q, k.reshape(n, -1, h, d), v.reshape(n, -1, h, d))
        return self.to_out(ctx, o.reshape(n, l, h * d))


class ResamplerFF(nn.Module):
    def __init__(self, dim, mult):
        super().__init__()
        self.norm = Norm(dim)
        self.fc1 = Linear(dim, dim * mult, bias=False)
        self.fc2 = Linear(dim * mult, dim, bias=False)

    def __call__(self, ctx, x):
        return self.fc2(ctx, F.gelu(self.fc1(ctx, layer_norm(x, self.norm))))


class Resampler(nn.Module):
    def __init__(self, r: dict):
        super().__init__()
        self.r = r
        nq = r["num_queries"] * (r["video_length"] or 1)
        self.latents = _p(1, nq, r["dim"])
        self.proj_in = Linear(r["embedding_dim"], r["dim"])
        for i in range(r["depth"]):
            self.add_module(f"layer_{i}_attn", PerceiverAttention(r["dim"], r["heads"],
                                                                  r["dim_head"]))
            self.add_module(f"layer_{i}_ff", ResamplerFF(r["dim"], r["ff_mult"]))
        self.proj_out = Linear(r["dim"], r["output_dim"])
        self.norm_out = Norm(r["output_dim"])

    def __call__(self, ctx, x):
        lat = self.latents.float().expand(x.shape[0], -1, -1)
        h = self.proj_in(ctx, x)
        for i in range(self.r["depth"]):
            lat = lat + getattr(self, f"layer_{i}_attn")(ctx, h, lat)
            lat = lat + getattr(self, f"layer_{i}_ff")(ctx, lat)
        return layer_norm(self.proj_out(ctx, lat), self.norm_out)


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of an antialiased Keys cubic resize (a = -0.5),
    the kernel widened by the downscale factor, columns normalised to 1,
    samples at pixel centres."""
    scale = n_out / n_in
    width = max(1.0 / scale, 1.0)
    centres = (np.arange(n_out) + 0.5) / scale - 0.5
    x = np.abs(centres[None, :] - np.arange(n_in)[:, None]) / width
    w = np.where(x < 1.0, (1.5 * x - 2.5) * x * x + 1.0,
                 np.where(x < 2.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, 0.0))
    w = w / w.sum(axis=0, keepdims=True)
    return w.astype(np.float32)


def clip_preprocess(images):
    """(N, H, W, 3) in [-1, 1] -> (N, 224, 224, 3) as CLIP normalises it."""
    x = images.float()
    _, h, w, _ = x.shape
    if h != 224:
        x = torch.einsum("nhwc,ho->nowc", x, torch.from_numpy(cubic_resize_matrix(h, 224)).to(x))
    if w != 224:
        x = torch.einsum("nhwc,wo->nhoc", x, torch.from_numpy(cubic_resize_matrix(w, 224)).to(x))
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return ((x + 1.0) / 2.0 - mean) / std


class DiffusionModels(nn.Module):
    """The five networks, named as the program's state dicts are grouped."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.unet = UNet3D(cfg["unet"])
        self.vae = AutoencoderKL(cfg["vae"])
        self.clip_text = ClipText(cfg["clip_text"])
        self.clip_vision = ClipVision(cfg["clip_vision"])
        self.resampler = Resampler(cfg["resampler"])


NORM_TYPES = (Norm,)
