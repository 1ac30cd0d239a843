"""KL-regularized image autoencoder (SD-style f8 VAE), channels-last: the
port of the JAX package's models/vae.py with the same submodule names.

GroupNorm eps=1e-6 in f32; convs in the module dtype. The mid AttnBlock (one
head, d = channels) is plain matmul + f32 softmax (the JAX package ran the
JAX library's TPU flash kernel there, not a kernel of its own).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from viewcrafter_tpu_torch.models.layers import Conv, GroupNorm32, set_group_norm_fused
from viewcrafter_tpu_torch.ops.attention import attention


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, eps=1e-6, with_silu=True)
        self.conv1 = Conv(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6, with_silu=True)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.nin_shortcut = Conv(in_ch, out_ch, 1)

    def forward(self, x):
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head full self-attention over the spatial grid."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm32(c, eps=1e-6)
        self.q = Conv(c, c, 1)
        self.k = Conv(c, c, 1)
        self.v = Conv(c, c, 1)
        self.proj_out = Conv(c, c, 1)

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.norm(x)
        q, k, v = (m(y).reshape(b, h * w, 1, c) for m in (self.q, self.k, self.v))
        return x + self.proj_out(attention(q, k, v).reshape(b, h, w, c))


class Downsample(nn.Module):
    """Asymmetric-pad stride-2 conv: pad (0,1) on H and W, then VALID."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


class Encoder(nn.Module):
    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 z_channels: int, double_z: bool = True):
        super().__init__()
        self.ch_mult, self.num_res_blocks = tuple(ch_mult), num_res_blocks
        self.conv_in = Conv(3, ch, 3, padding=1)
        block_in = ch
        for i, mult in enumerate(ch_mult):
            for j in range(num_res_blocks):
                self.add_module(f"down_{i}_block_{j}", ResnetBlock(block_in, ch * mult))
                block_in = ch * mult
            if i != len(ch_mult) - 1:
                self.add_module(f"down_{i}_downsample", Downsample(block_in))
        self.mid_block_1 = ResnetBlock(block_in, block_in)
        self.mid_attn_1 = AttnBlock(block_in)
        self.mid_block_2 = ResnetBlock(block_in, block_in)
        self.norm_out = GroupNorm32(block_in, eps=1e-6, with_silu=True)
        self.conv_out = Conv(block_in, 2 * z_channels if double_z else z_channels, 3, padding=1)

    def forward(self, h):
        """h: (B, H, W, 3) in the module dtype -> moments (B, H/8, W/8, 2z)."""
        h = self.conv_in(h)
        for i in range(len(self.ch_mult)):
            for j in range(self.num_res_blocks):
                h = getattr(self, f"down_{i}_block_{j}")(h)
            if i != len(self.ch_mult) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(self.norm_out(h))


class Decoder(nn.Module):
    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 z_channels: int, out_ch: int = 3):
        super().__init__()
        self.ch_mult, self.num_res_blocks = tuple(ch_mult), num_res_blocks
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv(z_channels, block_in, 3, padding=1)
        self.mid_block_1 = ResnetBlock(block_in, block_in)
        self.mid_attn_1 = AttnBlock(block_in)
        self.mid_block_2 = ResnetBlock(block_in, block_in)
        for i in reversed(range(len(ch_mult))):
            for j in range(num_res_blocks + 1):
                self.add_module(f"up_{i}_block_{j}", ResnetBlock(block_in, ch * ch_mult[i]))
                block_in = ch * ch_mult[i]
            if i != 0:
                self.add_module(f"up_{i}_upsample", Upsample(block_in))
        self.norm_out = GroupNorm32(block_in, eps=1e-6, with_silu=True)
        self.conv_out = Conv(block_in, out_ch, 3, padding=1)

    def forward(self, z):
        """z: (B, h, w, z_channels) -> (B, 8h, 8w, 3)."""
        h = self.conv_in(z)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for i in reversed(range(len(self.ch_mult))):
            for j in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_block_{j}")(h)
            if i != 0:
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(self.norm_out(h))


class AutoencoderKL(nn.Module):
    """Encoder/Decoder + 1x1 quant convs. gn_fused: every GroupNorm takes the
    `group_norm_fused` kernel route (see `layers.GroupNorm32`)."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, embed_dim: int = 4, z_channels: int = 4,
                 dtype: torch.dtype = torch.bfloat16, gn_fused: bool = False):
        super().__init__()
        self.dtype = dtype
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, z_channels)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, z_channels)
        self.quant_conv = Conv(2 * z_channels, 2 * embed_dim, 1)
        self.post_quant_conv = Conv(embed_dim, z_channels, 1)
        set_group_norm_fused(self, gn_fused)

    def encode_moments(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (mean, logvar) in f32, logvar clamped to [-30, 20]."""
        moments = self.quant_conv(self.encoder(x.to(self.dtype)))
        mean, logvar = moments.float().chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x, noise=None):
        """Posterior sample mean + std * noise when `noise` (a standard normal
        draw shaped like the mean) is given, else the mode."""
        mean, logvar = self.encode_moments(x)
        if noise is None:
            return mean
        return mean + torch.exp(0.5 * logvar) * noise

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))
