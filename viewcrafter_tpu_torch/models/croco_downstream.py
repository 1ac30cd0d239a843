"""CroCo downstream stereo/flow networks (binocular, and monocular encoder):
the port of the JAX package's `models/croco_downstream.py`.

Parity targets (the reference's):
  - CroCoDownstreamBinocular / CroCoDownstreamMonocularEncoder:
    extern/dust3r/croco/models/croco_downstream.py:23-122: the CroCoNet
    backbone without masking, both images encoded in one batch, a
    single-stream cross-attending decoder, a dense DPT head fed with the
    encoder and decoder block outputs;
  - PixelwiseTaskWithDPT: croco/models/head_downstream.py:19-58: the DPT
    regression adapter (croco/models/dpt_block.py:281-343; layer dims
    96/192/384/768, features 256, last dim 32) over 4 hooked layers; the
    default hooks are the last encoder block and 3 equally spread decoder
    blocks (head_downstream.py:38-45);
  - the prediction: num_channels task channels (stereo 1, flow 2) and an
    optional trailing confidence channel (stereoflow/test.py:58-62).

The blocks are DUSt3R's (`models/dust3r.py`), as in the JAX package and the
reference, so every self-attention and cross-attention goes through
`ops.attention.attention(impl="auto")`: on the card the hand-written
`fullkv_attention` kernel where the JAX package's gate would take its Pallas
kernel, the plain path elsewhere. At the released tile crop of 352x704 the
grid is 22x44 = 968 tokens, no multiple of 64, so the gate sends every
attention to the plain path; at 384x768 (1152 tokens) it takes the kernel.

Precision as in `Dust3rModel`: the encoder and decoder in the model dtype
(bf16 on the card, `cast_weights`), float32 LayerNorm, softmax and GELU; the
head in float32 (`float32_module`). Channels-last throughout; module names
follow the flax scopes (`convert.croco_downstream_from_jax_params`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from viewcrafter_tpu_torch.models.dust3r import (
    ConvTranspose, DecoderBlock, EncoderBlock, FusionBlock, patch_positions)
from viewcrafter_tpu_torch.models.layers import Conv, LayerNormF32, cast_weights
from viewcrafter_tpu_torch.ops.resize import resize_bilinear_align_corners


def default_hooks(enc_depth: int, dec_depth: int) -> Tuple[int, ...]:
    """Hook indices into [enc_1..enc_E, dec_1..dec_D] (head_downstream.py:38-41):
    the last encoder block and 3 equally spread decoder blocks."""
    step = {8: 3, 12: 4, 24: 8}[dec_depth]
    return tuple(dec_depth + enc_depth - 1 - i * step for i in range(3, -1, -1))


@dataclasses.dataclass(frozen=True)
class CroCoDownstreamConfig:
    """The CroCo v2 ViT-L encoder and Base decoder of the released
    CroCo-Stereo / CroCo-Flow checkpoints by default; num_channels includes
    the confidence channel when there is one (stereoflow/test.py:58-62)."""

    img_size: Tuple[int, int] = (224, 224)
    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    mlp_ratio: float = 4.0
    rope_freq: float = 100.0
    num_channels: int = 2  # stereo: 1 (+1 conf); flow: 2 (+1 conf)
    dpt_layer_dims: Tuple[int, int, int, int] = (96, 192, 384, 768)
    dpt_feature_dim: int = 256
    dpt_last_dim: int = 32
    hooks_idx: Optional[Tuple[int, ...]] = None

    def hooks(self) -> Tuple[int, ...]:
        return self.hooks_idx or default_hooks(self.enc_depth, self.dec_depth)


class DPTRegressionHead(nn.Module):
    """PixelwiseTaskWithDPT's DPTOutputAdapter in regression mode
    (dpt_block.py:309-325,341-410): a 1x1 projection and a rescale {x4, x2,
    x1, /2} of the 4 hooked token maps, the refinenet fusion pyramid, then
    conv3x3 -> x2 bilinear (align_corners) -> conv3x3 -> relu -> conv1x1.
    `in_dims`: the widths of the 4 hooked features."""

    float32_module = True  # `cast_weights` leaves it in float32

    def __init__(self, in_dims: Tuple[int, int, int, int], patch_size: int,
                 layer_dims: Tuple[int, int, int, int], feature_dim: int, last_dim: int,
                 num_channels: int):
        super().__init__()
        self.patch_size = patch_size
        dims, fd = layer_dims, feature_dim
        self.act1_proj = Conv(in_dims[0], dims[0], 1)
        self.act1_up = ConvTranspose(dims[0], dims[0], 4, stride=4)
        self.act2_proj = Conv(in_dims[1], dims[1], 1)
        self.act2_up = ConvTranspose(dims[1], dims[1], 2, stride=2)
        self.act3_proj = Conv(in_dims[2], dims[2], 1)
        self.act4_proj = Conv(in_dims[3], dims[3], 1)
        self.act4_down = Conv(dims[3], dims[3], 3, stride=2, padding=1)
        for i in range(4):
            self.add_module(f"layer{i + 1}_rn", Conv(dims[i], fd, 3, padding=1, bias=False))
        for i in (4, 3, 2, 1):
            self.add_module(f"refinenet{i}", FusionBlock(fd, with_skip=i != 4))
        self.head_conv1 = Conv(fd, fd // 2, 3, padding=1)
        self.head_conv2 = Conv(fd // 2, last_dim, 3, padding=1)
        self.head_conv3 = Conv(last_dim, num_channels, 1)

    def forward(self, feats: List[torch.Tensor], h: int, w: int) -> torch.Tensor:
        p = self.patch_size
        hp, wp = h // p, w // p
        maps = [f.float().reshape(f.shape[0], hp, wp, f.shape[-1]) for f in feats]
        l1 = self.act1_up(self.act1_proj(maps[0]))
        l2 = self.act2_up(self.act2_proj(maps[1]))
        l3 = self.act3_proj(maps[2])
        l4 = self.act4_down(self.act4_proj(maps[3]))
        rn = [getattr(self, f"layer{i + 1}_rn")(x) for i, x in enumerate((l1, l2, l3, l4))]
        path4 = self.refinenet4(rn[3])
        path4 = path4[:, : rn[2].shape[1], : rn[2].shape[2]]
        path3 = self.refinenet3(path4, rn[2])
        path2 = self.refinenet2(path3, rn[1])
        path1 = self.refinenet1(path2, rn[0])
        out = self.head_conv1(path1)
        out = resize_bilinear_align_corners(out, out.shape[-3] * 2, out.shape[-2] * 2)
        return self.head_conv3(F.relu(self.head_conv2(out)))


def _head(cfg: CroCoDownstreamConfig, in_dims) -> DPTRegressionHead:
    return DPTRegressionHead(tuple(in_dims), cfg.patch_size, cfg.dpt_layer_dims,
                             cfg.dpt_feature_dim, cfg.dpt_last_dim, cfg.num_channels)


class _Encoder(nn.Module):
    """The patch embedding and encoder blocks the two models share."""

    def __init__(self, cfg: CroCoDownstreamConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        p, c = cfg.patch_size, cfg.enc_embed_dim
        self.patch_embed = Conv(3, c, p, stride=p)
        for i in range(cfg.enc_depth):
            self.add_module(f"enc_block_{i}", EncoderBlock(c, cfg.enc_num_heads, cfg.mlp_ratio,
                                                           cfg.rope_freq))
        self.enc_norm = LayerNormF32(c)

    def _encode(self, img: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """img (N, H, W, 3) -> every encoder block's output (the last one
        normed) and the positions (N, S, 2)."""
        n_img, h, w, _ = img.shape
        p = self.cfg.patch_size
        hp, wp = h // p, w // p
        x = self.patch_embed(img.to(self.patch_embed.weight.dtype)).reshape(n_img, hp * wp, -1)
        pos = patch_positions(hp, wp, device=img.device)[None].expand(n_img, hp * wp, 2)
        outs = []
        for i in range(self.cfg.enc_depth):
            x = getattr(self, f"enc_block_{i}")(x, pos)
            outs.append(x)
        outs[-1] = self.enc_norm(outs[-1])
        return outs, pos


class CroCoDownstreamBinocular(_Encoder):
    """Binocular CroCo for stereo and flow (croco_downstream.py:67-122).

    forward(img1, img2): (B, H, W, 3) each -> (B, H, W, num_channels)
    float32. Both images are encoded in one batch; the decoder updates view
    1's tokens and keeps view 2's fixed; the head reads the hooked outputs
    of every encoder block (view 1's) and every decoder block, the last of
    each normed."""

    def __init__(self, cfg: CroCoDownstreamConfig = CroCoDownstreamConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(cfg, dtype)
        d = cfg.dec_embed_dim
        self.decoder_embed = nn.Linear(cfg.enc_embed_dim, d)
        for i in range(cfg.dec_depth):
            self.add_module(f"dec_block_{i}", DecoderBlock(d, cfg.dec_num_heads, cfg.mlp_ratio,
                                                           cfg.rope_freq))
        self.dec_norm = LayerNormF32(d)
        widths = [cfg.enc_embed_dim] * cfg.enc_depth + [d] * cfg.dec_depth
        self.head = _head(cfg, [widths[i] for i in cfg.hooks()])
        cast_weights(self, dtype)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, h, w, _ = img1.shape
        enc_all, pos = self._encode(torch.cat([img1, img2], dim=0))
        f1_all = [o[:b] for o in enc_all]
        o1 = self.decoder_embed(f1_all[-1])
        o2 = self.decoder_embed(enc_all[-1][b:])
        pos1, pos2 = pos[:b], pos[b:]
        dec_all = []
        for i in range(cfg.dec_depth):
            o1 = getattr(self, f"dec_block_{i}")(o1, o2, pos1, pos2)
            dec_all.append(o1)
        dec_all[-1] = self.dec_norm(dec_all[-1])
        feats = f1_all + dec_all
        return self.head([feats[i] for i in cfg.hooks()], h, w)


def monocular_hooks(cfg: CroCoDownstreamConfig) -> Tuple[int, ...]:
    """4 equally spread encoder blocks (head_downstream.py:42-44)."""
    step = cfg.enc_depth // 4
    return cfg.hooks_idx or tuple(cfg.enc_depth - 1 - i * step for i in range(3, -1, -1))


class CroCoDownstreamMonocularEncoder(_Encoder):
    """The encoder-only monocular variant (croco_downstream.py:23-64):
    forward(img) (B, H, W, 3) -> (B, H, W, num_channels) float32, the head
    on 4 equally spread encoder blocks."""

    def __init__(self, cfg: CroCoDownstreamConfig = CroCoDownstreamConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(cfg, dtype)
        self.head = _head(cfg, [cfg.enc_embed_dim] * 4)
        cast_weights(self, dtype)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = img.shape
        enc_all, _ = self._encode(img)
        return self.head([enc_all[i] for i in monocular_hooks(self.cfg)], h, w)


def split_prediction_conf(pred: torch.Tensor, with_conf: bool):
    """(B, H, W, C[+1]) -> (the task channels, the confidence or None)."""
    if not with_conf:
        return pred, None
    return pred[..., :-1], pred[..., -1]
