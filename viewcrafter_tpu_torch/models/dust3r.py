"""DUSt3R two-view stereo network: siamese CroCo ViT-L encoder, twin
cross-attending decoders, DPT pointmap heads.

The port of the JAX package's `models/dust3r.py`, module for module and with
the flax scope names, so that `convert.dust3r_from_jax_params` carries a flax
tree across. Parity targets (the reference's):
  - AsymmetricCroCo3DStereo: extern/dust3r/dust3r/model.py:19-166 (shared
    encoder over both views, interleaved twin decoders, view2's pts3d in
    view1's frame);
  - CroCo ViT blocks with RoPE on q, k: extern/dust3r/croco/models/blocks.py:81-191;
  - DPT head: dust3r/heads/dpt_head.py:20-115 + croco/models/dpt_block.py;
  - postprocess: pts3d = d/|d| * expm1(|d|), conf = 1 + exp(x)
    (dust3r/heads/postprocess.py:10-58);
  - linear head: dust3r/heads/linear_head.py:12-41.

Precision, as in the JAX package: the encoder and decoder compute in the
model dtype (bf16 on the card, weights cast once by `cast_weights`), with
float32 LayerNorm, softmax and GELU; the heads run in float32. Every
attention goes through `ops.attention.attention(impl="auto")`: on the card
the hand-written `fullkv_attention` kernel wherever the JAX package's gate
would take its Pallas kernel on a TPU (at 512x288 input: S = 576, D = 64,
every encoder and decoder attention), plain torch on the CPU.

Images are channels-last (B, H, W, 3) in [-1, 1], stored landscape (W >= H);
the ManyAR portrait convention is described at `Dust3rEncoder.forward`.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from viewcrafter_tpu_torch.config import Dust3rConfig
from viewcrafter_tpu_torch.models.layers import Conv, LayerNormF32, cast_weights
from viewcrafter_tpu_torch.ops.attention import attention
from viewcrafter_tpu_torch.ops.resize import resize_bilinear_align_corners
from viewcrafter_tpu_torch.ops.rope2d import rope_2d


def patch_positions(h_patches: int, w_patches: int, device=None) -> torch.Tensor:
    """(h*w, 2) integer (y, x) per patch (croco blocks.py:195-208)."""
    yy, xx = torch.meshgrid(torch.arange(h_patches, device=device),
                            torch.arange(w_patches, device=device), indexing="ij")
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, rope_base: float):
        super().__init__()
        self.heads, self.rope_base = heads, rope_base
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, pos):
        b, s, c = x.shape
        q, k, v = self.qkv(x).reshape(b, s, 3, self.heads, c // self.heads).unbind(2)
        q = rope_2d(q, pos, self.rope_base)
        k = rope_2d(k, pos, self.rope_base)
        o = attention(q, k, v.contiguous()).reshape(b, s, c)
        return self.proj(o)


class CrossAttentionRoPE(nn.Module):
    def __init__(self, dim: int, heads: int, rope_base: float):
        super().__init__()
        self.heads, self.rope_base = heads, rope_base
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, q_tokens, kv_tokens, qpos, kpos):
        b, sq, c = q_tokens.shape
        sk, h = kv_tokens.shape[1], self.heads
        q = self.projq(q_tokens).reshape(b, sq, h, c // h)
        k = self.projk(kv_tokens).reshape(b, sk, h, c // h)
        v = self.projv(kv_tokens).reshape(b, sk, h, c // h)
        q = rope_2d(q, qpos, self.rope_base)
        k = rope_2d(k, kpos, self.rope_base)
        o = attention(q, k, v).reshape(b, sq, c)
        return self.proj(o)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        h = self.fc1(x)
        h = F.gelu(h.float(), approximate="none").to(h.dtype)
        return self.fc2(h)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, rope_base: float):
        super().__init__()
        self.norm1 = LayerNormF32(dim)
        self.attn = SelfAttention(dim, heads, rope_base)
        self.norm2 = LayerNormF32(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, pos):
        x = x + self.attn(self.norm1(x), pos)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """Self-attn + cross-attn to the other view + MLP (blocks.py:171-191)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, rope_base: float):
        super().__init__()
        self.norm1 = LayerNormF32(dim)
        self.attn = SelfAttention(dim, heads, rope_base)
        self.norm_y = LayerNormF32(dim)
        self.norm2 = LayerNormF32(dim)
        self.cross_attn = CrossAttentionRoPE(dim, heads, rope_base)
        self.norm3 = LayerNormF32(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, mem, xpos, mempos):
        x = x + self.attn(self.norm1(x), xpos)
        x = x + self.cross_attn(self.norm2(x), self.norm_y(mem), xpos, mempos)
        return x + self.mlp(self.norm3(x))


def _flags(is_portrait, b: int, device) -> torch.Tensor:
    """A (B,) bool tensor of a ManyAR flag given as None, a bool or (B,)."""
    if is_portrait is None or isinstance(is_portrait, bool):
        return torch.full((b,), bool(is_portrait), dtype=torch.bool, device=device)
    return torch.as_tensor(is_portrait, device=device).reshape(b).bool()


class Dust3rEncoder(nn.Module):
    def __init__(self, cfg: Dust3rConfig):
        super().__init__()
        self.cfg = cfg
        p, c = cfg.patch_size, cfg.enc_embed_dim
        self.patch_embed = Conv(3, c, p, stride=p)
        for i in range(cfg.enc_depth):
            self.add_module(f"block_{i}", EncoderBlock(c, cfg.enc_num_heads, cfg.mlp_ratio,
                                                       cfg.rope_freq))
        self.norm = LayerNormF32(c)

    def forward(self, img, is_portrait=None):
        """img: (B, H, W, 3) stored landscape (W >= H), H and W multiples of
        16 -> tokens (B, S, C), pos (B, S, 2).

        is_portrait, the ManyAR convention (dust3r/patch_embed.py:32-70):
        portrait images ride the batch stored transposed to landscape; their
        patch embedding runs on the transposed (true-portrait) image and their
        RoPE positions use the (wp, hp) grid. None / False: all landscape;
        True: all portrait; a (B,) bool tensor: a mixed batch, both
        orientations computed and selected per image."""
        cfg = self.cfg
        b, h, w, _ = img.shape
        p = cfg.patch_size
        hp, wp = h // p, w // p
        n, c = hp * wp, cfg.enc_embed_dim
        img = img.to(self.patch_embed.weight.dtype)

        def embed(portrait: bool):
            src = img.transpose(1, 2) if portrait else img
            grid = (wp, hp) if portrait else (hp, wp)
            x = self.patch_embed(src).reshape(b, n, c)
            return x, patch_positions(*grid, device=img.device)[None].expand(b, n, 2)

        if is_portrait is None or isinstance(is_portrait, bool):
            x, pos = embed(bool(is_portrait))
        else:
            flag = _flags(is_portrait, b, img.device)[:, None, None]
            (xl, posl), (xp, posp) = embed(False), embed(True)
            x, pos = torch.where(flag, xp, xl), torch.where(flag, posp, posl)
        for i in range(cfg.enc_depth):
            x = getattr(self, f"block_{i}")(x, pos)
        return self.norm(x), pos


class Dust3rDecoder(nn.Module):
    """Twin interleaved decoders; returns per-depth outputs of both streams
    (model.py:127-146)."""

    def __init__(self, cfg: Dust3rConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.dec_embed_dim
        # one shared projection and one shared final norm for both streams
        # (model.py:137-139, :144)
        self.decoder_embed = nn.Linear(cfg.enc_embed_dim, d)
        for i in range(cfg.dec_depth):
            for s in (1, 2):
                self.add_module(f"block{s}_{i}", DecoderBlock(d, cfg.dec_num_heads, cfg.mlp_ratio,
                                                              cfg.rope_freq))
        self.norm = LayerNormF32(d)

    def forward(self, f1, pos1, f2, pos2):
        f1, f2 = self.decoder_embed(f1), self.decoder_embed(f2)
        outs1: List[torch.Tensor] = []
        outs2: List[torch.Tensor] = []
        for i in range(self.cfg.dec_depth):
            nf1 = getattr(self, f"block1_{i}")(f1, f2, pos1, pos2)
            nf2 = getattr(self, f"block2_{i}")(f2, f1, pos2, pos1)
            f1, f2 = nf1, nf2
            outs1.append(f1)
            outs2.append(f2)
        outs1[-1] = self.norm(outs1[-1])
        outs2[-1] = self.norm(outs2[-1])
        return outs1, outs2


def _postprocess(fmap: torch.Tensor):
    """(B, H, W, 3+1) raw head output -> (pts3d, conf)
    (dust3r/heads/postprocess.py:10-58, 'exp' modes, no bounds)."""
    xyz = fmap[..., :3].float()
    d = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    pts = xyz / torch.clamp(d, min=1e-8) * torch.expm1(d)
    conf = 1.0 + torch.exp(fmap[..., 3].float())
    return pts, conf


class ConvTranspose(nn.ConvTranspose2d):
    """nn.ConvTranspose2d on channels-last (N, H, W, C) tensors."""

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, self.bias, self.stride)
        return y.permute(0, 2, 3, 1)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv(features, features, 3, padding=1)
        self.conv2 = Conv(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FusionBlock(nn.Module):
    """`with_skip`: whether the block takes a skip input (refinenet4 does not,
    and has no rcu1, as the flax tree has none)."""

    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.rcu1 = ResidualConvUnit(features)
        self.rcu2 = ResidualConvUnit(features)
        self.out_conv = Conv(features, features, 1)

    def forward(self, x, skip: Optional[torch.Tensor] = None):
        if skip is not None:
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        x = resize_bilinear_align_corners(x, x.shape[-3] * 2, x.shape[-2] * 2)
        return self.out_conv(x)


class DPTHead(nn.Module):
    """Multi-scale token pyramid -> dense (3+conf) map, all float32
    (dpt_head.py:34-65, dpt_block.py:341-410)."""

    float32_module = True  # `cast_weights` leaves it in float32

    def __init__(self, cfg: Dust3rConfig):
        super().__init__()
        self.cfg = cfg
        dims, fd = cfg.dpt_hidden_dims, cfg.dpt_feature_dim
        enc, dec = cfg.enc_embed_dim, cfg.dec_embed_dim
        # act_postprocess: 1x1 projection, then rescale to {x4, x2, x1, /2}
        self.act1_proj = Conv(enc, dims[0], 1)
        self.act1_up = ConvTranspose(dims[0], dims[0], 4, stride=4)
        self.act2_proj = Conv(dec, dims[1], 1)
        self.act2_up = ConvTranspose(dims[1], dims[1], 2, stride=2)
        self.act3_proj = Conv(dec, dims[2], 1)
        self.act4_proj = Conv(dec, dims[3], 1)
        self.act4_down = Conv(dims[3], dims[3], 3, stride=2, padding=1)
        for i in range(4):
            self.add_module(f"layer{i + 1}_rn", Conv(dims[i], fd, 3, padding=1, bias=False))
        for i in (4, 3, 2, 1):
            self.add_module(f"refinenet{i}", FusionBlock(fd, with_skip=i != 4))
        self.head_conv1 = Conv(fd, fd // 2, 3, padding=1)
        self.head_conv2 = Conv(fd // 2, fd // 2, 3, padding=1)
        self.head_conv3 = Conv(fd // 2, 4, 1)

    def forward(self, feats: List[torch.Tensor], h: int, w: int):
        p = self.cfg.patch_size
        hp, wp = h // p, w // p
        maps = [f.float().reshape(f.shape[0], hp, wp, f.shape[-1]) for f in feats]
        l1 = self.act1_up(self.act1_proj(maps[0]))
        l2 = self.act2_up(self.act2_proj(maps[1]))
        l3 = self.act3_proj(maps[2])
        l4 = self.act4_down(self.act4_proj(maps[3]))
        rn = [getattr(self, f"layer{i + 1}_rn")(l) for i, l in enumerate((l1, l2, l3, l4))]
        path4 = self.refinenet4(rn[3])
        # crop to the next pyramid level's size (odd grids; dpt_head.py:57)
        path4 = path4[:, : rn[2].shape[1], : rn[2].shape[2]]
        path3 = self.refinenet3(path4, rn[2])
        path2 = self.refinenet2(path3, rn[1])
        path1 = self.refinenet1(path2, rn[0])
        out = self.head_conv1(path1)
        out = resize_bilinear_align_corners(out, out.shape[-3] * 2, out.shape[-2] * 2)
        return self.head_conv3(F.relu(self.head_conv2(out)))


class LinearHead(nn.Module):
    """Pixel-shuffle linear head alternative (linear_head.py:12-41)."""

    float32_module = True

    def __init__(self, cfg: Dust3rConfig):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.proj = nn.Linear(cfg.dec_embed_dim, 4 * p * p)

    def forward(self, feats: List[torch.Tensor], h: int, w: int):
        p = self.cfg.patch_size
        tokens = feats[-1].float()
        b = tokens.shape[0]
        out = self.proj(tokens)
        # torch F.pixel_shuffle channel order: index = c*p*p + dy*p + dx
        out = out.reshape(b, h // p, w // p, 4, p, p)
        return out.permute(0, 1, 4, 2, 5, 3).reshape(b, h, w, 4)


class Dust3rModel(nn.Module):
    """The full two-view network. Input images (B, H, W, 3) in [-1, 1]
    ((0.5, 0.5) normalisation, dust3r/utils/image.py:43). The encoder and
    decoder weights are held in `dtype`; the heads stay float32."""

    def __init__(self, cfg: Dust3rConfig = Dust3rConfig(), dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.encoder = Dust3rEncoder(cfg)
        self.decoder = Dust3rDecoder(cfg)
        head_cls = DPTHead if cfg.head_type == "dpt" else LinearHead
        self.head1 = head_cls(cfg)
        self.head2 = head_cls(cfg)
        cast_weights(self, dtype)  # the heads stay float32

    def _hooked(self, enc_out, dec_outs) -> List[torch.Tensor]:
        # hooks [0, 2/4*d, 3/4*d, d] over [enc, dec_1..dec_d] (dpt_head.py:107)
        d = self.cfg.dec_depth
        feats = [enc_out] + list(dec_outs)
        return [feats[0], feats[d * 2 // 4], feats[d * 3 // 4], feats[d]]

    @staticmethod
    def _head_raw(head, feats, h, w, is_portrait):
        """A head honouring the ManyAR orientation (misc.py:54-97): portrait
        images predict on the (w, h) token grid, and the map transposes back
        to the stored landscape layout."""
        if is_portrait is None or isinstance(is_portrait, bool):
            if is_portrait:
                return head(feats, w, h).transpose(1, 2)
            return head(feats, h, w)
        flag = _flags(is_portrait, feats[0].shape[0], feats[0].device)[:, None, None, None]
        return torch.where(flag, head(feats, w, h).transpose(1, 2), head(feats, h, w))

    def _heads(self, f1, f2, outs1, outs2, h, w, p1, p2) -> dict:
        pts1, conf1 = _postprocess(self._head_raw(self.head1, self._hooked(f1, outs1), h, w, p1))
        pts2, conf2 = _postprocess(self._head_raw(self.head2, self._hooked(f2, outs2), h, w, p2))
        # view2's points are expressed in view1's frame
        return {"pts3d1": pts1, "conf1": conf1, "pts3d2_in_view1": pts2, "conf2": conf2}

    def forward(self, img1, img2, is_portrait1=None, is_portrait2=None) -> dict:
        """img1 / img2: (B, H, W, 3) stored landscape; is_portrait1 / 2: ManyAR
        flags (see Dust3rEncoder). Output maps are in the stored (landscape)
        layout, as in the reference; the caller un-transposes portrait maps."""
        b, h, w, _ = img1.shape
        both = torch.cat([img1, img2], dim=0)
        if is_portrait1 is None and is_portrait2 is None:
            flag_both = None
        elif is_portrait1 is is_portrait2 and isinstance(is_portrait1, bool):
            flag_both = is_portrait1  # a uniform batch
        else:
            flag_both = torch.cat([_flags(is_portrait1, b, img1.device),
                                   _flags(is_portrait2, b, img1.device)])
        tokens, pos = self.encoder(both, is_portrait=flag_both)
        f1, f2 = tokens.chunk(2, dim=0)
        pos1, pos2 = pos.chunk(2, dim=0)
        outs1, outs2 = self.decoder(f1, pos1, f2, pos2)
        p1 = is_portrait1 if isinstance(is_portrait1, (bool, type(None))) else _flags(
            is_portrait1, b, img1.device)
        p2 = is_portrait2 if isinstance(is_portrait2, (bool, type(None))) else _flags(
            is_portrait2, b, img1.device)
        return self._heads(f1, f2, outs1, outs2, h, w, p1, p2)

    def encode(self, imgs, is_portrait=None):
        """Encode N unique images once (the symmetrised-pair encoder dedup,
        reference model.py:117-125). Returns (tokens (N,S,C), pos (N,S,2))."""
        return self.encoder(imgs, is_portrait=is_portrait)

    def decode_pairs(self, tokens, pos, idx1, idx2, h: int, w: int,
                     is_portrait1=None, is_portrait2=None) -> dict:
        """Decoder and heads over pairs of pre-encoded images. tokens / pos:
        `encode`'s outputs; idx1 / idx2: (P,) image indices of each directed
        pair; h, w: stored-landscape pixel dims. Output as `forward`'s."""
        f1, f2 = tokens[idx1], tokens[idx2]
        outs1, outs2 = self.decoder(f1, pos[idx1], f2, pos[idx2])
        return self._heads(f1, f2, outs1, outs2, h, w, is_portrait1, is_portrait2)
