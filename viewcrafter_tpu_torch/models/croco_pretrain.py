"""CroCo cross-view completion pretraining (the MAE-style masked pretext
task): the port of the JAX package's `models/croco_pretrain.py`.

Parity target: extern/dust3r/croco/models/croco.py CroCoNet with
RandomMask(mask_ratio=0.9) (masking.py:12-25) and the MaskedMSE criterion
(criterion.py:13-45): encode the visible patches of view 1 (RoPE positions,
so masking is a gather), encode view 2 whole, scatter view 1's visible
decoder embeddings into a canvas of mask tokens, run the cross-attending
decoder over the whole grid and regress the masked patches' pixels with a
linear head.

The blocks are DUSt3R's (`models/dust3r.py`), as in the JAX package, so
every attention goes through `ops.attention.attention(impl="auto")`. At the
published size (224x224, 196 tokens; decoder heads of 32) the fullkv gate
takes none of them: 196 is not a multiple of 64 and 32 is not a head width
the kernel takes, which is what the JAX package's gate decides too.

Randomness: the JAX package draws the mask with `jax.random`; here
`random_mask` draws it from a `torch.Generator`, and `forward` takes the
mask as an argument, so that a test feeds both packages one mask.

Precision as in `Dust3rModel`: every weight but the LayerNorms in the model
dtype (`cast_weights`), the mask token included; the prediction in float32.
Module names follow the flax scopes (`convert.croco_pretrain_from_jax_params`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from viewcrafter_tpu_torch.models.dust3r import DecoderBlock, EncoderBlock, patch_positions
from viewcrafter_tpu_torch.models.layers import Conv, LayerNormF32, cast_weights


@dataclasses.dataclass(frozen=True)
class CroCoPretrainConfig:
    """CroCoNet pretraining dims: a ViT-B/16 encoder and a 512-wide decoder
    of 8 blocks with 16 heads (the DUSt3R-compatible topology)."""

    img_size: Tuple[int, int] = (224, 224)
    patch_size: int = 16
    enc_embed_dim: int = 768
    enc_depth: int = 12
    enc_num_heads: int = 12
    dec_embed_dim: int = 512
    dec_depth: int = 8
    dec_num_heads: int = 16
    mlp_ratio: float = 4.0
    rope_freq: float = 100.0
    mask_ratio: float = 0.9
    norm_pix_loss: bool = False

    def num_mask(self, n_tokens: Optional[int] = None) -> int:
        """Masked patches per image (all images mask the same count)."""
        if n_tokens is None:
            n_tokens = (self.img_size[0] // self.patch_size) * (self.img_size[1] // self.patch_size)
        return int(self.mask_ratio * n_tokens)


def random_mask(generator: torch.Generator, batch: int, n_tokens: int,
                num_mask: int) -> torch.Tensor:
    """(B, N) bool, True = masked, exactly `num_mask` a row
    (masking.py RandomMask: the rank of a uniform draw below num_mask), on
    the generator's device."""
    noise = torch.rand((batch, n_tokens), generator=generator, device=generator.device)
    return torch.argsort(torch.argsort(noise, dim=1), dim=1) < num_mask


def patchify(imgs: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, N, p*p*3), patch pixels ordered (row, col,
    channel), the reference's einsum('nchpwq->nhwpqc') (croco.py:201-213)."""
    b, h, w, c = imgs.shape
    x = imgs.reshape(b, h // p, p, w // p, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p), p * p * c)


def unpatchify(x: torch.Tensor, p: int, hp: int, wp: int) -> torch.Tensor:
    b = x.shape[0]
    y = x.reshape(b, hp, wp, p, p, 3)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, hp * p, wp * p, 3)


class CroCoPretrain(nn.Module):
    def __init__(self, cfg: CroCoPretrainConfig = CroCoPretrainConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        p, ce, cd = cfg.patch_size, cfg.enc_embed_dim, cfg.dec_embed_dim
        self.patch_embed = Conv(3, ce, p, stride=p)
        for i in range(cfg.enc_depth):
            self.add_module(f"enc_block_{i}", EncoderBlock(ce, cfg.enc_num_heads, cfg.mlp_ratio,
                                                           cfg.rope_freq))
        self.enc_norm = LayerNormF32(ce)
        self.decoder_embed = nn.Linear(ce, cd)
        self.mask_token = nn.Parameter(torch.randn(1, 1, cd) * 0.02)
        for i in range(cfg.dec_depth):
            self.add_module(f"dec_block_{i}", DecoderBlock(cd, cfg.dec_num_heads, cfg.mlp_ratio,
                                                           cfg.rope_freq))
        self.dec_norm = LayerNormF32(cd)
        self.prediction_head = nn.Linear(cd, p * p * 3)
        cast_weights(self, dtype)

    def _encode(self, img, pos, vis_idx=None):
        b, n = pos.shape[:2]
        x = self.patch_embed(img.to(self.patch_embed.weight.dtype)).reshape(b, n, -1)
        if vis_idx is not None:
            x = torch.gather(x, 1, vis_idx[..., None].expand(-1, -1, x.shape[-1]))
            pos = torch.gather(pos, 1, vis_idx[..., None].expand(-1, -1, 2))
        for i in range(self.cfg.enc_depth):
            x = getattr(self, f"enc_block_{i}")(x, pos)
        return self.enc_norm(x), pos

    def forward(self, img1, img2, mask: torch.Tensor):
        """img1 (masked, then reconstructed from img2) and img2: (B, H, W, 3)
        in [-1, 1]. `mask`: (B, N) bool with exactly cfg.num_mask(N) True a
        row (`random_mask`). Returns (pred (B, N, p*p*3) float32, mask,
        target (B, N, p*p*3) float32)."""
        cfg = self.cfg
        b, h, w, _ = img1.shape
        p = cfg.patch_size
        hp, wp = h // p, w // p
        n = hp * wp
        num_mask = cfg.num_mask(n)
        mask = mask.to(img1.device)
        pos = patch_positions(hp, wp, device=img1.device)[None].expand(b, n, 2)
        # the visible patches in position order: a stable sort of the mask
        # puts them first, as the reference's boolean indexing orders them
        vis_idx = torch.sort(mask.to(torch.int32), dim=1, stable=True).indices[:, :n - num_mask]
        f1_vis, _ = self._encode(img1, pos, vis_idx)
        f2, pos2 = self._encode(img2, pos)
        v1 = self.decoder_embed(f1_vis)
        g2 = self.decoder_embed(f2)
        canvas = self.mask_token.to(v1.dtype).expand(b, n, v1.shape[-1])
        f1 = canvas.scatter(1, vis_idx[..., None].expand(-1, -1, v1.shape[-1]), v1)
        for i in range(cfg.dec_depth):
            f1 = getattr(self, f"dec_block_{i}")(f1, g2, pos, pos2)
        pred = self.prediction_head(self.dec_norm(f1))
        return pred.float(), mask, patchify(img1.float(), p)


def masked_mse_loss(pred, mask, target, norm_pix_loss: bool = False, masked: bool = True,
                    count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MaskedMSE (criterion.py:13-45): the per-patch MSE averaged over the
    masked patches (all patches with masked=False), the target optionally
    normalized per patch with the unbiased variance (torch's `.var`).
    `count`: the masked patches of the whole batch when this call sees a
    shard of it (else its own)."""
    if norm_pix_loss:
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True)
        target = (target - mean) / torch.sqrt(var + 1e-6)
    loss = ((pred - target) ** 2).mean(dim=-1)
    if not masked:
        return loss.mean()
    m = mask.to(loss.dtype)
    return (loss * m).sum() / torch.clamp(m.sum() if count is None else count.to(loss.dtype),
                                          min=1.0)
