"""Image resize helpers on channels-last tensors (..., H, W, C).

The port of the JAX package's `ops/resize.py`:
  - `resize_bilinear_align_corners`: torch's F.interpolate(mode='bilinear',
    align_corners=True), which the DPT fusion blocks and head use
    (extern/dust3r/croco/models/dpt_block.py:137-139,321). Computed as the
    JAX package computes it (two gathers per axis, the same weights), so the
    two agree to the last bits.
  - `resize_bilinear`: half-pixel bilinear (`jax.image.resize`'s "bilinear",
    torch's align_corners=False), the render -> diffusion-resolution upsample
    (viewcrafter.py:158) and the generated frame -> DUSt3R downsample of the
    iterative modes. For an upsample, torch's clamped source coordinate and
    jax.image.resize's renormalised border weights give the same values; a
    downsample widens the triangle kernel by the scale, as jax.image.resize
    does, which is torch's `antialias=True`.
  - `resize_cubic`: `jax.image.resize(method="cubic")`, the stereo/flow
    engine's resize of an image smaller than the tile crop
    (stereoflow/engine.py). It is not torch's bicubic: the Keys kernel with
    a = -0.5 (torch's a = -0.75), widened by the scale on a downsample
    (antialiasing on by default), its weights renormalised at the borders,
    and an output sample whose source lies outside [-0.5, n - 0.5] zero.
    So it is one weight matrix per axis with those semantics, applied as
    two products.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _axis_coords(n_in: int, n_out: int, device) -> torch.Tensor:
    if n_out == 1 or n_in == 1:
        return torch.zeros((n_out,), dtype=torch.float32, device=device)
    return torch.linspace(0.0, float(n_in - 1), n_out, dtype=torch.float32, device=device)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """x: (..., H, W, C) -> (..., out_h, out_w, C), align_corners=True."""
    h, w = x.shape[-3], x.shape[-2]
    yy = _axis_coords(h, out_h, x.device)
    xx = _axis_coords(w, out_w, x.device)
    y0 = torch.floor(yy).long()
    x0 = torch.floor(xx).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (yy - y0)[:, None, None]
    wx = (xx - x0)[None, :, None]

    def gather(yi, xi):
        return x[..., yi, :, :][..., :, xi, :]

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel bilinear resize of (..., H, W, C) in float32; an axis that
    shrinks is antialiased as jax.image.resize antialiases it."""
    h, w, c = x.shape[-3:]
    if (out_h, out_w) == (h, w):
        return x.float().clone()
    lead = x.shape[:-3]
    nchw = x.float().reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(nchw, size=(out_h, out_w), mode="bilinear", align_corners=False,
                      antialias=out_h < h or out_w < w)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel with a = -0.5 at |x| (jax.image's)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) float32 weights of one axis of `jax.image.resize`'s
    "cubic" with antialiasing (jax/_src/image/scale.py `compute_weight_mat`,
    zero translation), in its float32 arithmetic."""
    f32 = torch.float32
    scale = torch.tensor(n_out / n_in, dtype=f32)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(dim=0, keepdim=True)
    eps = float(torch.finfo(f32).eps)
    weights = torch.where(torch.abs(total) > 1000.0 * eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(device)


def resize_cubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """`jax.image.resize(x, (..., out_h, out_w, C), method="cubic")` of
    (B, H, W, C) in float32: an axis whose size does not change is left as
    it is (jax.image.resize resizes only the axes that change)."""
    h, w = x.shape[-3], x.shape[-2]
    y = x.float()
    if out_h != h:
        y = torch.einsum("bhwc,hH->bHwc", y, cubic_weights(h, out_h, x.device))
    if out_w != w:
        y = torch.einsum("bhwc,wW->bhWc", y, cubic_weights(w, out_w, x.device))
    return y
