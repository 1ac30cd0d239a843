"""Image resize helpers on channels-last tensors (..., H, W, C).

The port of the JAX package's `ops/resize.py`:
  - `resize_bilinear_align_corners`: torch's F.interpolate(mode='bilinear',
    align_corners=True), which the DPT fusion blocks and head use
    (extern/dust3r/croco/models/dpt_block.py:137-139,321). Computed as the
    JAX package computes it (two gathers per axis, the same weights), so the
    two agree to the last bits.
  - `resize_bilinear`: half-pixel bilinear (`jax.image.resize`'s "bilinear",
    torch's align_corners=False), the render -> diffusion-resolution upsample
    (viewcrafter.py:158). For an upsample, torch's clamped source coordinate
    and jax.image.resize's renormalised border weights give the same values;
    a downsample would need jax.image.resize's antialiasing, which this
    function refuses.
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
    """Half-pixel bilinear upsample (or identity) of (..., H, W, C) in float32."""
    h, w, c = x.shape[-3:]
    if out_h < h or out_w < w:
        raise NotImplementedError(
            "resize_bilinear downsamples only with antialiasing, which is not ported yet "
            "(see ROADMAP.md)")
    if (out_h, out_w) == (h, w):
        return x.float().clone()
    lead = x.shape[:-3]
    nchw = x.float().reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(nchw, size=(out_h, out_w), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)
