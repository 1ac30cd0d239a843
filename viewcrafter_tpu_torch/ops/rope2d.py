"""2D rotary position embedding (RoPE2D) as plain torch ops.

The port of the JAX package's `ops/rope2d.py`, itself the reference's cuRoPE
op and its torch fallback (extern/dust3r/croco/models/curope/kernels.cu:18-108,
extern/dust3r/croco/models/pos_embed.py:112-159): split the head dim in half,
rotate the first half by the token's y position and the second half by its x
position, each with a standard 1D RoPE of base `freq`, with the torch-side
[-x2; x1] "rotate_half" pairing (pairs are (i, i + D/2) within each half, not
interleaved). cos and sin are computed in float32 and cast to the token type
before the products, as in the JAX package. The JAX package has no Pallas
kernel here, so neither has the port.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _inv_freq(half_dim: int, base: float) -> np.ndarray:
    return np.asarray(1.0 / (base ** (np.arange(0, half_dim, 2, dtype=np.float64) / half_dim)),
                      np.float32)


def _rope_1d(tokens: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """tokens: (..., S, D), pos: broadcastable (..., S) integer positions."""
    d = tokens.shape[-1]
    inv = torch.from_numpy(_inv_freq(d, base)).to(tokens.device)
    ang = pos[..., None].float() * inv  # (..., S, D/2)
    ang = torch.cat([ang, ang], dim=-1)  # (..., S, D)
    cos, sin = torch.cos(ang).to(tokens.dtype), torch.sin(ang).to(tokens.dtype)
    x1, x2 = tokens.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    return tokens * cos + rotated * sin


def rope_2d(tokens: torch.Tensor, positions: torch.Tensor, base: float = 100.0) -> torch.Tensor:
    """tokens: (B, S, H, D) with D % 4 == 0; positions: (B, S, 2) int (y, x).
    Returns the same shape and dtype."""
    assert tokens.shape[-1] % 4 == 0, "head dim must be divisible by 4 for RoPE2D"
    y_tok, x_tok = tokens.chunk(2, dim=-1)
    pos_y = positions[..., 0][..., None]  # (B, S, 1): broadcast over heads
    pos_x = positions[..., 1][..., None]
    return torch.cat([_rope_1d(y_tok, pos_y, base), _rope_1d(x_tok, pos_x, base)], dim=-1)
