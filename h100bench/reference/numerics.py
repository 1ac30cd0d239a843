"""The arithmetic of the reference's products, with a switch to a lower
precision for the control.

"f32": float32 products with TF32 off (the reference). "fp8": both
operands of every product rounded to float8 e4m3 with a per-tensor scale
(amax / 448), then multiplied in float32: the step below the bfloat16 that
the configurations state for the networks. "bf16": operands rounded to
bfloat16: the step below float32, for the sampler's update, which the
configurations state in float32. Norms, softmax and the GELU stay float32
in every mode, as the program keeps them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


class Numerics:
    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """x as the precision holds it, returned in float32."""
        x = x.float()
        if self.mode == "f32":
            return x
        if self.mode == "bf16":
            return x.to(torch.bfloat16).float()
        amax = x.abs().amax().clamp(min=1e-30)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).float() / scale

    def linear(self, x, weight, bias=None):
        y = F.linear(self.round(x), self.round(weight))
        return y if bias is None else y + bias.float()

    def conv2d(self, x, weight, bias=None, stride: int = 1, padding: int = 0):
        """Channels-last (N, H, W, C) in and out."""
        y = F.conv2d(self.round(x).permute(0, 3, 1, 2), self.round(weight),
                     None if bias is None else bias.float(), stride, padding)
        return y.permute(0, 2, 3, 1)

    def matmul(self, a, b):
        return torch.matmul(self.round(a), self.round(b))

    def attention(self, q, k, v, mask=None, budget: int = 1 << 29):
        """Softmax attention, (N, S, H, D) q and (N, L, H, D) k, v ->
        (N, S, H, D), scale D^-0.5, logits and softmax in float32; `mask`
        (S, L) bool, True where a query may attend. The N * H pairs run in
        blocks whose logits hold at most `budget` elements."""
        n, s, h, d = q.shape
        block = max(1, budget // (s * k.shape[1]))
        qh = q.permute(0, 2, 1, 3).reshape(n * h, s, d)
        kh = k.permute(0, 2, 1, 3).reshape(n * h, -1, d)
        vh = v.permute(0, 2, 1, 3).reshape(n * h, -1, d)
        out = torch.empty((n * h, s, d), dtype=torch.float32, device=q.device)
        for lo in range(0, n * h, block):
            hi = min(n * h, lo + block)
            logits = self.matmul(qh[lo:hi], kh[lo:hi].transpose(1, 2)) * d ** -0.5
            if mask is not None:
                logits = logits.masked_fill(~mask, float("-inf"))
            out[lo:hi] = self.matmul(torch.softmax(logits, dim=-1), vh[lo:hi])
        return out.reshape(n, h, s, d).permute(0, 2, 1, 3)


def set_strict_f32() -> None:
    """Float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
