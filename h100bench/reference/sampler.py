"""DDIM with v-prediction, classifier-free guidance and its rescale, in plain
NumPy and PyTorch, from the published formulas (DynamiCrafter's
`lvdm/models/utils_diffusion.py`, `ddpm3d.py` and `samplers/ddim.py`):

- linear betas on sqrt scale, rescaled to zero terminal SNR
  (arXiv:2305.08891, Alg. 1);
- DDIM timesteps `uniform_trailing`: round(arange(T, 0, -T/n)) - 1, ascending;
- sigma_i = eta * sqrt((1 - a_prev) / (1 - a) * (1 - a / a_prev));
- the dynamic rescale of the predicted x0 by scale_arr[t_prev] / scale_arr[t]
  (a linear ramp from 1 to `base_scale` over `turning_step` steps), with the
  first step's previous scale taken at index 0;
- CFG v = v_u + s (v_c - v_u), then v <- r v std(v_c) / std(v) + (1 - r) v.

Step i runs from the largest t down; schedule arrays are in that order.
"""

from __future__ import annotations

import numpy as np
import torch


class Schedule:
    def __init__(self, diffusion: dict, steps: int, eta: float):
        d = diffusion
        n = d["timesteps"]
        betas = np.linspace(d["linear_start"] ** 0.5, d["linear_end"] ** 0.5, n,
                            dtype=np.float64) ** 2
        if d["rescale_betas_zero_snr"]:
            abar = np.sqrt(np.cumprod(1.0 - betas))
            a0, at = abar[0], abar[-1]
            abar = (abar - at) * a0 / (a0 - at)
            abar = abar ** 2
            alphas = np.concatenate([abar[:1], abar[1:] / abar[:-1]])
            betas = 1.0 - alphas
        acp = np.cumprod(1.0 - betas).astype(np.float32).astype(np.float64)
        ts = np.flip(np.round(np.arange(n, 0, -n / steps))).astype(np.int64) - 1
        a = acp[ts]
        a_prev = np.concatenate([acp[:1], acp[ts[:-1]]])
        sigma = eta * np.sqrt((1 - a_prev) / (1 - a) * (1 - a / a_prev))
        self.scale = self.scale_prev = None
        if d["use_dynamic_rescale"]:
            ramp = np.concatenate([np.linspace(1.0, d["base_scale"], d["turning_step"]),
                                   np.full(n, d["base_scale"])]).astype(np.float32)
            sc = ramp[ts]
            self.scale = sc[::-1].astype(np.float64)
            self.scale_prev = np.concatenate([ramp[:1], sc[:-1]])[::-1].astype(np.float64)
        rev = lambda x: np.asarray(x, np.float32)[::-1].astype(np.float64)
        self.t = ts[::-1].copy()
        self.a, self.a_prev, self.sigma = rev(a), rev(a_prev), rev(sigma)
        self.steps = steps


def guide(v_all, scale: float, rescale: float):
    """v of the [uncond, cond] branches stacked on dim 0 -> guided v."""
    v_u, v_c = v_all.float().chunk(2, dim=0)
    v = v_u + scale * (v_c - v_u)
    if rescale > 0:
        axes = tuple(range(1, v.ndim))
        std_c = v_c.std(dim=axes, keepdim=True, correction=0)
        std_v = v.std(dim=axes, keepdim=True, correction=0)
        v = rescale * (v * std_c / std_v.clamp(min=1e-8)) + (1 - rescale) * v
    return v


def update(sched: Schedule, i: int, x, v, noise, round_=lambda t: t):
    """x after DDIM step i from the guided v. `round_` rounds every operand
    (the control's lower precision)."""
    x, v, noise = round_(x.float()), round_(v.float()), round_(noise.float())
    sa, s1a = np.sqrt(sched.a[i]), np.sqrt(1.0 - sched.a[i])
    eps = round_(sa * v + s1a * x)
    x0 = round_(sa * x - s1a * v)
    if sched.scale is not None:
        x0 = round_(x0 * (sched.scale_prev[i] / sched.scale[i]))
    ap, sg = sched.a_prev[i], sched.sigma[i]
    return round_(np.sqrt(ap) * x0 + np.sqrt(max(1.0 - ap - sg ** 2, 0.0)) * eps + sg * noise)


def timesteps(sched: Schedule, i: int, n: int, device) -> torch.Tensor:
    return torch.full((n,), float(sched.t[i]), dtype=torch.float32, device=device)
