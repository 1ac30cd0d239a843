"""Exponential moving average of the training parameters: the port of the
JAX package's utils/ema.py (the reference's LitEma, lvdm/ema.py:5-76).

The decay warms up as min(decay, (1 + n) / (10 + n)), with n the number of
updates before this one; n = -1 turns the warmup off. The shadow is a float32
copy of every master weight, updated in place (the JAX version returns a new
tree) as shadow - (1 - d) * (shadow - p) in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

GROUP = 64  # tensors per group of the foreach update (bounds its scratch)


@dataclasses.dataclass
class EmaState:
    shadow: Dict[str, torch.Tensor]
    num_updates: int  # -1 disables the warmup


def ema_init(params: Dict[str, torch.Tensor], use_num_updates: bool = True) -> EmaState:
    return EmaState(shadow={k: v.detach().float().clone() for k, v in params.items()},
                    num_updates=0 if use_num_updates else -1)


@torch.no_grad()
def ema_update(state: EmaState, params: Dict[str, torch.Tensor],
               decay: float = 0.9999) -> EmaState:
    """One update of the shadow towards `params`, in place; returns `state`.
    The decay and 1 - decay in float32, as jnp computes them."""
    n, d = state.num_updates, np.float32(decay)
    if n >= 0:
        d = min(d, np.float32(1.0 + n) / np.float32(10.0 + n))
    one_minus = float(np.float32(1.0) - d)
    keys = list(state.shadow)
    for i in range(0, len(keys), GROUP):
        group = keys[i:i + GROUP]
        shadow = [state.shadow[k] for k in group]
        diff = torch._foreach_sub(shadow, [params[k].float() for k in group])
        torch._foreach_mul_(diff, one_minus)
        torch._foreach_sub_(shadow, diff)
    if state.num_updates >= 0:
        state.num_updates += 1
    return state


def ema_params(state: EmaState) -> Dict[str, torch.Tensor]:
    """The averaged parameters (the reference's copy_to)."""
    return state.shadow
