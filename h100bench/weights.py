"""Seeded weights for the benchmark's networks, made on the device.

One `torch.randn` call fills a flat buffer in the type the networks are
served in (bfloat16); each parameter is a view of it, scaled: norm scales
1 + 0.05 N, norm shifts 0.05 N, other vectors 0.02 N, matrices and kernels
N / sqrt(fan_in) (fan_in: a weight's elements per output, else its last
size). The program and the reference load the same values; the reference
makes them anew from the seed, so it takes nothing the program holds.
"""

from __future__ import annotations

import torch

from h100bench.reference.models import DiffusionModels, Norm


def layout(cfg: dict):
    """[(group, name, shape, rule)] of every parameter, in a fixed order,
    from the reference's modules (built on the meta device: no memory)."""
    with torch.device("meta"):
        nets = DiffusionModels(cfg)
    out = []
    for group, net in nets.named_children():
        for mod_name, mod in net.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                name = f"{mod_name}.{pname}" if mod_name else pname
                if isinstance(mod, Norm):
                    rule = "norm_scale" if pname == "weight" else "norm_shift"
                elif p.ndim == 1:
                    rule = "vector"
                else:
                    fan_in = p[0].numel() if pname == "weight" else p.shape[-1]
                    rule = fan_in ** -0.5
                out.append((group, name, tuple(p.shape), rule))
    return out


@torch.no_grad()
def make(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{group: {name: tensor}} of views into one seeded buffer."""
    params = layout(cfg)
    total = sum(torch.Size(shape).numel() for _, _, shape, _ in params)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    state, off = {}, 0
    for group, name, shape, rule in params:
        n = torch.Size(shape).numel()
        view = flat[off:off + n].view(shape)
        off += n
        if rule == "norm_scale":
            view.mul_(0.05).add_(1.0)
        elif rule == "norm_shift":
            view.mul_(0.05)
        elif rule == "vector":
            view.mul_(0.02)
        else:
            view.mul_(rule)
        state.setdefault(group, {})[name] = view
    return state


def weight_seed(seed: int) -> int:
    return (seed * 2654435761 + 97) % (1 << 62)
