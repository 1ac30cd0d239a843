"""Shared NN primitives, channels-last, as in the JAX package's models/layers.py.

Mixed-precision policy (the JAX package's): matmuls/convs run in the module
dtype (bf16 on the card), normalizations and softmax in float32. Norm
parameters stay float32; the engine casts every other weight to the module
dtype once (`cast_weights`), which is what the JAX package does at each use.

Tensors are channels-last: images (B, H, W, C), videos (B, T, H, W, C),
tokens (B, S, C). Convolutions permute to NCHW views internally.

Submodule and parameter names follow the flax scopes, so that `convert.py`
maps a flax tree onto this one mechanically (`GroupNorm_0`/`LayerNorm_0`
levels fold into the norm module itself).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from viewcrafter_tpu_torch.ops.kernels import ff_layer as _ff
from viewcrafter_tpu_torch.ops.kernels import groupnorm as _gn
from viewcrafter_tpu_torch.parallel.mesh import NO_AXIS, Axis
from viewcrafter_tpu_torch.utils import profiling


def group_norm_silu(x, weight, bias, num_groups: int = 32, eps: float = 1e-5,
                    with_silu: bool = True):
    """GroupNorm over channels-last x (N, ..., C): f32 statistics over every
    middle axis and the channel group, affine, optional SiLU; the plain path
    of the JAX package's `ops/pallas/groupnorm.py:group_norm_silu`."""
    shape = x.shape
    n, c = shape[0], shape[-1]
    xs = x.reshape(n, -1, num_groups, c // num_groups).float()
    var, mean = torch.var_mean(xs, dim=(1, 3), keepdim=True, correction=0)
    # (x - mean) * rsqrt(var + eps) * w + b as one multiply-add per element:
    # x * scale + shift with per-(sample, channel) scale and shift
    scale = torch.rsqrt(var + eps) * weight.float().reshape(num_groups, -1)
    shift = bias.float().reshape(num_groups, -1) - mean * scale
    y = torch.addcmul(shift, xs, scale)
    if with_silu:
        y = F.silu(y)
    return y.to(x.dtype).reshape(shape)


class GroupNorm32(nn.Module):
    """GroupNorm in float32 with an optional fused SiLU; output in the
    input's dtype.

    `fused` (off by default here, on in the engine's UNet and VAE; set
    through `set_group_norm_fused`) routes every input the route's gate takes
    through `ops/kernels/groupnorm.py:group_norm_fused`: the CUDA kernel on
    a CUDA tensor, its plain twin on a CPU tensor. The gate is the kernel's
    (`supports_group_norm`), and on a CUDA tensor also at most as many
    samples as its cooperative grid holds (`target_blocks`); anything else
    takes `group_norm_silu`, counted as `group_norm_plain` inside
    `profiling.recording()`."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 with_silu: bool = False):
        super().__init__()
        self.num_groups, self.eps, self.with_silu = num_groups, eps, with_silu
        self.fused = False
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        if self.fused:
            x3 = x.reshape(x.shape[0], -1, x.shape[-1])
            if self._route_takes(x3):
                y = _gn.group_norm_fused(x3.contiguous(), self.weight, self.bias,
                                         self.num_groups, self.eps, self.with_silu)
                return y.reshape(x.shape)
            profiling.count("group_norm_plain", 1)
        return group_norm_silu(x, self.weight, self.bias, self.num_groups, self.eps,
                               self.with_silu)

    def _route_takes(self, x3) -> bool:
        itemsize = x3.element_size()
        return _gn.supports_group_norm(x3.shape, self.num_groups, itemsize) and (
            not _kernel_runs(x3) or x3.shape[0] <= _gn.target_blocks(itemsize))


def _kernel_runs(x) -> bool:
    """Whether `group_norm_fused` launches the CUDA kernel on x rather than
    running its twin."""
    return x.is_cuda


def set_group_norm_fused(module: nn.Module, on: bool) -> nn.Module:
    """Switch the fused-GroupNorm route of every GroupNorm32 under `module`."""
    for mod in module.modules():
        if isinstance(mod, GroupNorm32):
            mod.fused = bool(on)
    return module


def layer_norm_f32(x, weight, bias, eps: float = 1e-5):
    """Two-pass f32 LayerNorm over the last axis, output in x.dtype."""
    return _ff._layer_norm(x, weight, bias, eps)


class LayerNormF32(nn.Module):
    """LayerNorm in float32 (torch default eps=1e-5), output cast back. Also
    serves as the parameter holder of norms that a kernel applies."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)



class Conv(nn.Conv2d):
    """nn.Conv2d on channels-last (N, H, W, C) tensors."""

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias, self.stride,
                     self.padding)
        return y.permute(0, 2, 3, 1)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)


class FeedForward(nn.Module):
    """Transformer MLP with GEGLU gating (h | gate split order, exact erf
    GELU on the gate in f32).

    `ln`: the preceding LayerNormF32, applied inside so that on the card the
    whole branch runs through the `fused_ff_layer` kernels when the JAX
    package's gate would run its Pallas kernel there. `tp`: the hidden
    split (`parallel/tp.py`): this rank's block of the GEGLU hidden, then
    one all-reduce of the out product."""

    tp: Axis = NO_AXIS

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.dim, self.inner = dim, dim * mult
        self.geglu = GEGLU(dim, self.inner)
        self.out = nn.Linear(self.inner, dim)

    def forward(self, x, ln: Optional[LayerNormF32] = None):
        return self.tp.sum(self._local(x, ln))

    def _local(self, x, ln):
        w1, b1 = self.geglu.proj.weight, self.geglu.proj.bias
        w2, b2 = self.out.weight, self.out.bias
        if (ln is not None and x.is_cuda
                and _ff.supports_fused_ff(x.shape, self.dim, self.inner,
                                          itemsize=x.element_size())):
            return _ff.fused_ff_layer(x, ln.weight, ln.bias, w1, b1, w2, b2)
        if ln is not None:
            x = layer_norm_f32(x, ln.weight, ln.bias)
        y = F.linear(x, w1, b1)
        h, gate = y.chunk(2, dim=-1)
        g = h * F.gelu(gate.float(), approximate="none").to(h.dtype)
        return F.linear(g, w2, b2)


def silu(x):
    """SiLU with an f32 sigmoid."""
    return x * torch.sigmoid(x.float()).to(x.dtype)


def _cast_targets(module: nn.Module):
    """`module` and its submodules, without the norms and without the
    subtrees of modules that set `float32_module` (they compute in float32)."""
    if isinstance(module, (GroupNorm32, LayerNormF32)) or getattr(module, "float32_module", False):
        return
    yield module
    for child in module.children():
        yield from _cast_targets(child)


def cast_weights(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every parameter outside the norm modules to `dtype`; norm
    parameters stay float32, and so do those a module lists in its
    `float32_params` and every parameter under a module that sets
    `float32_module`. Conv weights are stored channels-last, the layout of
    the activations, so cuDNN does not re-layout them per call."""
    for mod in _cast_targets(module):
        keep = getattr(mod, "float32_params", ())
        for name, p in mod.named_parameters(recurse=False):
            if name not in keep:
                p.data = p.data.to(dtype)
        if isinstance(mod, Conv):
            mod.weight.data = mod.weight.data.contiguous(memory_format=torch.channels_last)
    return module


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights in every parameter of `module`, none zero:
    weights of fan-in `f` ~ N(0, 1/f), biases ~ N(0, 0.02^2), norm scales
    1 + N(0, 0.05^2) and norm biases N(0, 0.05^2), drawn from `generator` (on
    the parameters' device) module by module in registration order."""
    for mod in module.modules():
        is_norm = isinstance(mod, (GroupNorm32, LayerNormF32))
        for pname, p in mod.named_parameters(recurse=False):
            noise = torch.randn(p.shape, generator=generator, device=p.device)
            if is_norm:
                val = noise * 0.05 + (1.0 if pname == "weight" else 0.0)
            elif p.ndim == 1:
                val = noise * 0.02
            else:
                fan_in = p[0].numel() if pname == "weight" else p.shape[-1]
                val = noise * fan_in ** -0.5
            p.copy_(val)
    return module
