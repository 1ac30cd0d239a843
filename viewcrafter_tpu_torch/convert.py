"""Carry the JAX package's parameter trees across to the port.

The port names its submodules after the flax scopes, so the mapping is a
mechanical walk over each flax tree:
  - Dense `kernel` (in, out)            -> `weight` (out, in)
  - Conv `kernel` (kh, kw, in, out)      -> `weight` (out, in, kh, kw)
  - Conv3d `kernel` (3, 1, 1, in, out)   -> `weight` (out, in, 3, 1, 1)
  - ConvTranspose `kernel` (kh, kw, in, out), at the scopes named as such
                                         -> `weight` (in, out, kh, kw) with both
                                            spatial axes flipped (flax does not
                                            flip the kernel, torch's
                                            ConvTranspose2d does)
  - `GroupNorm_0`/`LayerNorm_0` {scale, bias} -> the norm's {weight, bias}
  - Embed `embedding`                    -> `weight`
  - any other leaf keeps its name.

Input: numpy arrays (convert jax arrays with `np.asarray` first), one tree
per submodel; a flax `{"params": ...}` wrapper is accepted. The released
torch checkpoints load through `utils/checkpoint.py`.
"""

from __future__ import annotations

from typing import Collection, Mapping

import numpy as np
import torch

from viewcrafter_tpu_torch.models.lvdm import SUBMODELS

_NORM_SCOPES = ("GroupNorm_0", "LayerNorm_0")


def _flatten(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def convert_tree(tree: Mapping, conv_transpose: Collection[str] = ()) -> dict:
    """One flax parameter tree -> a port state dict (float32 tensors). Every
    leaf lands in exactly one entry; two leaves mapping to one name raise.
    conv_transpose: the scope names (the last scope of a path) whose rank-4
    kernels belong to a ConvTranspose; a rank-4 kernel under any other scope
    is a Conv's."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf, dtype=np.float32)
        *scope, name = path
        if scope and scope[-1] in _NORM_SCOPES:
            scope = scope[:-1]
            name = {"scale": "weight", "bias": "bias"}[name]
        elif name == "kernel":
            name = "weight"
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4 and scope and scope[-1] in conv_transpose:
                arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 5:
                arr = arr.transpose(4, 3, 0, 1, 2)
            else:
                raise ValueError(f"unexpected kernel rank {arr.ndim} at {'/'.join(path)}")
        elif name == "embedding":
            name = "weight"
        key = ".".join(list(scope) + [name])
        if key in state:
            raise ValueError(f"two flax leaves map to {key}")
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def from_jax_params(params) -> dict:
    """The JAX package's `LVDMParams` (or a mapping with its five fields) of
    numpy trees -> {submodel: port state dict}, ready for
    `VideoDiffusionEngine.load_params`."""
    get = params.get if isinstance(params, Mapping) else lambda n: getattr(params, n)
    return {name: convert_tree(get(name)) for name in SUBMODELS}


DUST3R_CONV_TRANSPOSE = ("act1_up", "act2_up")  # the DPT heads' ConvTranspose scopes


def dust3r_from_jax_params(params) -> dict:
    """The JAX package's `Dust3rModel` parameter tree (numpy leaves, with or
    without the `{"params": ...}` wrapper) -> a state dict for the port's
    `models.dust3r.Dust3rModel`."""
    return convert_tree(params, conv_transpose=DUST3R_CONV_TRANSPOSE)


def croco_pretrain_from_jax_params(params) -> dict:
    """The JAX package's `CroCoPretrain` parameter tree -> a state dict for
    the port's `models.croco_pretrain.CroCoPretrain` (the mask token keeps
    its name and shape)."""
    return convert_tree(params)


def croco_downstream_from_jax_params(params) -> dict:
    """The JAX package's `CroCoDownstreamBinocular` or
    `CroCoDownstreamMonocularEncoder` parameter tree -> a state dict for the
    port's model of the same name (`models.croco_downstream`); the DPT
    head's ConvTranspose kernels flipped as in `dust3r_from_jax_params`."""
    return convert_tree(params, conv_transpose=DUST3R_CONV_TRANSPOSE)
