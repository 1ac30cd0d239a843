"""Hand-written Hopper kernels of the port, one module per TPU kernel.

Each module holds the wrapper (CUDA tensor -> kernel launch, or raise), the
plain torch twin of the same arithmetic (used for CPU tensors), the launch
counter `launches`, the launches per input shape `sites`, and the copy of
the JAX package's gate for that kernel.
"""

from viewcrafter_tpu_torch.ops.kernels import (  # noqa: F401
    cross_attention,
    ff_layer,
    fullkv_attention,
    groupnorm,
    spatial_layer,
    temporal_attention,
    temporal_conv,
    temporal_layer,
)

KERNEL_MODULES = {
    "temporal_conv3": temporal_conv,
    "fused_ff_layer": ff_layer,
    "fullkv_attention": fullkv_attention,
    "fused_temporal_layer": temporal_layer,
    "group_norm_fused": groupnorm,
    "dual_cross_attention": cross_attention,
    "temporal_attention_fused": temporal_attention,
    "fused_spatial_layer": spatial_layer,
}


def reset_launches() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
        mod.sites = {}
        if hasattr(mod, "backward_plain"):
            mod.backward_plain = 0
            mod.backward_sites = {}


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def backward_plain_counts() -> dict:
    """Per kernel with a backward, its backward passes since the last reset."""
    return {name: mod.backward_plain for name, mod in KERNEL_MODULES.items()
            if hasattr(mod, "backward_plain")}


def backward_sites() -> dict:
    """Per kernel with a backward, its backward passes per launch site since
    the last reset."""
    return {name: dict(mod.backward_sites) for name, mod in KERNEL_MODULES.items()
            if hasattr(mod, "backward_sites")}


def launch_sites() -> dict:
    """Per kernel, the input shapes launched since the last reset -> count."""
    return {name: dict(mod.sites) for name, mod in KERNEL_MODULES.items()}
