"""Build and load the hand-written CUDA kernels (`viewcrafter_tpu_torch/csrc`),
and give them a backward.

Each `.cu` source is compiled by its own `nvcc` process, all started together,
for `sm_90a`; the objects are linked into one shared library with a plain C
interface, loaded with ctypes. The library's name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the cached build. The build directory (`_build/` beside this package's
sources) is git-ignored; nothing is built when a module is imported.

Gradients (`KernelFunction`, `launch`): the JAX package's kernels have no
VJP and none is written for the card either. A wrapper called under grad
mode with an input that requires grad goes through `KernelFunction`: its
forward launches the kernel as the wrapper does, saves the inputs, and its
backward recomputes the kernel's plain twin on them under `enable_grad` and
returns the twin's VJP for every input that needs one (weights and biases
included), one batch chunk at a time where the twin chunks its logits. Each
backward adds one to the kernel module's `backward_plain`, and one to its
`backward_sites` at the launch site (the `sites` key) its forward counted.
A launch that bypasses the Function with such an input raises (`require`),
so no kernel drops the graph silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from types import ModuleType
from typing import Callable, NamedTuple, Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
SOURCES = ("runtime.cu", "temporal_conv.cu", "ff_layer.cu", "fullkv_attention.cu",
           "temporal_layer.cu", "groupnorm.cu", "cross_attention.cu", "temporal_attention.cu",
           "spatial_layer.cu")
HEADERS = ("common.cuh", "hopper.cuh", "gemm_sm90.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_F = ctypes.c_float
# argtypes of every exported C function: pointers and the stream as void*
_SIGNATURES = {
    "vc_temporal_conv3": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _P),
    "vc_ff_layer": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _F, _P),
    "vc_fullkv_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "vc_temporal_layer": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _F, _F, _P),
    "vc_group_norm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "vc_group_norm_blocks": (_I,),
    "vc_dual_cross_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "vc_temporal_attention": (_P, _P, _P, _P, _I, _I, _L, _I, _F, _P),
    "vc_spatial_layer": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _F, _F, _P),
}

_lib = None
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the build of the current sources lives (it may not exist yet)."""
    return BUILD_DIR / f"libvc_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the kernels (if this source set has no build yet) and return
    the path of the shared library."""
    global build_log
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        build_log = log.read_text() if log.exists() else ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, _, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {name}\n{text}")
            if p.returncode:
                failed.append(name)
        build_log = "\n".join(logs)
        log.write_text(build_log)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", *[str(o) for _, o, _ in procs], "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
        os.replace(tmp_lib, out)  # atomic: a concurrent build sees all or nothing
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.vc_error_string.argtypes = (ctypes.c_int,)
        handle.vc_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its cudaGetLastError
    right after a launch)."""
    if err:
        msg = lib().vc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """The checks every wrapper makes before it hands a pointer to a kernel.
    An input that requires grad under grad mode raises: the launch would
    return an output without a graph (a wrapper with a backward launches
    through `KernelFunction`, whose forward runs without grad mode)."""
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{name} requires grad under grad mode, and this launch has no "
                           "backward (a wrapper with one launches through KernelFunction): "
                           "run it under torch.no_grad()")
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)} (got {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


# --------------------------------------------------------------------------
# the backward: the plain twin's VJP
# --------------------------------------------------------------------------


class KernelSpec(NamedTuple):
    """One kernel call as `KernelFunction` sees it: `run` launches the
    kernel, `twin` is its plain torch version (both take the call's tensors
    positionally, with its other arguments bound), `module` the kernel's
    module (its `backward_plain` and `backward_sites` count the backward
    passes), `chunk` the rows of dim 0 the twin's VJP takes at a time (None:
    all at once; every input then shares that batch dim)."""

    run: Callable
    twin: Callable
    module: ModuleType
    chunk: Optional[int] = None


class KernelFunction(torch.autograd.Function):
    """Forward: the kernel. Backward: the twin's VJP at the saved inputs."""

    @staticmethod
    def forward(ctx, spec: KernelSpec, *inputs):
        ctx.spec = spec
        ctx.save_for_backward(*inputs)
        before = dict(spec.module.sites)
        out = spec.run(*inputs)
        # the site this launch counted (None for a `run` that counts none)
        ctx.site = next((k for k, n in spec.module.sites.items() if n != before.get(k, 0)), None)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        spec = ctx.spec
        spec.module.backward_plain += 1
        if ctx.site is not None:
            spec.module.backward_sites[ctx.site] = spec.module.backward_sites.get(ctx.site, 0) + 1
        return (None, *twin_vjp(spec, ctx.saved_tensors, ctx.needs_input_grad[1:], grad))


def twin_vjp(spec: KernelSpec, inputs, needs, grad) -> list:
    """The gradients of spec.twin(*inputs) against `grad` for each input
    whose `needs` is set (None for the others), computed chunk by chunk
    along dim 0 when `spec.chunk` is set, so that one chunk's graph lives at
    a time."""
    n = inputs[0].shape[0]
    step = spec.chunk or n
    wanted = [i for i, need in enumerate(needs) if need]
    parts = {i: [] for i in wanted}
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        with torch.enable_grad():
            xs = [t if spec.chunk is None else t[lo:hi] for t in inputs]
            xs = [t.detach().requires_grad_(need) for t, need in zip(xs, needs)]
            out = spec.twin(*xs)
            got = torch.autograd.grad(out, [xs[i] for i in wanted],
                                      grad if spec.chunk is None else grad[lo:hi],
                                      allow_unused=True)
        for i, g in zip(wanted, got):
            parts[i].append(torch.zeros_like(xs[i]) if g is None else g)
    grads = [None] * len(inputs)
    for i in wanted:
        grads[i] = parts[i][0] if len(parts[i]) == 1 else torch.cat(parts[i])
    return grads


def launch(spec: KernelSpec, *inputs: torch.Tensor) -> torch.Tensor:
    """Launch the kernel of `spec` on `inputs`: through `KernelFunction`
    under grad mode when an input requires grad, else directly."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return KernelFunction.apply(spec, *inputs)
    return spec.run(*inputs)
