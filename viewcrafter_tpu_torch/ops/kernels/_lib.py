"""Build and load the hand-written CUDA kernels (`viewcrafter_tpu_torch/csrc`).

Each `.cu` source is compiled by its own `nvcc` process, all started together,
for `sm_90a`; the objects are linked into one shared library with a plain C
interface, loaded with ctypes. The library's name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the cached build. The build directory (`_build/` beside this package's
sources) is git-ignored; nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

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
    """The checks every wrapper makes before it hands a pointer to a kernel."""
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
