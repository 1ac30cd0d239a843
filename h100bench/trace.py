"""Reduction of a torch.profiler trace of the measured window to what the
per-layer metrics and the breakdown read.

The window is cut into stages by marker kernels: at each stage boundary the
harness synchronises, notes the host clock and launches one
`torch.cuda._sleep` kernel, so that the i-th marker on the device timeline
is the i-th boundary on the host. Busy time is the union of the device
operations' intervals, not the sum of their durations.
"""

from __future__ import annotations

import dataclasses

MARKER = "spin_kernel"

# kernel-name patterns of the device-time categories, tried in order
# (the patterns of the port's kernels: its CUDA namespace `vc::` and the
# loader functors of its GEMM core)
PROFILE_CATEGORIES = (
    ("port:fullkv", "vc::fullkv_kernel"), ("port:temporal_attention", "vc::temporal_att"),
    ("port:dual_cross_attention", "vc::dual_cross_kernel"),
    ("port:group_norm", "vc::group_norm_kernel"), ("port:frame_attention", "vc::frame_attention"),
    ("port:layernorm", "vc::ln_apply_kernel"), ("port:temporal_conv", "LoadConv3"),
    ("port:ff_gemm1_geglu", "LoadGeglu"), ("port:gemm_plain", "LoadPlain"),
    ("cudnn_conv", "fprop"), ("cudnn_conv", "conv"), ("cublas_gemm", "gemm"),
    ("cublas_gemm", "nvjet"), ("softmax", "softmax"), ("reduce", "reduce"),
    ("elementwise", "elementwise"), ("cat", "Cat"), ("memcpy", "Memcpy"), ("memset", "Memset"),
)

HAND_WRITTEN = "vc::"


def category(name: str) -> str:
    return next((c for c, pat in PROFILE_CATEGORIES if pat in name), "other")


@dataclasses.dataclass
class Op:
    name: str
    start: float  # seconds on the trace's clock
    end: float


@dataclasses.dataclass
class Stage:
    name: str
    start: float
    end: float
    ops: list


def device_ops(prof) -> list:
    """Every device operation of a profile, in start order, in seconds."""
    import torch

    out = []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(evt, "is_user_annotation", False):
            continue
        r = evt.time_range
        out.append(Op(evt.name, r.start * 1e-6, r.end * 1e-6))
    out.sort(key=lambda o: o.start)
    return out


def is_marker(op: Op) -> bool:
    return MARKER in op.name


def stages(ops: list, names: list) -> list:
    """Cut the timeline at the markers: stage k runs from marker k to marker
    k + 1 and takes the name of the boundary that closes it (names[k + 1])."""
    marks = [o for o in ops if is_marker(o)]
    if len(marks) != len(names):
        raise RuntimeError(f"{len(marks)} marker kernels on the device, {len(names)} on the host")
    work = [o for o in ops if not is_marker(o)]
    out, j = [], 0
    for k in range(len(marks) - 1):
        lo, hi = marks[k].end, marks[k + 1].start
        inside = []
        while j < len(work) and work[j].start < hi:
            if work[j].start >= lo:
                inside.append(work[j])
            j += 1
        out.append(Stage(names[k + 1], lo, hi, inside))
    return out


def union(intervals) -> list:
    """Merged [start, end] intervals of (start, end) pairs."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_seconds(ops, lo: float, hi: float) -> float:
    spans = union((max(o.start, lo), min(o.end, hi)) for o in ops if o.end > lo and o.start < hi)
    return sum(b - a for a, b in spans)


def idle_gaps(st: list) -> list:
    """(stage name, seconds) of every stretch of a stage with no operation."""
    gaps = []
    for s in st:
        t = s.start
        for a, b in union((o.start, o.end) for o in s.ops):
            if a > t:
                gaps.append((s.name, a - t))
            t = max(t, b)
        if s.end > t:
            gaps.append((s.name, s.end - t))
    return gaps


def breakdown(st: list, top: int = 10) -> dict:
    by_name = {}
    for s in st:
        for o in s.ops:
            key = f"{category(o.name)}|{o.name[:80]}"
            by_name[key] = by_name.get(key, 0.0) + (o.end - o.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(st), key=lambda g: -g[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
