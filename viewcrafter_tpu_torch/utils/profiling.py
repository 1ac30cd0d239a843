"""Tracing and profiling helpers: the port's own copy of the JAX package's
`utils/profiling.py`.

  - StageTimer: wall-clock seconds per named stage, with a printed summary
    (the same class);
  - trace(logdir): `torch.profiler` around a block, with CUDA activity when
    the card is in use, writing a Chrome / TensorBoard trace into `logdir`
    (the JAX package's `jax.profiler` trace);
  - debug_nans(): a scoped global forward hook on every module that raises on
    the first floating output holding a NaN or an infinity (the JAX
    package's `jax_debug_nans`).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Tuple

import torch


class StageTimer:
    """Accumulates named stage durations.

    with timer.stage("dust3r"): ...
    print(timer.summary())
    """

    def __init__(self):
        self.records: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.records.append((name, time.time() - t0))

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.records:
            out[name] = out.get(name, 0.0) + dt
        return out

    def summary(self) -> str:
        totals = self.totals()
        total = sum(totals.values())
        lines = [f"{'stage':<24}{'sec':>9}{'%':>7}"]
        for name, dt in sorted(totals.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * dt / total if total else 0.0
            lines.append(f"{name:<24}{dt:>9.2f}{pct:>6.1f}%")
        lines.append(f"{'total':<24}{total:>9.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block, with CUDA activity when a card is
    available; on exit one Chrome trace (`trace.json`, which TensorBoard's
    profiler plugin and chrome://tracing read) is written into `logdir`.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, record_shapes=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class NonFiniteError(FloatingPointError):
    """A module's output held a NaN or an infinity under `debug_nans`."""


def _first_bad(out):
    if isinstance(out, torch.Tensor):
        return out if out.is_floating_point() and not bool(torch.isfinite(out).all()) else None
    if isinstance(out, (tuple, list)):
        items = out
    elif isinstance(out, dict):
        items = out.values()
    else:
        return None
    return next((b for b in map(_first_bad, items) if b is not None), None)


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Inside the block, every module's forward output is checked (a
    synchronizing check per module: for debugging, not for timing); the
    first floating tensor with a NaN or an infinity raises NonFiniteError
    naming the module's class."""
    if not enable:
        yield
        return

    def hook(module, args, out):
        bad = _first_bad(out)
        if bad is not None:
            raise NonFiniteError(f"non-finite output of {type(module).__name__} "
                                 f"(shape {tuple(bad.shape)})")

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield
    finally:
        handle.remove()
