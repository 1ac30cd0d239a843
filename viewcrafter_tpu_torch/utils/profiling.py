"""Tracing and profiling helpers: the port's own copy of the JAX package's
`utils/profiling.py`, and the program's span recorder.

  - span(name) / count(name, value): spans at the program's layer
    boundaries and counters beside them, recorded only inside
    `recording()`; off (the default), a span is one flag test and a shared
    no-op object;
  - recording(): switches the recorder on for a block and hands back what
    it recorded (`Records`);
  - StageTimer: seconds per named stage, with a printed summary (the JAX
    package's class), a view of a `Recorder` of its own;
  - trace(logdir): `torch.profiler` around a block, with CUDA activity when
    the card is in use, writing a Chrome / TensorBoard trace into `logdir`
    (the JAX package's `jax.profiler` trace); the spans show in it as
    `record_function` ranges;
  - debug_nans(): a scoped global forward hook on every module that raises on
    the first floating output holding a NaN or an infinity (the JAX
    package's `jax_debug_nans`).

A span's clock is `time.perf_counter_ns()` (CLOCK_MONOTONIC on Linux), the
host clock a benchmark maps onto a device trace's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass
class SpanRecord:
    """One span: `parent` is the index of the enclosing record in the same
    list (None at a root); `request` is the root's, inherited; times in
    `perf_counter_ns`. `step` and `kind` are a sampling step's index and
    kind ("step", "full" or "reuse")."""

    name: str
    request: Optional[int]
    parent: Optional[int]
    start_ns: int
    end_ns: int = 0
    step: Optional[int] = None
    kind: Optional[str] = None


@dataclasses.dataclass
class Records:
    """What a recorder holds: its spans in start order, and each counter's
    values in the order counted."""

    spans: List[SpanRecord] = dataclasses.field(default_factory=list)
    counters: Dict[str, list] = dataclasses.field(default_factory=dict)


class _NoSpan:
    """The span of a recorder that is off: enters and exits, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec", "name", "request", "step", "kind", "index", "range")

    def __init__(self, rec, name, request, step, kind):
        self.rec, self.name, self.request, self.step, self.kind = rec, name, request, step, kind
        self.range = None

    def __enter__(self):
        rec = self.rec
        spans = rec.records.spans
        parent = rec.open[-1] if rec.open else None
        request = self.request
        if request is None and parent is not None:
            request = spans[parent].request
        if rec.ranges:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.index = len(spans)
        rec.open.append(self.index)
        spans.append(SpanRecord(self.name, request, parent, time.perf_counter_ns(),
                                step=self.step, kind=self.kind))
        return None

    def __exit__(self, *exc):
        rec = self.rec
        rec.records.spans[self.index].end_ns = time.perf_counter_ns()
        rec.open.pop()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        return False


class Recorder:
    """Spans and counters into one `Records`. `ranges`: each span also opens
    a `torch.profiler.record_function` range of its name (set by `trace`)."""

    def __init__(self):
        self.records = Records()
        self.open: List[int] = []  # indices of the spans entered and not yet exited
        self.ranges = False

    def span(self, name: str, request: Optional[int] = None, step: Optional[int] = None,
             kind: Optional[str] = None) -> _Span:
        return _Span(self, name, request, step, kind)

    def count(self, name: str, value) -> None:
        self.records.counters.setdefault(name, []).append(value)


_active: Optional[Recorder] = None  # the recorder of `recording()`; None: off


def span(name: str, request: Optional[int] = None, step: Optional[int] = None,
         kind: Optional[str] = None):
    """A span of the program, as a context manager. A root span (none open
    around it) takes `request`; the spans inside it inherit it. Off, this is
    `NO_SPAN`."""
    if _active is None:
        return NO_SPAN
    return _active.span(name, request, step, kind)


def count(name: str, value) -> None:
    """Record one value of the counter `name` (nothing when off)."""
    if _active is not None:
        _active.count(name, value)


def tensor_bytes(tree) -> int:
    """numel x element_size summed over the tensors of nested dicts, lists
    and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return 0
    return sum(tensor_bytes(t) for t in tree)


def count_bytes(name: str, tree) -> None:
    """`count(name, tensor_bytes(tree))`, the bytes summed only when on."""
    if _active is not None:
        _active.count(name, tensor_bytes(tree))


@contextlib.contextmanager
def recording():
    """Switch the recorder on for the block, with empty records and
    counters; yields the `Records` it fills, which stay readable after the
    block. The recorder that was on before (if any) is on again after it."""
    global _active
    before, _active = _active, Recorder()
    try:
        yield _active.records
    finally:
        _active = before


class StageTimer:
    """Accumulates named stage durations (a view of a `Recorder` of its own:
    one root span per stage, on `perf_counter_ns`).

    with timer.stage("dust3r"): ...
    print(timer.summary())
    """

    def __init__(self):
        self._rec = Recorder()

    def stage(self, name: str):
        return self._rec.span(name)

    @property
    def records(self) -> List[Tuple[str, float]]:
        return [(s.name, (s.end_ns - s.start_ns) / 1e9) for s in self._rec.records.spans]

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
    The program's spans show in it as ranges: the recorder is on inside the
    block (the one already on, or a new one). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with contextlib.ExitStack() as stack:
        if _active is None:
            stack.enter_context(recording())
        rec = _active
        stack.callback(setattr, rec, "ranges", rec.ranges)
        with profile(activities=activities, record_shapes=True) as prof:
            rec.ranges = True
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
