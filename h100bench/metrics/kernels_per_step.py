"""Denoiser: device kernels launched per DDIM step, counted in the trace
(memory copies and fills left out). A count."""

from h100bench.metrics._stages import is_step


def read(w):
    if not w.stages:
        return None
    steps = [s for s in w.stages if is_step(s.name)]
    if not steps:
        return None
    n = sum(1 for s in steps for o in s.ops if not o.name.startswith(("Memcpy", "Memset")))
    return n / len(steps)
