"""Kernels: the hand-written kernels' share of their roofline, in %: the
summed least time of their calls in the window (max(operations / peak
FLOP/s, bytes / peak bytes/s), counted from each call's function and shapes
by `h100bench/flops.py`) over the summed device time of the port's kernels
(`vc::`) in the trace."""

from h100bench import flops
from h100bench.trace import HAND_WRITTEN


def read(w):
    if not w.stages or not w.peaks:
        return None
    device = sum(o.end - o.start for s in w.stages for o in s.ops if HAND_WRITTEN in o.name)
    if device <= 0:
        return None
    peak_ops, peak_bytes = w.peaks
    least = 0.0
    for kernel, sites in w.sites.items():
        for key, n in sites.items():
            ops, nbytes = flops.kernel_cost(kernel, key)
            least += n * max(ops / peak_ops, nbytes / peak_bytes)
    return 100.0 * least / device
