"""Device: share of the traced window in which no operation ran on the
device (the union of the operations' intervals, not their summed
durations), in %."""

from h100bench.trace import busy_seconds, is_marker


def read(w):
    if not w.stages:
        return None
    lo, hi = w.stages[0].start, w.stages[-1].end
    ops = [o for s in w.stages for o in s.ops if not is_marker(o)]
    return 100.0 * (1.0 - busy_seconds(ops, lo, hi) / (hi - lo))
