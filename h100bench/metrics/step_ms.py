"""Sampler: milliseconds per DDIM step, all steps' time (between the
synchronised step hooks, "step" or "full" / "reuse") over their count."""

from h100bench.metrics._stages import durations, is_step


def read(w):
    got = [s for name, s in durations(w) if is_step(name)] if w.marks else []
    return 1e3 * sum(got) / len(got) if got else None
