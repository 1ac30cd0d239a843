"""Device: share of the traced window in which the device sat idle while
the host was inside a program span, in %: the idle gaps (as `idle_pct`
counts them) put down to a span of the program by what the host was inside
when the gap ended (`spans.attribute_gaps`). At most `idle_pct`; the rest
is the harness's synchronising hooks and markers, time outside the
program, and idle the trace shows only because its clock stepped."""

from h100bench.spans import CLOCK, HARNESS, OUTSIDE


def read(w):
    idle = getattr(w, "idle", None)
    if not getattr(w, "spans", None) or idle is None or not w.stages:
        return None
    window = w.stages[-1].end - w.stages[0].start
    program = sum(s for name, s in idle.items() if name not in (HARNESS, OUTSIDE, CLOCK))
    return 100.0 * program / window
