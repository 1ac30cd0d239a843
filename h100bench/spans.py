"""The program's spans on the device trace's clock, for a traced run: the
map of the host's clock onto the trace's (`clock_map`) and each idle gap of
the device put down to what the host was doing when the gap ended
(`attribute_gaps`): the innermost program span, a synchronising hook of the
harness (`HARNESS`), or neither (`OUTSIDE`); or, where the trace's clock
stepped ahead of the host's (`CLOCK`), to no one. The readers of
`host_step_ms`, `idle_launch_pct` and `reuse_cache_gib` read what this
gives. `run.py` does not call it yet: the wiring it needs is in PERF.md,
section 7.
"""

from __future__ import annotations

import bisect
import dataclasses

from h100bench.trace import busy_seconds, is_marker, union

HARNESS = "harness"  # a synchronising hook and its marker
OUTSIDE = "outside"  # the host inside no program span and no hook
CLOCK = "trace_clock"  # idle the trace shows where its clock stepped ahead of the host's


@dataclasses.dataclass
class ClockMap:
    """The host's time of a device time: the difference (device - host) of
    each marker (`diffs`, at device times `at`), interpolated linearly
    between two markers, or, where the trace's clock stepped ahead inside a
    stage (`breaks`: stage k, from marker k to k + 1 -> (device time of the
    step, seconds it stepped)), held at each side's marker up to and from
    the step."""

    at: list
    diffs: list
    breaks: dict
    jumps: list  # (k + 1, seconds) of each stage k whose difference steps
    worst_us: float
    worst_index: int
    drift_ppm: float

    def to_host(self, device: float) -> float:
        k = min(max(bisect.bisect_right(self.at, device) - 1, 0), len(self.at) - 1)
        if k + 1 == len(self.at) or device <= self.at[k]:
            return device - self.diffs[k]
        if k in self.breaks:
            return device - self.diffs[k if device < self.breaks[k][0] else k + 1]
        f = (device - self.at[k]) / (self.at[k + 1] - self.at[k])
        return device - (self.diffs[k] + f * (self.diffs[k + 1] - self.diffs[k]))


def clock_map(ops: list, host: list, jump_us: float = 500.0) -> ClockMap:
    """Map the trace's clock onto the host's by the markers: the i-th marker
    starts on the device as its launch returns on the host, at host[i]
    (under the profiler a launch call takes 30-190 us, and the kernel starts
    at its end: against the host's time before the call the markers scatter
    over +-75 us, against the time after it over +-15 us).

    The difference (device - host) is not constant on the card: it runs
    linear over stretches of a run, at up to 0.8% of the host's rate, and
    steps by up to 63 ms between them. So the map interpolates the
    difference between consecutive markers. A stage steps (`jumps`) where
    its difference moves by more than `jump_us`, and by more than that
    apart from what either neighbouring stage's rate gives it. A step
    ahead, beyond what the neighbours' rates give, that fits in the stage's
    longest gap (within `jump_us`) is taken to lie there: the trace shows
    idle time that the host did not see. `worst_us`: the
    largest distance of a marker from the line through its two
    neighbours, away from steps (the map's own error); `drift_ppm`: the
    largest rate of the difference over a stage, away from steps."""
    marks = [o for o in ops if is_marker(o)]
    if len(marks) != len(host) or not host:
        raise RuntimeError(f"{len(marks)} marker kernels on the device, {len(host)} on the host")
    at = [m.start for m in marks]
    diffs = [m.start - h for m, h in zip(marks, host)]
    steps = [b - a for a, b in zip(diffs, diffs[1:])]
    spans = [max(b - a, 1e-9) for a, b in zip(at, at[1:])]
    bound = jump_us * 1e-6

    def apart(k, j):  # stage k's step against stage j's rate of the difference
        return not 0 <= j < len(steps) or abs(steps[k] - steps[j] / spans[j] * spans[k]) > bound

    big = [k for k in range(len(steps))
           if abs(steps[k]) > bound and apart(k, k - 1) and apart(k, k + 1)]
    breaks = {}
    for k in big:
        rates = [steps[j] / spans[j] for j in (k - 1, k + 1) if 0 <= j < len(steps)]
        excess = steps[k] - spans[k] * sum(rates) / max(len(rates), 1)
        lo, hi = marks[k].end, marks[k + 1].start
        t, brk, longest = lo, None, 0.0
        for a, b in union((o.start, o.end) for o in ops if o.end > lo and o.start < hi):
            if a - t > longest:
                brk, longest = a, a - t
            t = max(t, b)
        if hi - t > longest:
            brk, longest = hi, hi - t
        if excess > 0 and longest >= excess - bound:
            breaks[k] = (brk, min(excess, longest))
    worst_us, worst, drift = 0.0, 0, 0.0
    for k in range(1, len(marks) - 1):
        if k - 1 in big or k in big:
            continue
        f = (at[k] - at[k - 1]) / (at[k + 1] - at[k - 1])
        miss = 1e6 * abs(diffs[k] - (diffs[k - 1] + f * (diffs[k + 1] - diffs[k - 1])))
        if miss > worst_us:
            worst_us, worst = miss, k
    for k, step in enumerate(steps):
        if k not in big and abs(step) > abs(drift) * spans[k]:
            drift = step / spans[k]
    return ClockMap(at, diffs, breaks, [(k + 1, steps[k]) for k in big], worst_us, worst,
                    1e6 * drift)


def innermost(intervals: list):
    """The innermost interval around each moment, of nested (start, end,
    name) intervals: ([t_k], [name_k]) with name_k holding from t_k to
    t_{k+1} (None: inside none)."""
    times, names, open_ = [], [], []

    def at(t, name):
        if times and times[-1] == t:
            names[-1] = name
        else:
            times.append(t)
            names.append(name)

    def close_until(t):
        while open_ and open_[-1][1] <= t:
            end = open_.pop()[1]
            at(end, open_[-1][2] if open_ else None)

    for start, end, name in sorted(intervals, key=lambda iv: (iv[0], -iv[1])):
        close_until(start)
        open_.append((start, end, name))
        at(start, name)
    close_until(float("inf"))
    return times, names


def attribute_gaps(ops: list, lo: float, hi: float, clock: ClockMap, spans: list,
                   hooks: list) -> list:
    """[(what the host was inside, device start, seconds)]: the device's
    idle time in [lo, hi] as `idle_pct` counts it, put down to what the host
    was doing. A gap between operations (markers included) goes to what the
    host was inside when the launch that ended it reached the device: to
    `HARNESS` if a marker ended it, else to the innermost of the program's
    spans (`spans`: (host start, host end, name)) and the harness's hooks
    (`hooks`: (host start, host end)) around the gap's end mapped to the
    host's clock, or to `OUTSIDE`; but as much of the gap where the trace's
    clock stepped ahead (`clock.jumps`) as the step, to `CLOCK`. The
    markers' own run, idle for `idle_pct`, is one last entry, (`HARNESS`,
    None, seconds)."""
    times, names = innermost(list(spans) + [(a, b, HARNESS) for a, b in hooks])
    marker_starts = {o.start for o in ops if is_marker(o)}
    stepped = dict(clock.breaks.values())
    out = []

    def put(a, b):
        fake = min(stepped.get(b, 0.0), b - a)
        if fake > 0:
            out.append((CLOCK, a, fake))
            a += fake
            if b <= a:
                return
        if b in marker_starts:
            name = HARNESS
        else:
            k = bisect.bisect_right(times, clock.to_host(b)) - 1
            name = (names[k] if k >= 0 else None) or OUTSIDE
        out.append((name, a, b - a))

    t = lo
    for a, b in union((max(o.start, lo), min(o.end, hi)) for o in ops
                      if o.end > lo and o.start < hi):
        if a > t:
            put(t, a)
        t = max(t, b)
    if hi > t:
        put(t, hi)
    markers_s = busy_seconds(ops, lo, hi) - busy_seconds([o for o in ops if not is_marker(o)],
                                                          lo, hi)
    out.append((HARNESS, None, markers_s))
    return out


def idle_by_span(gaps: list) -> dict:
    """Idle seconds by what the host was inside (`attribute_gaps`)."""
    out = {}
    for name, _, seconds in gaps:
        out[name] = out.get(name, 0.0) + seconds
    return out
