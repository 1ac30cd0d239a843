"""The program's spans on the trace's clock (`h100bench/spans.py`): the map
of the host's clock onto the trace's, idle gaps put down to what the host
was inside, and the readers of the program's spans and counters. Run:
python -m pytest h100bench/tests -q"""

from __future__ import annotations

import random

import pytest

from h100bench import run as harness
from h100bench import spans as sp
from h100bench import trace as tr
from h100bench.metrics import host_step_ms, idle_launch_pct, reuse_cache_gib

MARK = "void at::cuda::(anonymous namespace)::spin_kernel(long)"


def _markers(host, offset, drift=0.0, seed=0):
    """Marker kernels as the harness launches them: each starts on the
    device 5-15 us after its launch returns on the host."""
    rng = random.Random(seed)
    out = []
    for h in host:
        start = offset + h + drift * (h - host[0]) + rng.uniform(5e-6, 15e-6)
        out.append(tr.Op(MARK, start, start + 2e-6))
    return out


@pytest.mark.parametrize("drift, late", [(0.0, 0.0), (-8e-3, 0.0), (0.0, 300e-6)])
def test_clock_map_recovers_a_known_offset(drift, late):
    """`drift`: the trace's clock runs that much slow (as seen on the card);
    `late`: one launch (the 11th) reaches the device that much later."""
    host = [1000.0 + 0.2 * i + 0.001 * (i % 7) for i in range(200)]  # a 40-s window
    offset = -987.654321
    ops = _markers(host, offset, drift)
    ops[10].start += late
    clock = sp.clock_map(ops, host)
    assert clock.jumps == []
    for i, h in enumerate(host[:-1]):  # device time of each moment of the window, within 20 us
        for t in (h, h + 0.1):
            if not late or abs(i - 10) > 1:
                dev = offset + t + drift * (t - host[0])
                assert abs(clock.to_host(dev) - t) < 20e-6
    if late:
        assert clock.worst_index == 10 and clock.worst_us > 250.0
    else:
        assert clock.worst_us < 20.0
        assert clock.drift_ppm == pytest.approx(1e6 * drift, abs=200.0)


def test_a_step_of_the_trace_clock_is_its_own_segment():
    """The trace's clock steps 5 ms ahead between the 100th and 101st
    markers, inside the longest of the gaps between them: each side keeps
    its own offset, and the 5 ms of that gap go to CLOCK."""
    host = [1000.0 + 0.2 * i for i in range(200)]
    offset, step = -987.654321, 5e-3
    marks = _markers(host, offset)
    for m in marks[100:]:
        m.start += step
        m.end += step
    work = [tr.Op("k0", marks[99].end + 0.01, marks[99].end + 0.02),  # gaps of 10 ms,
            tr.Op("k1", marks[99].end + 0.05 + step, marks[100].start - 0.001)]  # 35, 1 ms
    ops = sorted(marks + work, key=lambda o: o.start)
    clock = sp.clock_map(ops, host)
    assert [i for i, _ in clock.jumps] == [100]
    assert clock.jumps[0][1] == pytest.approx(step, abs=20e-6)  # two markers' jitter
    assert clock.worst_us < 20.0 and clock.breaks[99][0] == work[1].start
    assert clock.breaks[99][1] == pytest.approx(step, abs=20e-6)
    for h in (host[50], host[99] + 0.01, host[99] + 0.1, host[150]):
        dev = offset + h + (step if h > host[99] + 0.05 else 0.0)
        assert abs(clock.to_host(dev) - h) < 20e-6
    lo, hi = marks[99].end, marks[100].start
    got = sp.idle_by_span(sp.attribute_gaps(ops, lo, hi, clock, [], []))
    assert got[sp.CLOCK] == pytest.approx(step, abs=20e-6)
    assert sum(got.values()) == pytest.approx(hi - lo - tr.busy_seconds(work, lo, hi), abs=1e-12)


def test_clock_map_needs_one_marker_per_mark():
    with pytest.raises(RuntimeError, match="marker"):
        sp.clock_map(_markers([0.0, 1.0], 5.0), [0.0])


def test_gaps_go_to_the_span_the_host_was_in():
    """Host and device 100 s apart, launches reaching the device 10 us after
    the host makes them: two gaps that end inside step.unet; one ended by a
    launch while the host was in a hook, which lies inside generate; two
    that a marker ends (a hook's synchronise); one ended just after a hook,
    inside generate; one outside every span; and the middle marker's run."""
    lat = 10e-6
    hooks = [(0.0, 0.0005), (0.060, 0.061), (0.099, 0.0995)]  # each to its marker's launch
    spans = [(0.010, 0.0625, "generate"), (0.011, 0.050, "step"),
             (0.011, 0.040, "step.unet"), (0.040, 0.050, "step.update")]
    marks = [tr.Op(MARK, 100.0 + b + lat, 100.0 + b + lat + 1e-6) for _, b in hooks]
    work = [("k0", 100.012, 100.020), ("k1", 100.025, 100.030), ("k2", 100.030, 100.055),
            ("k2b", 100.0603, 100.0604), ("k3", 100.0615, 100.0616), ("k4", 100.080, 100.090)]
    ops = sorted(marks + [tr.Op(*w) for w in work], key=lambda o: o.start)
    lo, hi = marks[0].end, marks[-1].start
    clock = sp.clock_map(ops, [b for _, b in hooks])
    assert clock.worst_us < 1e-3 and clock.jumps == []
    got = sp.idle_by_span(sp.attribute_gaps(ops, lo, hi, clock, spans, hooks))
    m1 = marks[1]
    assert got == pytest.approx({
        "step.unet": (100.012 - lo) + 0.005,
        sp.HARNESS: (100.0603 - 100.055) + (m1.start - 100.0604) + (hi - 100.090) + 1e-6,
        "generate": 100.0615 - m1.end,
        sp.OUTSIDE: 100.080 - 100.0616}, abs=1e-9)
    busy = tr.busy_seconds([o for o in ops if not tr.is_marker(o)], lo, hi)
    assert sum(got.values()) == pytest.approx(hi - lo - busy, abs=1e-12)  # idle_pct's idle


def test_span_readers():
    SpanRecord = pytest.importorskip("viewcrafter_tpu_torch.utils.profiling").SpanRecord
    untraced = harness.Window(setup_s=1.0, window_s=2.0, requests=1, stages=None)
    for reader in (host_step_ms, idle_launch_pct, reuse_cache_gib):
        assert reader.read(untraced) is None
    st = [tr.Stage("prepare", 0.0, 1.0, []), tr.Stage("step 0", 1.0, 4.0, [])]
    spans = [SpanRecord("generate", 1, None, 0, 4_000_000),
             SpanRecord("step", 1, 0, 0, 3_000_000, step=0, kind="full"),
             SpanRecord("step", 1, 0, 3_000_000, 4_000_000, step=1, kind="reuse")]
    idle = {"step.unet": 0.2, sp.HARNESS: 0.3, sp.OUTSIDE: 0.1}
    w = harness.Window(stages=st, spans=spans, counters={}, idle=idle)
    assert host_step_ms.read(w) == pytest.approx(2.0)
    assert idle_launch_pct.read(w) == pytest.approx(5.0)
    assert reuse_cache_gib.read(w) is None  # a cell without reuse
    w.counters = {"reuse_cache_bytes": [2 ** 30, 3 * 2 ** 29]}
    assert reuse_cache_gib.read(w) == pytest.approx(1.5)
    # a program without the recorder (no spans): no reading, whatever the gaps
    assert idle_launch_pct.read(harness.Window(stages=st, spans=None, idle=idle)) is None

