"""The port's profiling helpers (`utils/profiling.py`): `StageTimer`
against the JAX package's, `debug_nans` on a module that makes a NaN, and a
`trace` on the CPU that writes its file."""

import json
import os

import pytest
import torch

from viewcrafter_tpu.utils import profiling as jax_profiling
from viewcrafter_tpu_torch.utils import profiling


def test_stage_timer_matches_the_jax_package(monkeypatch):
    clock = iter([0.0, 1.5, 2.0, 2.25, 3.0, 7.0] * 2)
    for mod in (profiling, jax_profiling):
        monkeypatch.setattr(mod.time, "time", lambda: next(clock))
    timers = []
    for mod in (profiling, jax_profiling):
        timer = mod.StageTimer()
        for name in ("dust3r", "align", "dust3r"):
            with timer.stage(name):
                pass
        timers.append(timer)
    ours, theirs = timers
    assert ours.records == theirs.records == [("dust3r", 1.5), ("align", 0.25), ("dust3r", 4.0)]
    assert ours.totals() == theirs.totals() == {"dust3r": 5.5, "align": 0.25}
    assert ours.summary() == theirs.summary()


class _Log(torch.nn.Module):
    def forward(self, x):
        return torch.log(x)


def test_debug_nans_raises_on_the_first_non_finite_output():
    lin = torch.nn.Linear(4, 4)
    torch.nn.init.zeros_(lin.weight)
    torch.nn.init.constant_(lin.bias, -1.0)
    model = torch.nn.Sequential(lin, _Log())  # log(-1): NaN
    x = torch.full((2, 4), -1.0)
    with profiling.debug_nans():
        torch.nn.Linear(4, 4)(x)  # finite: passes
        with pytest.raises(profiling.NonFiniteError, match="_Log"):
            model(x)
    assert torch.isnan(_Log()(x)).all()  # outside the block nothing checks
    with profiling.debug_nans(enable=False):
        _Log()(x)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
