"""The port's profiling helpers (`utils/profiling.py`): `StageTimer`
against the JAX package's, `debug_nans` on a module that makes a NaN, a
`trace` on the CPU that writes its file, and the span recorder on
`generate_staged` at the tiny preset."""

import json
import os

import pytest
import torch

from viewcrafter_tpu.utils import profiling as jax_profiling
from viewcrafter_tpu_torch.utils import profiling


def test_stage_timer_matches_the_jax_package(monkeypatch):
    # the JAX package's timer reads time.time(), the port's perf_counter_ns()
    seconds = [0.0, 1.5, 2.0, 2.25, 3.0, 7.0]
    wall, mono = iter(seconds), iter([int(t * 1e9) for t in seconds])
    monkeypatch.setattr(jax_profiling.time, "time", lambda: next(wall))
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(mono))
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
        with profiling.span("step.unet"):  # a program span shows as a range
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert profiling.span("step.unet") is profiling.NO_SPAN  # the recorder off again
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any(e.get("name") == "step.unet" for e in events)


def test_spans_off_record_nothing():
    assert profiling.span("generate", request=1) is profiling.NO_SPAN
    with profiling.span("step", step=0, kind="step"):
        profiling.count("reuse_cache_bytes", 1)
        profiling.count_bytes("reuse_cache_bytes", {"a": torch.ones(2)})
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}
    assert profiling.span("generate") is profiling.NO_SPAN  # off again after the block


@pytest.fixture(scope="module")
def tiny_engine():
    from viewcrafter_tpu_torch.config import get_model_config
    from viewcrafter_tpu_torch.models.lvdm import VideoDiffusionEngine

    cfg = get_model_config("viewcrafter_tiny")
    eng = VideoDiffusionEngine(cfg, dtype=torch.float32, device="cpu")
    eng.init_params(0)
    g = torch.Generator().manual_seed(0)
    frames = torch.rand((1, cfg.video_length, cfg.height, cfg.width, 3), generator=g) * 2 - 1
    ids = torch.zeros((1, 77), dtype=torch.long)
    return eng, frames, ids


def _children(spans, index):
    return [s for s in spans if s.parent == index]


def test_generate_staged_spans_one_request(tiny_engine):
    import time

    eng, frames, ids = tiny_engine
    hooks = []  # (stage, host time of its on_stage call)
    with profiling.recording() as rec:
        for steps in (4, 1):
            eng.generate_staged(frames, ids, ids, steps=steps, chunk=2,
                                on_stage=lambda name: hooks.append((name, time.perf_counter_ns())))
    spans = rec.spans
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["generate", "generate"]
    first, second = (spans[i].request for i in roots)
    assert second == first + 1
    assert {s.request for s in spans} == {first, second}
    assert [h for h, _ in hooks] == ["prepare"] + ["step"] * 4 + ["decode", "prepare", "step",
                                                                   "decode"]
    stages = []  # the spans each hook follows, in order
    for root, steps in zip(roots, (4, 1)):
        top = _children(spans, root)
        assert [s.name for s in top] == ["prepare"] + ["step"] * steps + ["decode"]
        prep = spans.index(top[0])
        assert [s.name for s in _children(spans, prep)] == ["prepare.encode", "prepare.contexts"]
        steps_at = [spans.index(s) for s in top[1:-1]]
        assert [(spans[i].step, spans[i].kind) for i in steps_at] == [
            (j, "step") for j in range(steps)]
        for i in steps_at:
            assert [s.name for s in _children(spans, i)] == ["step.unet", "step.update"]
        stages += top[:-1] + [spans[root]]  # the decode hook follows the root's end
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    for span, (_, at) in zip(stages, hooks):
        assert span.end_ns <= at  # closed before the hook after it
    assert rec.counters == {}  # no reuse, no cache


def test_attention_reuse_kinds_and_cache_bytes(tiny_engine, monkeypatch):
    from viewcrafter_tpu_torch.sampling import ddim

    eng, frames, ids = tiny_engine
    caches = []
    real = ddim.ddim_sample_window_pab

    def keep(denoise_full, *a, **kw):
        def full(x_k, t_k):
            v, cache = denoise_full(x_k, t_k)
            caches.append(cache)
            return v, cache
        return real(full, *a, **kw)

    monkeypatch.setattr("viewcrafter_tpu_torch.models.lvdm.ddim_sample_window_pab", keep)
    with profiling.recording() as rec:
        eng.generate_staged(frames, ids, ids, steps=4, attn_reuse_interval=2)
    kinds = [s.kind for s in rec.spans if s.name == "step"]
    assert kinds == ["full", "reuse", "full", "reuse"]
    nbytes = [sum(t.numel() * t.element_size() for t in c.values()) for c in caches]
    assert len(caches) == 2 and min(nbytes) > 0
    assert rec.counters == {"reuse_cache_bytes": nbytes}
