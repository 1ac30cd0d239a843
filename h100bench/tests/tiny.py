"""The harness on the CPU at the tiny preset, for the benchmark's own tests:
a cell's spec with the tiny configuration and a short sampler, and a run
that skips the look for a card."""

from __future__ import annotations

import time
from pathlib import Path

from h100bench import run as harness

TINY = Path(__file__).resolve().parent / "viewcrafter_tiny.json"


def tiny_spec(cell: str = "vc25.nvs", steps: int = 6, **mix) -> dict:
    spec = harness.cell_spec(cell)
    spec["config"] = harness.read_json(TINY)
    spec["mix"] = dict(spec["mix"], steps=steps, **mix)
    return spec


def run_tiny(spec: dict, seed: int = 2 ** 31 + 11, control: bool = False) -> dict:
    return harness.run(spec, seed, 0.01, False, device="cpu", control=control,
                       t0=time.perf_counter())
