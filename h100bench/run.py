"""The benchmark of the PyTorch / CUDA port on one NVIDIA H100.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the cell in BENCHMARK.json names
its configuration (`h100bench/configs/<config>.json`) and its traffic mix
(`h100bench/traffic/<traffic>.json`), whose `kind` names the generator and
runner of its requests (`h100bench/traffic/<kind>.py`); the cell's check
(`h100bench/workloads/<cell>.json`) gives the limits of the numbers that
decide `correct`; each metric is read by `h100bench/metrics/<metric>.py`.

A run: build the program and its seeded weights, warm up every shape the
cell's requests use (set-up), then serve requests back to back, one client
in a closed loop: a request starts only if, at the pace of those before it,
it would end within `--seconds`; the first always starts. Then the program
is freed and what it produced is compared with the plain float32 reference.
`--trace 1` profiles the window and reports the per-layer metrics instead
of the end-to-end ones. The last line of standard output is the result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "viewcrafter_tpu")


def fixed_caches() -> None:
    """Every compiler cache at a fixed path inside the checkout (the
    program's kernel library builds under its own `_build/` there)."""
    cache = HERE / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    return json.loads(path.read_text())


def cell_spec(workload: str, root: Path = ROOT, here: Path = HERE) -> dict:
    """What BENCHMARK.json (in `root`) and the files it names (under the
    harness's directory `here`) say of one cell."""
    bench = read_json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def applies(metric):
        if "workloads" in metric:
            return workload in metric["workloads"]
        return True

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (applies(m) if "workloads" in m else m["moves"] in names)]
    return {"name": workload, "chips": cell["chips"], "here": here,
            "config": read_json(root / conf["file"]),
            "mix": read_json(here / "traffic" / f"{cell['traffic']}.json"),
            "check": read_json(here / "workloads" / f"{workload}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


class Window:
    """What the metric readers read of one run."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
        control: bool = False, t0: float = T0) -> dict:
    """One run of a cell; returns the result. With `control`, the control's
    numbers are judged in the program's place (its `correct` and `checks`),
    and the program's verdict is kept under "program"."""
    import torch

    from h100bench import flops
    from h100bench import trace as tr
    from viewcrafter_tpu_torch.ops import kernels

    cuda = device == "cuda"
    here = spec["here"]
    kind_name = spec["mix"]["kind"]
    kind = load_module(here / "traffic" / f"{kind_name}.py", f"kind_{kind_name}")
    cell = kind.Cell(ROOT, spec["config"], spec["mix"], spec["check"], seed, device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    times = {"imports": time.perf_counter() - t0}
    cell.setup()
    sync()
    times["build"] = time.perf_counter() - t0 - sum(times.values())
    cell.warm_up()
    sync()
    setup_s = time.perf_counter() - t0
    times["warm_up"] = setup_s - sum(times.values())

    marks, counter = [], {}

    def mark(name: str) -> None:
        sync()
        marks.append((name, time.perf_counter()))
        if cuda:
            torch.cuda._sleep(64)

    def on_stage(name: str) -> None:
        n = counter.get(name, 0)
        counter[name] = n + 1
        mark(name if name in ("prepare", "decode") else f"{name} {n}")

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        torch.ones(1, device="cuda").add_(1)  # the profiler's first kernel, before the marks
        mark("window")
    sync()
    start = time.perf_counter()
    done = 0
    while True:
        elapsed = time.perf_counter() - start
        if done and elapsed + elapsed / done > seconds:
            break
        counter.clear()
        cell.serve(cell.request(done), on_stage if trace else None)
        sync()
        done += 1
    window_s = time.perf_counter() - start
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    sites = kernels.launch_sites()
    model_flops = cell.model_flops()
    gpu = torch.cuda.get_device_name(0) if cuda else "cpu"
    cell.release()

    t_check = time.perf_counter()
    numbers = cell.check(control=control)
    times["check"] = time.perf_counter() - t_check
    limits = spec["check"]["limits"]
    verdicts = {side: verdict(nums, limits) for side, nums in numbers.items()}
    # a control run is judged as a run: its numbers in the program's place
    correct, checks = verdicts["control" if control else "program"]

    win = Window(setup_s=setup_s, window_s=window_s, requests=done, peak_bytes=peak,
                 marks=marks, sites=sites, model_flops=model_flops, cfg=spec["config"],
                 mix=spec["mix"], peaks=flops.card_peaks(gpu) if cuda else None,
                 stages=None, ops=None)
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": gpu, "count": spec["chips"],
                   "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": done, "failed": 0, "seconds": times}
    if trace:
        win.ops = tr.device_ops(prof)
        names = [n for n, _ in marks]
        win.stages = tr.stages(win.ops, names)
        lo, hi = win.stages[0].start, win.stages[-1].end
        device_info["busy_s"] = tr.busy_seconds([o for o in win.ops if not tr.is_marker(o)],
                                                lo, hi)
        device_info["window_s"] = hi - lo
    wanted = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in wanted:
        reader = load_module(here / "metrics" / f"{m['name']}.py", f"metric_{m['name']}")
        value = reader.read(win)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result.update(metrics=metrics, device=device_info)
    if trace:
        result["breakdown"] = tr.breakdown(win.stages)
    if control:
        result["program"] = {"correct": verdicts["program"][0], "checks": verdicts["program"][1]}
    result["checks"] = checks
    return result


def verdict(numbers: dict, limits: dict):
    """(correct, {number: {value, limit}}): every number within its limit."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="judge the control (the reference in the precision below the "
                        "configuration's) in the program's place; not part of a benchmark run")
    args = p.parse_args(argv)
    fixed_caches()
    sys.path.insert(0, str(ROOT))
    spec = cell_spec(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"needs {spec['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # one client process: the host's other cores stay free
    result = run(spec, args.seed, args.seconds, bool(args.trace), control=args.control)
    print(json.dumps({"nvidia_smi": nvidia_smi()}), flush=True)
    found = forbidden_modules()
    if found:
        print(f"modules that must not load in a benchmark run: {found}", file=sys.stderr)
        return 3
    print(json.dumps({"seconds": result.pop("seconds"), "checks": result["checks"],
                      "program": result.pop("program", None)}), flush=True)
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
