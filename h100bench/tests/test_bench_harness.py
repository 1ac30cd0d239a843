"""The benchmark's own CPU tests: discovery by name, seeded traffic, the
trace arithmetic, the FLOP walk, the reference against the program, and
the import guards. Run: python -m pytest h100bench/tests -q"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from h100bench import flops
from h100bench import run as harness
from h100bench import trace as tr
from h100bench import weights
from h100bench.tests.tiny import TINY, run_tiny, tiny_spec

ROOT = Path(harness.__file__).resolve().parents[1]


def test_new_cell_traffic_and_metric_are_found_by_name(tmp_path):
    """A cell, a mix and a metric added as files and entries run with no
    edit of the harness's code."""
    here = tmp_path / "h100bench"
    shutil.copytree(harness.HERE, here, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((here / "traffic" / "nvs.json").read_text())
    (here / "traffic" / "nvs_short.json").write_text(json.dumps(dict(mix, steps=3)))
    (here / "workloads" / "tiny.nvs_short.json").write_text(
        (here / "workloads" / "vc25.nvs.json").read_text())
    (here / "metrics" / "requests_n.py").write_text("def read(w):\n    return w.requests\n")
    bench["configs"].append({"name": "viewcrafter_tiny", "source": "test",
                             "file": str(TINY.relative_to(ROOT)), "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.nvs_short", "config": "viewcrafter_tiny",
                               "traffic": "nvs_short", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "requests_n", "unit": "requests", "better": "higher",
                                "bound": 0.01, "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = harness.cell_spec("tiny.nvs_short", root=tmp_path, here=here)
    spec["config"] = json.loads(TINY.read_text())
    assert spec["mix"]["steps"] == 3
    assert [m["name"] for m in spec["end_to_end"]] == ["peak_gib", "setup_s", "requests_n"]
    res = run_tiny(spec)
    assert res["metrics"]["requests_n"]["value"] == 1
    assert res["correct"] is True


def _cell(seed, **mix):
    from h100bench.traffic import nvs

    spec = tiny_spec(**mix)
    cell = nvs.Cell(ROOT, spec["config"], spec["mix"], spec["check"], seed, "cpu")
    cell.setup()
    return cell


def test_seeded_traffic_repeats_exactly():
    a, b, c = _cell(2 ** 31 + 5), _cell(2 ** 31 + 5), _cell(2 ** 31 + 6)
    for i in (0, 1):
        ra, rb, rc = a.request(i), b.request(i), c.request(i)
        assert torch.equal(ra.frames, rb.frames) and torch.equal(ra.ids, rb.ids)
        assert torch.equal(ra.noise.steps, rb.noise.steps)
        assert ra.frames.shape == rc.frames.shape and ra.noise.steps.shape == rc.noise.steps.shape
        assert not torch.equal(ra.noise.steps, rc.noise.steps)
    assert not torch.equal(a.request(0).noise.x_T, a.request(1).noise.x_T)


def test_the_last_request_is_checked_from_its_host_copies():
    """Two requests served: the host buffers, all made in the warm-up, hold
    the second, and the check draws its inputs again and finds it sound."""
    cell = _cell(2 ** 31 + 7)
    cell.warm_up()
    keys = set(cell.kept.bufs)
    for i in (0, 1):
        cell.serve(cell.request(i))
    assert set(cell.kept.bufs) == keys and [i for i, _ in cell.served] == [0, 1]
    cell.release()
    numbers = cell.check()["program"]
    assert all(v <= cell.limits["limits"][k] for k, v in numbers.items()), numbers
    with pytest.raises(KeyError):
        cell.kept.put(("x", 10 ** 6), torch.zeros(1))


def test_stage_markers_must_match():
    ops = [tr.Op("a", 1.0, 2.0), tr.Op("marker spin_kernel", 3.0, 3.0)]
    with pytest.raises(RuntimeError):
        tr.stages(ops, ["window", "prepare"])


def test_seeded_weights_repeat_and_differ():
    cfg = json.loads(TINY.read_text())
    w1, w2 = weights.make(cfg, 7, "cpu"), weights.make(cfg, 7, "cpu")
    w3 = weights.make(cfg, 8, "cpu")
    k = "time_embed_0.weight"
    assert torch.equal(w1["unet"][k], w2["unet"][k])
    assert not torch.equal(w1["unet"][k], w3["unet"][k])
    assert w1["unet"]["out_norm.weight"].float().mean().item() == pytest.approx(1.0, abs=0.05)


def test_idle_share_is_the_union_of_intervals():
    ops = [tr.Op("marker spin_kernel", 0.0, 0.0), tr.Op("a", 1.0, 3.0), tr.Op("b", 2.0, 4.0),
           tr.Op("c", 6.0, 7.0), tr.Op("marker spin_kernel", 10.0, 10.0)]
    st = tr.stages(ops, ["window", "prepare"])
    assert [s.name for s in st] == ["prepare"] and len(st[0].ops) == 3
    assert tr.busy_seconds(ops[1:4], 0.0, 10.0) == pytest.approx(4.0)  # summed: 5
    from h100bench.metrics import idle_pct

    w = harness.Window(stages=st)
    assert idle_pct.read(w) == pytest.approx(60.0)
    gaps = dict(tr.breakdown(st)["idle_gaps"][:1])
    assert gaps == {"prepare": pytest.approx(3.0)}


def test_roofline_and_mfu_arithmetic():
    from h100bench.metrics import kernel_roofline, mfu

    peaks = (1e12, 1e9)  # 1 TFLOP/s, 1 GB/s
    key = (1, 128, 128, 1, 64)  # fullkv: 4 * 128 * 128 * 64 = 4.19e6 ops, 65536 bytes
    ops, nbytes = flops.kernel_cost("fullkv_attention", key)
    assert ops == 4 * 128 * 128 * 64 and nbytes == 2 * 64 * (2 * 128 + 2 * 128)
    least = max(ops / 1e12, nbytes / 1e9)  # bytes bound: 65.5 us
    st = [tr.Stage("step 0", 0.0, 1.0, [tr.Op("void vc::fullkv_kernel<64>", 0.0, 2 * least),
                                        tr.Op("cudnn conv", 0.0, 1.0)])]
    w = harness.Window(stages=st, peaks=peaks, sites={"fullkv_attention": {key: 3}})
    assert kernel_roofline.read(w) == pytest.approx(150.0)  # 3 calls' bound in 2 bounds' time
    w = harness.Window(peaks=peaks, model_flops=5e12, window_s=10.0)
    assert mfu.read(w) == pytest.approx(50.0)
    assert kernel_roofline.read(harness.Window(stages=None, peaks=peaks)) is None


def test_flop_walk_agrees_with_the_published_count():
    """docs/roofline.md counts 163.7 TFLOP a batched-CFG eval of
    viewcrafter_25 with 16 image tokens; the program's context holds 256
    (16 queries x the resampler's video_length 16), which adds ~1.9 TFLOP
    of image cross-attention."""
    cfg = json.loads((ROOT / "h100bench/configs/viewcrafter_25.json").read_text())
    u = cfg["unet"]
    docs = flops.unet_eval(u, 2, 25, 72, 128, 77 + 16)
    assert docs.total / 1e12 == pytest.approx(163.7, abs=0.05)
    full = flops.unet_eval(u, 2, 25, 72, 128, flops.context_len(cfg))
    assert full.total / 1e12 == pytest.approx(165.5, abs=0.05)
    assert flops.vae(cfg["vae"], 576, 1024, "decoder").total / 1e12 == pytest.approx(5.75, abs=0.01)
    assert flops.vae(cfg["vae"], 576, 1024, "encoder").total / 1e12 == pytest.approx(2.61, abs=0.01)
    reuse = flops.unet_eval(u, 2, 25, 72, 128, flops.context_len(cfg),
                            ("spatial", "cross", "temporal"))
    assert reuse.total < full.total - full.by["spatial_attn"]


def test_reference_matches_the_program_in_float32():
    """The reference and the program, both in float32 on the CPU at the tiny
    preset with the same weights: every stage the check compares."""
    from h100bench.reference.models import Ctx, DiffusionModels, clip_preprocess
    from h100bench.reference.numerics import Numerics
    from h100bench.traffic.nvs import port_config, rel
    from viewcrafter_tpu_torch.models.lvdm import VideoDiffusionEngine

    cfg = json.loads(TINY.read_text())
    eng = VideoDiffusionEngine(port_config(cfg), dtype=torch.float32, device="cpu")
    state = weights.make(cfg, 3, "cpu")
    eng.load_params({g: {k: v.float() for k, v in p.items()} for g, p in state.items()})
    nets = DiffusionModels(cfg)
    for g, p in state.items():
        getattr(nets, g).load_state_dict({k: v.float() for k, v in p.items()})
    ctx = Ctx(Numerics("f32"))
    gen = torch.Generator().manual_seed(0)
    t, h, w = cfg["video_length"], cfg["height"], cfg["width"]
    img = torch.rand((1, h, w, 3), generator=gen) * 2 - 1
    noise = torch.randn((1, h // 8, w // 8, 4), generator=gen)
    with torch.no_grad():
        assert rel(eng.vae.encode(img, noise), nets.vae.encode(ctx, img, noise), 0) < 1e-5
        z = torch.randn((1, h // 8, w // 8, 4), generator=gen)
        assert rel(eng.vae.decode(z), nets.vae.decode(ctx, z), 0) < 1e-5
        ids = torch.randint(1000, 49000, (1, 77), generator=gen)
        assert rel(eng.text_context(ids), nets.clip_text(ctx, ids), 0) < 1e-5
        ref_img = nets.resampler(ctx, nets.clip_vision(ctx, clip_preprocess(img)))
        assert rel(eng.image_context(img), ref_img, 0) < 1e-5
        x = torch.randn((2, t, h // 8, w // 8, 8), generator=gen)
        tt = torch.full((2,), 981.0)
        context = torch.randn((2, 77 + 16, cfg["unet"]["context_dim"]), generator=gen)
        fs = torch.full((2,), 10.0)
        assert rel(eng.unet(x, tt, context, fs=fs), nets.unet(ctx, x, tt, context, fs), 0) < 1e-5


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import h100bench.reference.models, "
            "h100bench.reference.sampler, h100bench.weights, h100bench.flops, h100bench.trace; "
            "bad = {m.split('.')[0] for m in sys.modules} & {'viewcrafter_tpu_torch', "
            "'viewcrafter_tpu', 'tests', 'chip_smoke', 'jax', 'jaxlib', 'flax'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_a_run_refuses_without_a_card_and_names_forbidden_modules(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", "vc25.nvs", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "viewcrafter_tpu_torch.config", object())
    found = harness.forbidden_modules()
    assert "jax" in found and "viewcrafter_tpu" not in found  # whole top-level names


def test_a_run_in_a_directory_without_the_program_fails(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", "vc25.nvs",
                          "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
