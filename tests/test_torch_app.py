"""The port's gradio demo (`viewcrafter_tpu_torch/app.py`) on the CPU.

gradio is not installed here, so a stub that records the component wiring
stands in for it (a copy of the one in `tests/test_app.py`); the demo's
`run` callback then runs for real on the tiny presets, on the CPU: upload,
trajectory file, DUSt3R, render, diffusion, the two videos returned.
"""

import os
import sys
import types

import numpy as np

from viewcrafter_tpu_torch.pipeline import InferenceOptions


class _Component:
    def __init__(self, *a, **k):
        self.label = k.get("label")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _Button(_Component):
    clicks = []

    def click(self, fn, inputs, outputs):
        _Button.clicks.append((fn, inputs, outputs))


class _Examples(_Component):
    seen = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        _Examples.seen.append(k.get("examples"))


def _install_fake_gradio(monkeypatch):
    gr = types.ModuleType("gradio")
    for name in ("Blocks", "Markdown", "Row", "Column", "Image", "Slider",
                 "Number", "Video", "Text"):
        setattr(gr, name, _Component)
    gr.Button = _Button
    gr.Examples = _Examples
    monkeypatch.setitem(sys.modules, "gradio", gr)
    _Button.clicks = []
    _Examples.seen = []


def test_app_builds_and_generates_on_the_cpu(monkeypatch, tmp_path):
    _install_fake_gradio(monkeypatch)
    from viewcrafter_tpu_torch.app import build_demo

    opts = InferenceOptions(out_dir=str(tmp_path), mode="single_view_txt",
                            model="viewcrafter_tiny", dust3r_model="dust3r_tiny", ddim_steps=2,
                            video_length=4, dust3r_size=64, niter=5, batch_size=2)
    demo = build_demo(opts, device="cpu")
    assert demo is not None
    assert len(_Button.clicks) == 1
    run_fn, inputs, outputs = _Button.clicks[0]
    assert len(inputs) == 8 and len(outputs) == 2
    # the examples gallery of the reference (gradio_app.py:8-14), bundled images
    assert _Examples.seen and len(_Examples.seen[0]) == 5
    assert all(os.path.exists(e[0]) for e in _Examples.seen[0])

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, size=(96, 128, 3), dtype=np.uint8)
    img[30:60, 40:90] = [200, 50, 50]
    traj_path, diffusion_path = run_fn(img, 12.0, 1.0, "0 5 10", "0 -2 4", "0 -0.05 -0.1", 2,
                                       123)
    assert os.path.basename(traj_path).startswith("viz_traj")
    assert os.path.exists(traj_path), traj_path
    assert os.path.exists(diffusion_path), diffusion_path
    with open(os.path.join(os.path.dirname(diffusion_path), "..", "traj.txt")) as f:
        assert f.read().split("\n")[:3] == ["0.0 5.0 10.0", "0.0 -2.0 4.0", "0.0 -0.05 -0.1"]
