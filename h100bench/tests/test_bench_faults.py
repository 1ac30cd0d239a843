"""`correct` on the CPU at the tiny preset: a sound run passes the cell's
limits, the control (the reference in the precision below the
configuration's, in the program's place) and each fault the cells can have
fail them. Each fault breaks the timed path underneath a whole run."""

from __future__ import annotations

import pytest

from h100bench.tests.tiny import run_tiny, tiny_spec

CELLS = ("vc25.nvs", "vc25_512.nvs", "vc25.nvs_pab3")


def _spec(cell):
    pab = cell.endswith("pab3")
    return tiny_spec(cell, steps=12 if pab else 6)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_the_control_is_not(cell):
    spec = _spec(cell)
    res = run_tiny(spec, control=True)
    assert res["program"]["correct"] is True, res["program"]["checks"]
    assert res["correct"] is False, res["checks"]  # the control, judged as a run


def _broken_update(monkeypatch):
    """A DDIM step that returns its state unchanged."""
    from viewcrafter_tpu_torch.sampling import ddim

    real = ddim.ddim_step_parts

    def parts(*a, **kw):
        p = real(*a, **kw)
        return p._replace(update=lambda i, x, v, noise: x)

    monkeypatch.setattr(ddim, "ddim_step_parts", parts)


def _broken_update_at_one_step(monkeypatch):
    """A DDIM step that returns its state unchanged at one step only, the
    last but one, which no UNet check draws."""
    from viewcrafter_tpu_torch.sampling import ddim

    real = ddim.ddim_step_parts

    def parts(batch_size, schedule, *a, **kw):
        p = real(batch_size, schedule, *a, **kw)
        n = schedule.num_steps

        def update(i, x, v, noise):
            return x if i == n - 2 else p.update(i, x, v, noise)

        return p._replace(update=update)

    monkeypatch.setattr(ddim, "ddim_step_parts", parts)


def _altered_answer(monkeypatch):
    """One frame of the video altered where it is produced."""
    from viewcrafter_tpu_torch.models.lvdm import VideoDiffusionEngine

    real = VideoDiffusionEngine.decode_latents

    def decode(self, z):
        v = real(self, z)
        v[:, 1] = v[:, 1] * 0.8
        return v

    monkeypatch.setattr(VideoDiffusionEngine, "decode_latents", decode)


def _half_the_batch(monkeypatch):
    """The guidance branches' batch halved: the conditional rows computed,
    the unconditional ones taken from them."""
    from viewcrafter_tpu_torch.models.unet3d import UNet3D

    real = UNet3D.forward

    def forward(self, x, *a, **kw):
        out = real(self, x, *a, **kw)
        y = out[0] if isinstance(out, tuple) else out
        half = y.shape[0] // 2
        y[:half] = y[half:].clone()
        return out

    monkeypatch.setattr(UNet3D, "forward", forward)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_broken_update, _broken_update_at_one_step, _altered_answer,
                                   _half_the_batch])
def test_a_fault_makes_the_run_incorrect(monkeypatch, cell, fault):
    fault(monkeypatch)
    res = run_tiny(_spec(cell))
    assert res["correct"] is False, res["checks"]
