"""The port's eval metrics against the JAX package's `utils/metrics.py`:
PSNR, SSIM and `video_metrics` on seeded images, and LPIPS with a state dict
of seeded random arrays in the lpips package's layout, saved as a .pth and
loaded by both packages (no LPIPS weights ship with the repo). Tolerances:
PSNR and SSIM 1e-4 (the same float32 arithmetic, sums in another order);
LPIPS 1e-4 of its value (float32 convolutions of two libraries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viewcrafter_tpu.utils.metrics as jm
import viewcrafter_tpu_torch.utils.metrics as tm


@pytest.fixture
def images():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(3, 40, 48, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.fixture
def no_lpips(monkeypatch):
    monkeypatch.setattr(tm, "_LPIPS", None)
    monkeypatch.setattr(jm, "_LPIPS_WEIGHTS", None)


def _lpips_state(rng) -> dict:
    """A random lpips.LPIPS(net='alex') state dict (layout (a))."""
    sd = {}
    for i, ((cin, cout, k, _, _), n) in enumerate(zip(tm.ALEX_LAYOUT, tm.ALEX_CONV_IDX)):
        w = rng.standard_normal((cout, cin, k, k)) * (cin * k * k) ** -0.5
        sd[f"net.slice{i + 1}.{n}.weight"] = torch.tensor(w, dtype=torch.float32)
        sd[f"net.slice{i + 1}.{n}.bias"] = torch.tensor(rng.normal(0, 0.05, cout), dtype=torch.float32)
        sd[f"lin{i}.model.1.weight"] = torch.tensor(rng.uniform(0, 0.1, (1, cout, 1, 1)),
                                                    dtype=torch.float32)
    sd["scaling_layer.shift"] = torch.tensor(tm.SHIFT)[None, :, None, None]
    return sd


def test_psnr_and_ssim_match_jax(images):
    a, b = images
    for ours, ref in ((tm.psnr, jm.psnr), (tm.ssim, jm.ssim)):
        got = ours(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        want = np.asarray(ref(jnp.asarray(a), jnp.asarray(b)))
        assert got.shape == want.shape == (3,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    same = tm.ssim(torch.from_numpy(a), torch.from_numpy(a))
    np.testing.assert_allclose(same.numpy(), 1.0, atol=1e-5)


def test_video_metrics_without_lpips_weights_match_jax(images, no_lpips):
    a, b = images
    assert not tm.lpips_available()
    got = tm.video_metrics(a, b, device="cpu")
    want = jm.video_metrics(a, b)
    assert set(got) == set(want) == {"psnr", "ssim", "lpips"}
    assert got["lpips"] is None and want["lpips"] is None
    for k in ("psnr", "ssim"):
        assert got[k] == pytest.approx(want[k], abs=1e-4)
    with pytest.raises(RuntimeError, match="load_lpips_weights"):
        tm.lpips(torch.from_numpy(a), torch.from_numpy(b))


def test_lpips_with_carried_across_weights_matches_jax(images, no_lpips, tmp_path):
    a, b = images
    path = str(tmp_path / "lpips_alex.pth")
    torch.save(_lpips_state(np.random.default_rng(1)), path)
    tm.load_lpips_weights(path)
    jm.load_lpips_weights(path)
    assert tm.lpips_available()
    a64 = np.random.default_rng(2).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    b64 = np.clip(a64 + 0.1, 0, 1).astype(np.float32)
    got = tm.lpips(torch.from_numpy(a64 * 2 - 1), torch.from_numpy(b64 * 2 - 1)).numpy()
    want = np.asarray(jm.lpips(jnp.asarray(a64 * 2 - 1), jnp.asarray(b64 * 2 - 1)))
    assert got.shape == want.shape == (2,) and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert tm.video_metrics(a64, b64, device="cpu")["lpips"] == pytest.approx(
        jm.video_metrics(a64, b64)["lpips"], rel=1e-4)


def test_lpips_name_resolution_matches_jax():
    """Layouts (b) + (c): torchvision's alexnet features with the lin-only
    heads resolve as in the JAX package; a missing head raises."""
    rng = np.random.default_rng(3)
    sd = {}
    for i, n in enumerate(tm.ALEX_CONV_IDX):
        sd[f"features.{n}.weight"] = rng.standard_normal(4).astype(np.float32)
        sd[f"features.{n}.bias"] = rng.standard_normal(2).astype(np.float32)
        sd[f"lins.{i}.model.1.weight"] = rng.standard_normal(3).astype(np.float32)
    got, want = tm._resolve_lpips_arrays(sd), jm._resolve_lpips_arrays(sd)
    assert got.keys() == want.keys() and len(got) == 15
    assert all(np.array_equal(got[k], want[k]) for k in got)
    del sd["lins.4.model.1.weight"]
    with pytest.raises(KeyError, match="linear head"):
        tm._resolve_lpips_arrays(sd)
