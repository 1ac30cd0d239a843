"""The port's native PLY writer (`csrc/ply_writer.cpp`, built with g++ on
first use) against the JAX package's native writer, byte for byte, and
against the port's Python loop, value for value to `%.6g`."""

import numpy as np
import pytest

from viewcrafter_tpu import native as jax_native
from viewcrafter_tpu_torch.utils import io as vio


def _cloud(n: int):
    rng = np.random.default_rng(n)
    pts = rng.standard_normal((n, 3)).astype(np.float32) * 10.0 ** rng.integers(-6, 7, (n, 3))
    special = np.array([[-1.5, 0.0, 3.25], [1e-30, -1e-38, 1e30], [-3.4e38, 123456789.0, -0.0],
                        [0.1, -7.0, 1.0 / 3.0]], np.float32)
    pts[:4] = special[:n]
    return pts, rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("n", [0, 1, 4, 5000])
def test_native_writer_matches_the_jax_writer_and_the_python_loop(tmp_path, n):
    pts, cols = _cloud(n)
    ours, theirs, plain = (str(tmp_path / f"{w}.ply") for w in ("ours", "jax", "plain"))
    assert vio.save_pointcloud_ply(pts, cols, ours) == ours
    assert jax_native.write_ply(theirs, pts, vio.to_uint8(cols) if n else cols.astype(np.uint8))
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    vio.save_pointcloud_ply_plain(pts, cols, plain)
    with open(ours) as a, open(plain) as b:
        got, want = a.read().splitlines(), b.read().splitlines()
    assert got[:13] == want[:13] and len(got) == len(want) == 13 + n  # 13 header lines
    for g, w in zip(got[13:], want[13:]):
        g, w = g.split(), w.split()
        assert g[:3] == ["%.6g" % float(x) for x in w[:3]] and g[3:] == w[3:]


def test_a_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(vio, "PLY_SOURCE", broken)
    monkeypatch.setattr(vio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(vio, "_ply_lib", None)
    with pytest.raises(RuntimeError, match="native PLY writer"):
        vio.build_ply_writer()
    # the writer itself raises rather than falling back to the Python loop
    with pytest.raises(RuntimeError, match="native PLY writer"):
        vio.save_pointcloud_ply(*_cloud(3), str(tmp_path / "x.ply"))
    assert not (tmp_path / "x.ply").exists()
