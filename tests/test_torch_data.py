"""The port's training data sets against the JAX package's, on the CPU: the
JAX package's cases for `WebVidDataset`, `PairedRenderDataset`,
`Co3dPairDataset` and `PrefetchLoader` (tests/test_training_extras.py) on
data sets built under tmp_path, each item also held against the JAX
package's item from the same files and seed; and `SyntheticMultiviewGenerator`
against the JAX one in this process (the same scene, one rendered view) with
the invariants of tests/test_synth_multiview.py.

Tolerances: the decoded frames, crops and draws exactly (the same numpy and
PIL code); the Co3D points within 1e-6 relative (float32 unprojection in
torch against jnp); a rendered view as the rasterizer's parity test holds it
(tests/test_torch_geometry.py): the same covered pixels, colors and depth
within 1e-5, the 8-bit image within one level (a color within 1e-5 of a
rounding boundary may round either way).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from viewcrafter_tpu.data import co3d as jax_co3d
from viewcrafter_tpu.data import datasets as jax_datasets
from viewcrafter_tpu.data import synth_multiview as jax_synth
from viewcrafter_tpu_torch.data import co3d, datasets
from viewcrafter_tpu_torch.data.synth_multiview import (
    SceneConfig, SyntheticMultiviewGenerator, build_scene, camera_intrinsics_from_hfov,
    look_at_rdf, pointcloud_overlap)
from viewcrafter_tpu_torch.models.dust3r_losses import conf_loss
from viewcrafter_tpu_torch.pretrain import collate_views


def _assert_items_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            assert got[k] == ref[k], k


def _frames(d, n, rng, size=(32, 48)):
    os.makedirs(d)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(d / f"{i:03d}.png")


def test_paired_dataset_and_prefetch_loader(tmp_path):
    rng = np.random.default_rng(1)
    for sub in ("videos", "renders"):
        _frames(tmp_path / sub / "clip0", 6, rng)
    kw = dict(video_length=4, resolution=(16, 24))
    ds = datasets.PairedRenderDataset(str(tmp_path), **kw)
    item = ds[0]
    assert item["video"].shape == (4, 16, 24, 3)
    assert item["video_cond"].shape == (4, 16, 24, 3)
    assert -1.0 <= item["video"].min() and item["video"].max() <= 1.0
    assert 0 <= item["frameid"] < 4
    _assert_items_equal(item, jax_datasets.PairedRenderDataset(str(tmp_path), **kw)[0])

    batches = list(datasets.PrefetchLoader(datasets.PairedRenderDataset(str(tmp_path), **kw),
                                           batch_size=1))
    ref = list(jax_datasets.PrefetchLoader(
        jax_datasets.PairedRenderDataset(str(tmp_path), **kw), batch_size=1))
    assert len(batches) == len(ref) == 1
    assert batches[0]["video"].shape == (1, 4, 16, 24, 3)
    _assert_items_equal(batches[0], ref[0])


def test_prefetch_loader_batches_and_collates():
    """Batches of 2 in the dataset's order, the last partial batch dropped;
    arrays stacked, numbers as arrays, strings as lists."""
    items = [{"x": np.full((2,), i, np.float32), "n": i, "s": f"item{i}"} for i in range(5)]
    got = list(datasets.PrefetchLoader(items, batch_size=2, prefetch=1))
    ref = list(jax_datasets.PrefetchLoader(items, batch_size=2, prefetch=1))
    assert len(got) == 2
    assert got[1]["s"] == ["item2", "item3"]
    np.testing.assert_array_equal(got[0]["n"], [0, 1])
    for g, r in zip(got, ref):
        _assert_items_equal(g, r)


def test_webvid_dataset(tmp_path):
    _frames(tmp_path / "part0" / "vid42", 10, np.random.default_rng(2))
    csv_path = tmp_path / "meta.csv"
    csv_path.write_text("videoid,page_dir,name\nvid42,part0,a rotating scene\n")
    kw = dict(video_length=4, frame_stride=2, resolution=(16, 24))
    item = datasets.WebVidDataset(str(csv_path), str(tmp_path), **kw)[0]
    assert item["video"].shape == (4, 16, 24, 3)
    assert item["caption"] == "a rotating scene"
    _assert_items_equal(item, jax_datasets.WebVidDataset(str(csv_path), str(tmp_path), **kw)[0])


def test_co3d_pair_dataset(tmp_path):
    rng = np.random.default_rng(4)
    cat, inst = "apple", "110_13051_23361"
    base = tmp_path / cat / inst
    for sub in ("images", "depths", "masks"):
        os.makedirs(base / sub)
    h, w = 40, 60
    K = np.array([[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1]], np.float32)
    for i in range(6):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            base / "images" / f"frame{i:06d}.jpg")
        depth16 = np.full((h, w), 32767, np.uint16)  # a flat plane at max_depth / 2
        depth16[10:20, 20:30] = 20000  # and a step in it
        Image.fromarray(depth16).save(base / "depths" / f"frame{i:06d}.jpg.geometric.png")
        mask = np.zeros((h, w), np.uint8)
        mask[4:-4, 6:-6] = 255
        Image.fromarray(mask).save(base / "masks" / f"frame{i:06d}.png")
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.1 * i, -0.05 * i, 0.02 * i]
        np.savez(base / "images" / f"frame{i:06d}.npz", camera_pose=pose,
                 camera_intrinsics=K, maximum_depth=np.float32(4.0))
    (tmp_path / "selected_seqs_train.json").write_text(
        '{"apple": {"110_13051_23361": [0, 1, 2, 3, 4, 5]}}')
    kw = dict(split="train", resolution=(32, 48), num_frames=6, max_step=5, angle_step=5)
    ds = co3d.Co3dPairDataset(str(tmp_path), jitter=0, **kw)
    assert len(ds) == 1  # one scene x one (0, 5) pair
    v1, v2 = ds[0]
    for v in (v1, v2):
        assert v["img"].shape == (32, 48, 3) and -1 <= v["img"].min() <= v["img"].max() <= 1
        assert v["pts3d"].shape == (32, 48, 3) and v["pts3d"].dtype == np.float32
        assert v["valid_mask"].shape == (32, 48)
        assert not v["valid_mask"][0, 0] and v["valid_mask"][28, 40]  # bg masked out
    # frame 0's pose is the identity: world z is the depth, half max_depth
    np.testing.assert_allclose(v1["pts3d"][28, 40, 2], 32767 / 65535 * 4.0, rtol=1e-3)
    # against the JAX package's items, with and without the frame jitter
    for jitter in (0, 4):
        got = co3d.Co3dPairDataset(str(tmp_path), jitter=jitter, seed=3, **kw)[0]
        ref = jax_co3d.Co3dPairDataset(str(tmp_path), jitter=jitter, seed=3, **kw)[0]
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g["pts3d"], r["pts3d"], rtol=1e-6, atol=1e-6)
            _assert_items_equal({k: v for k, v in g.items() if k != "pts3d"},
                                {k: v for k, v in r.items() if k != "pts3d"})
    np.testing.assert_array_equal(co3d.crop_resize_with_intrinsics(
        np.zeros((40, 60, 3), np.uint8), np.ones((40, 60), np.float32), K, (20, 20))[2],
        jax_co3d.crop_resize_with_intrinsics(
            np.zeros((40, 60, 3), np.uint8), np.ones((40, 60), np.float32), K, (20, 20))[2])

    def batch(v):
        return {k: torch.as_tensor(v[k])[None] for k in ("pts3d", "valid_mask", "camera_pose")}

    conf = torch.full((1, 32, 48), 2.0)
    total, _ = conf_loss(batch(v1), batch(v2),
                         {"pts3d": torch.as_tensor(v1["pts3d"])[None] * 1.1, "conf": conf},
                         {"pts3d_in_other_view": torch.as_tensor(v2["pts3d"])[None], "conf": conf})
    assert np.isfinite(total.item())


# -- the synthetic multiview generator ---------------------------------------

TINY = SceneConfig(floor_points=8000, n_primitives=4, primitive_points=1500, wall_points=6000)
GEN_KW = dict(resolution=(48, 64), scene_cfg=TINY, minimum_covisibility=0.2,
              minimum_valid_fraction=0.45, distance_threshold=0.15, scenes_pool=2, splat_px=5.0)


def make_gen(**kw):
    return SyntheticMultiviewGenerator(**{**GEN_KW, "device": "cpu", **kw})


def test_generator_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticMultiviewGenerator(**GEN_KW)
    assert make_gen().device.type == "cpu"


def test_generator_scene_and_render_match_jax():
    """In one process (Python's salted hash seeds both alike): the same
    scene, and one view rendered within the rasterizer's tolerance."""
    gen, ref_gen = make_gen(seed=3), jax_synth.SyntheticMultiviewGenerator(**GEN_KW, seed=3)
    for a, b in zip(gen._scene(1), ref_gen._scene(1)):
        np.testing.assert_array_equal(a, b)
    pos, rot = gen.sample_random_viewpoint(np.random.default_rng(5))
    ref_pos, ref_rot = ref_gen.sample_random_viewpoint(np.random.default_rng(5))
    np.testing.assert_array_equal(pos, ref_pos)
    np.testing.assert_array_equal(rot, ref_rot)
    got, ref = gen.render_viewpoint(1, pos, rot), ref_gen.render_viewpoint(1, pos, rot)
    assert ref["valid"].mean() > 0.3
    assert np.array_equal(got["valid"], ref["valid"])
    np.testing.assert_allclose(got["depthmap"], ref["depthmap"], atol=1e-5, rtol=1e-5)
    assert np.abs(got["img"].astype(int) - ref["img"].astype(int)).max() <= 1
    for k in ("camera_pose", "camera_intrinsics"):
        np.testing.assert_array_equal(got[k], ref[k])


def test_intrinsics_hfov():
    K = camera_intrinsics_from_hfov(240, 320, 90.0)
    assert np.isclose(K[0, 0], 160.0)  # f = (W/2)/tan(45 deg)
    assert np.isclose(K[0, 2], 160.0) and np.isclose(K[1, 2], 120.0)
    assert np.isclose(K[0, 0], K[1, 1])


def test_look_at_rdf_points_camera_z_at_target():
    eye = np.array([1.0, -1.5, 2.0])
    center = np.array([0.0, -0.5, 0.0])
    R = look_at_rdf(eye, center)
    fwd = (center - eye) / np.linalg.norm(center - eye)
    assert np.allclose(R[:, 2], fwd, atol=1e-9)
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-9)
    assert np.linalg.det(R) > 0.99


def test_pointcloud_overlap_counts():
    a = np.zeros((10, 3))
    b = np.zeros((5, 3)) + np.array([0.0, 0.0, 0.04])
    assert pointcloud_overlap(a, b, threshold=0.05) == (10, 5)
    assert pointcloud_overlap(a, b + 1.0, threshold=0.05) == (0, 0)


def test_build_scene_bounds():
    pts, cols = build_scene(np.random.default_rng(0), TINY)
    assert pts.shape[1] == 3 and cols.shape == pts.shape
    assert cols.min() >= 0.0 and cols.max() <= 1.0
    assert pts[:, 1].min() >= -TINY.wall_height - 1.0
    assert pts[:, 1].max() <= 0.5


def test_render_viewpoint_geometry_roundtrip():
    """Depth unprojection lands back on the scene's points."""
    g = make_gen()
    pos, rot = g.sample_random_viewpoint(np.random.default_rng(3))
    obs = g.render_viewpoint(0, pos, rot)
    assert obs["img"].shape == (48, 64, 3) and obs["img"].dtype == np.uint8
    assert obs["depthmap"].shape == (48, 64)
    assert (obs["depthmap"][obs["valid"]] > 0).all()
    pc = g._unproject(obs)
    pts, _ = g._scene(0)
    i1, _ = pointcloud_overlap(pc, pts, threshold=0.2)
    assert i1 / max(len(pc), 1) > 0.8


def test_getitem_covisible_pair_and_croco_format():
    g = make_gen(views_count=2, size=4, seed=1)
    v0, v1 = g[0]
    for v in (v0, v1):
        R = v["camera_pose"][:3, :3]
        assert v["camera_pose"].shape == (4, 4) and np.allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert v1["covisibility"] >= g.minimum_covisibility
    assert np.linalg.norm(v0["camera_pose"][:3, 3] - v1["camera_pose"][:3, 3]) > 1e-3
    for v in g.as_croco_pairs(0):
        assert v["img"].dtype == np.float32
        assert v["img"].min() >= -1.0 and v["img"].max() <= 1.0
        assert v["camera_intrinsics"].shape == (3, 3)
    # the Co3dPairDataset layout: world points that project back to the depth
    pairs = g.as_dust3r_pairs(0)
    for v, raw in zip(pairs, (v0, v1)):
        assert v["pts3d"].shape == (48, 64, 3) and v["pts3d"].dtype == np.float32
        assert np.array_equal(v["valid_mask"], raw["depthmap"] > 0)
        w2c = np.linalg.inv(v["camera_pose"].astype(np.float64))
        z = (v["pts3d"] @ w2c[:3, :3].T + w2c[:3, 3])[..., 2]
        np.testing.assert_allclose(z[v["valid_mask"]], raw["depthmap"][v["valid_mask"]],
                                   rtol=1e-4, atol=1e-4)
    batch = [collate_views([p]) for p in pairs]
    total, _ = conf_loss(*batch, {"pts3d": batch[0]["pts3d"] * 1.1,
                                  "conf": torch.full((1, 48, 64), 2.0)},
                         {"pts3d_in_other_view": batch[1]["pts3d"] * 0.9,
                          "conf": torch.full((1, 48, 64), 2.0)})
    assert np.isfinite(total.item())
