"""The port's stereo/flow data side and eval CLI against the JAX package, on
the CPU: the file formats (each written by the port and read back by both
packages), the visualizations, the KITTI 2015 layout's items, the data-set
string parser, both augmentors under the same seed, and the eval CLI on the
ETH3D and MPI-Sintel trees of tests/test_stereoflow_eval.py, fed the same
weights (orbax for the JAX package, `save_params` for the port).

Tolerances: the readers, writers, visualizations, data items and
augmentations exactly (the same numpy, PIL and cv2 calls on the same
bytes and the same draws). The eval CLI in float32 on both sides (the JAX
CLI's model built in float32, the port's `eval.DTYPE` float32): its metrics
rtol 1e-5, the predictions in its submission files 1e-5 of the largest
(the models agree to 1e-5, tests/test_torch_stereoflow.py); in the CLIs'
default bf16, the predictions within 2e-2 of the largest (the two packages
round their bf16 products in other places).
"""

import functools
import json
import os
import os.path as osp
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from viewcrafter_tpu.models import croco_downstream as jcd
from viewcrafter_tpu.stereoflow import augmentor as jaug
from viewcrafter_tpu.stereoflow import data as jdata
from viewcrafter_tpu.stereoflow import eval as jeval
from viewcrafter_tpu.utils.checkpoint import save_params as jax_save_params
from viewcrafter_tpu_torch.convert import croco_downstream_from_jax_params
from viewcrafter_tpu_torch.stereoflow import augmentor as paug
from viewcrafter_tpu_torch.stereoflow import data as pdata
from viewcrafter_tpu_torch.stereoflow import eval as peval
from viewcrafter_tpu_torch.train_loop import AdamW, LoopState, constant_schedule
from viewcrafter_tpu_torch.training import TrainState
from viewcrafter_tpu_torch.utils.checkpoint import load_params, save_params

TINY_CROCO = dict(
    img_size=(32, 64), patch_size=16, enc_embed_dim=32, enc_depth=2,
    enc_num_heads=2, dec_embed_dim=32, dec_depth=8, dec_num_heads=2,
    dpt_layer_dims=(8, 16, 24, 32), dpt_feature_dim=16,
    dpt_last_dim=8, hooks_idx=(1, 4, 7, 9),
)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# -- file formats -------------------------------------------------------------


def _disp(seed, h=7, w=11):
    return np.abs(np.random.default_rng(seed).normal(20, 5, (h, w))).astype(np.float32)


def _flow(seed, h=7, w=11):
    return np.random.default_rng(seed).normal(0, 3, (h, w, 2)).astype(np.float32)


FORMATS = {
    # name: (writer, port reader, JAX reader, data, suffix)
    "pfm": (pdata.write_pfm, lambda f: pdata.read_pfm(f)[0], lambda f: jdata.read_pfm(f)[0],
            _disp(0), ".pfm"),
    "pfm_color": (pdata.write_pfm, lambda f: pdata.read_pfm(f)[0],
                  lambda f: jdata.read_pfm(f)[0],
                  np.random.default_rng(1).standard_normal((5, 4, 3)).astype(np.float32), ".pfm"),
    "pfm_disp": (pdata.write_pfm, pdata.read_pfm_disp, jdata.read_pfm_disp,
                 np.where(_disp(2) > 20, _disp(2), 0).astype(np.float32), ".pfm"),
    "flo": (pdata.write_flo, pdata.read_flo, jdata.read_flo, _flow(3), ".flo"),
    "kitti_flow": (pdata.write_kitti_flow, pdata.read_kitti_flow, jdata.read_kitti_flow,
                   _flow(4), ".png"),
    "kitti_disp": (pdata._write_png_u16, pdata.read_kitti_disp, jdata.read_kitti_disp,
                   _disp(5), ".png"),
    "dsp5": (pdata.write_dsp5, pdata.read_hdf5_disp, jdata.read_hdf5_disp,
             np.where(_disp(6) > 20, _disp(6), np.nan).astype(np.float32), ".dsp5"),
    "flo5": (pdata.write_flo5, pdata.read_hdf5_flow, jdata.read_hdf5_flow, _flow(7), ".flo5"),
}


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_format_round_trip(tmp_path, fmt):
    """Written by the port, read back by the port and by the JAX package:
    both reads equal; lossless formats give back what was written, the
    KITTI PNGs within their quantization, invalid pixels +inf."""
    if fmt in ("kitti_flow",):
        pytest.importorskip("cv2")
    if fmt in ("dsp5", "flo5"):
        pytest.importorskip("h5py")
    write, read, jread, data, suffix = FORMATS[fmt]
    path = str(tmp_path / ("x" + suffix))
    write(path, data)
    got, ref = read(path), jread(path)
    _equal(got, ref)
    if fmt == "kitti_flow":
        np.testing.assert_allclose(got, data, atol=1 / 64.0)
    elif fmt == "kitti_disp":
        np.testing.assert_allclose(got, data, atol=1 / 256.0)
    elif fmt in ("pfm_disp", "dsp5"):
        bad = ~(data > 20)
        assert np.isinf(got[bad]).all() and np.array_equal(got[~bad], data[~bad])
    else:
        _equal(got, data)


def test_visualizations_match_jax():
    pytest.importorskip("cv2")
    disp = np.linspace(1, 50, 24 * 30).reshape(24, 30).astype(np.float32)
    _equal(pdata.vis_disparity(disp), jdata.vis_disparity(disp))
    _equal(pdata.vis_disparity(disp, m=5.0, M=30.0), jdata.vis_disparity(disp, m=5.0, M=30.0))
    flow = _flow(9, 24, 30) * 4
    flow[0, :3] = 1e10  # unknown
    for kw in ({}, {"maxflow": 7.5}, {"saturate": True}):
        _equal(pdata.flow_to_color(flow, **kw), jdata.flow_to_color(flow, **kw))
    assert pdata.flow_to_color(flow).dtype == np.uint8


# -- the data sets --------------------------------------------------------------


def _make_kitti15_tree(root):
    """The tree of tests/test_stereoflow_data.py: 3 training and 2 testing
    pairs of 32x48, uint16 disparities."""
    rng = np.random.default_rng(6)
    for sub, n in [("training", 3), ("testing", 2)]:
        for cam in ("image_2", "image_3"):
            os.makedirs(osp.join(root, sub, cam), exist_ok=True)
        os.makedirs(osp.join(root, "training", "disp_occ_0"), exist_ok=True)
        for i in range(n):
            for cam in ("image_2", "image_3"):
                img = rng.integers(0, 255, (32, 48, 3), np.uint8)
                Image.fromarray(img).save(osp.join(root, sub, cam, "%06d_10.png" % i))
            if sub == "training":
                disp = rng.integers(256, 8000, (32, 48), np.uint16)
                Image.fromarray(disp).save(osp.join(root, "training", "disp_occ_0",
                                                    "%06d_10.png" % i))


@pytest.mark.parametrize("augment", [False, True])
def test_kitti15_items_match_jax(tmp_path, augment):
    """Every item of the KITTI 2015 layout, plain and augmented (crop 16x24,
    one seed for both packages), equal to the JAX package's."""
    if augment:
        pytest.importorskip("cv2")
    root = str(tmp_path / "kitti15")
    _make_kitti15_tree(root)
    kw = dict(augmentor=True, crop_size=(16, 24)) if augment else {}
    sets = [mod.Kitti15Stereo("train", root=root, rng=np.random.default_rng(3), **kw)
            for mod in (pdata, jdata)]
    for ds in sets:
        ds.pairnames = ds.pairnames[:3]
    assert str(sets[0]) == str(sets[1]) == "Kitti15Stereo_train"
    for i in range(3):
        got, ref = sets[0][i], sets[1][i]
        for g, r in zip(got[:3], ref[:3]):
            _equal(g, r)
        assert got[3] == ref[3] == "training/image_2/%06d" % i
        assert got[0].shape == ((16, 24, 3) if augment else (32, 48, 3))
    test = pdata.Kitti15Stereo("test", root=root)
    test.pairnames = test.pairnames[:2]
    assert test[0][2] is None


def test_dataset_str_parser(tmp_path, monkeypatch):
    """The registries and `_parse_dataset_str`: the multiplier, the split,
    the lengths the JAX package's parser gives; a bad string raises."""
    root = str(tmp_path / "kitti15")
    _make_kitti15_tree(root)
    monkeypatch.setattr(pdata, "STEREOFLOW_ROOT", str(tmp_path))
    monkeypatch.setattr(jdata, "STEREOFLOW_ROOT", str(tmp_path))
    for mod in (pdata, jdata):
        monkeypatch.setattr(mod.Kitti15Stereo, "default_subdir", "kitti15")
    assert sorted(pdata.STEREO_DATASETS) == sorted(jdata.STEREO_DATASETS)
    assert sorted(pdata.FLOW_DATASETS) == sorted(jdata.FLOW_DATASETS)
    (ds,) = pdata.get_test_datasets_stereo("Kitti15('subval')")
    (ds2, ds3) = pdata.get_train_dataset_stereo("3*Kitti15('subval')+Kitti15('train')",
                                                augmentor=False)
    (j2, j3) = jdata.get_train_dataset_stereo("3*Kitti15('subval')+Kitti15('train')",
                                              augmentor=False)
    assert (len(ds), len(ds2), len(ds3)) == (5, 15, 200) == (5, len(j2), len(j3))
    assert ds2.pairnames == j2.pairnames and ds2.augmentor is None
    with pytest.raises(ValueError, match="bad dataset spec"):
        pdata.get_test_datasets_stereo("Kitti15(subval)")
    with pytest.raises(KeyError, match="unknown dataset"):
        pdata.get_test_datasets_flow("Kitti99('train')")


def test_stereoflow_root_from_the_environment():
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-c", "import viewcrafter_tpu_torch.stereoflow.data as d; "
                               "print(d.STEREOFLOW_ROOT)"],
        capture_output=True, text=True, check=True, timeout=60,
        env={**os.environ, "VIEWCRAFTER_STEREOFLOW_ROOT": "/data/sf"})
    assert out.stdout.strip() == "/data/sf"


def test_to_model_input_matches_jax():
    img = np.random.default_rng(2).integers(0, 256, (5, 6, 3)).astype(np.uint8)
    _equal(pdata.to_model_input(img), jdata.to_model_input(img))


# -- the augmentors -------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stereo_augmentor_matches_jax(seed):
    """StereoAugmentor with one seed in both packages, on a low-res and a
    high-res pair: equal images and disparities, draw for draw."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(100 + seed)
    for h, w in ((40, 60), (820, 900)):
        img1 = rng.integers(0, 255, (h, w, 3)).astype(np.float32)
        img2 = rng.integers(0, 255, (h, w, 3)).astype(np.float32)
        disp = np.abs(rng.normal(10, 3, (h, w))).astype(np.float32)
        disp[rng.uniform(size=(h, w)) < 0.1] = np.inf
        outs = [mod.StereoAugmentor((32, 48), rng=np.random.default_rng(seed))(
            img1.copy(), img2.copy(), disp.copy()) for mod in (paug, jaug)]
        for g, r in zip(*outs):
            _equal(g, r)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("sparse", [False, True])
def test_flow_augmentor_matches_jax(seed, sparse):
    """FlowAugmentor with one seed in both packages, dense flow (cv2's
    resize) and sparse flow (the splatting resize), Spring's and another
    data set's names."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(200 + seed)
    img1 = rng.integers(0, 255, (40, 60, 3)).astype(np.uint8)
    img2 = rng.integers(0, 255, (40, 60, 3)).astype(np.uint8)
    flow = rng.normal(0, 3, (40, 60, 2)).astype(np.float32)
    if sparse:
        flow[rng.uniform(size=(40, 60)) < 0.5] = np.inf
    for dname in ("", "Spring"):
        outs = [mod.FlowAugmentor((24, 32), rng=np.random.default_rng(seed))(
            img1.copy(), img2.copy(), flow.copy(), dname) for mod in (paug, jaug)]
        for g, r in zip(*outs):
            _equal(g, r)


def test_color_ops_match_jax():
    img = np.random.default_rng(8).integers(0, 255, (12, 10, 3), np.uint8)
    for op, factors in (("adjust_brightness", (0.5, 1.3)), ("adjust_contrast", (0.5, 1.3)),
                        ("adjust_saturation", (0.5, 1.3)), ("adjust_gamma", (0.7, 1.5)),
                        ("adjust_hue", (-0.1, 0.3))):
        for f in factors:
            _equal(getattr(paug, op)(img, f), getattr(jaug, op)(img, f))
    sparse = np.full((8, 10, 2), np.inf, np.float32)
    sparse[2, 3], sparse[5, 7] = (1.0, -2.0), (0.5, 0.25)
    _equal(paug.resize_sparse_flow(sparse, 2.0, 1.5), jaug.resize_sparse_flow(sparse, 2.0, 1.5))


# -- the eval CLI ---------------------------------------------------------------


def _weights(tmp_path, task):
    """One tiny model's JAX weights (flax's init), written for both
    packages: an orbax directory and the port's `save_params` file, each
    beside the same JSON sidecar."""
    nch = {"stereo": 1, "flow": 2}[task] + 1
    model = jcd.CroCoDownstreamBinocular(cfg=jcd.CroCoDownstreamConfig(num_channels=nch,
                                                                       **TINY_CROCO))
    z = jnp.zeros((1, 32, 64, 3), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), z, z)
    meta = {"task": task, "with_conf": True, "crop": [32, 64],
            "tile_conf_mode": "conf_expsigmoid_10_5",
            "croco": {k: list(v) if isinstance(v, tuple) else v for k, v in TINY_CROCO.items()}}
    paths = {"jax": osp.join(tmp_path, f"jax_{task}"), "port": osp.join(tmp_path, f"port_{task}.pt")}
    jax_save_params(paths["jax"], params)
    save_params(paths["port"], croco_downstream_from_jax_params(jax.tree.map(np.array, params)))
    for p in paths.values():
        with open(p + ".json", "w") as fid:
            json.dump(meta, fid)
    return paths


def _png(path, h=48, w=96, seed=0):
    os.makedirs(osp.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(path)


def _run_both(monkeypatch, tmp_path, task, argv, float32):
    """The JAX CLI and the port's (on the CPU) over one tree with the same
    weights; returns their output directories and results."""
    paths = _weights(tmp_path, task)
    root = osp.join(tmp_path, "stereoflow")
    monkeypatch.setattr(jdata, "STEREOFLOW_ROOT", root)
    monkeypatch.setattr(pdata, "STEREOFLOW_ROOT", root)
    if float32:
        monkeypatch.setattr(jcd, "CroCoDownstreamBinocular",
                            functools.partial(jcd.CroCoDownstreamBinocular, dtype=jnp.float32))
        monkeypatch.setattr(peval, "DTYPE", torch.float32)
    out = {}
    for name, mod, extra in (("jax", jeval, []), ("port", peval, ["--device", "cpu"])):
        outdir = osp.join(tmp_path, "out_" + name)
        args = mod.get_args_parser().parse_args(
            ["--model", paths[name], "--out_dir", outdir] + argv + extra)
        out[name] = (outdir, mod.main(args))
    return out


@pytest.mark.parametrize("float32", [True, False])
def test_eval_cli_stereo_eth3d_matches_jax(tmp_path, monkeypatch, float32):
    """ETH3D's train split: the metrics JSON, the .npy predictions and the
    PFM submission with its zip, against the JAX CLI's."""
    tmp_path = str(tmp_path)
    root = osp.join(tmp_path, "stereoflow", "eth3d_lowres")
    _png(osp.join(root, "train", "sceneA", "im0.png"))
    _png(osp.join(root, "train", "sceneA", "im1.png"), seed=1)
    os.makedirs(osp.join(root, "test"), exist_ok=True)
    gt = np.abs(np.random.default_rng(2).normal(2.0, 1.0, (48, 96))).astype(np.float32)
    os.makedirs(osp.join(root, "train_gt", "sceneA"), exist_ok=True)
    jdata.write_pfm(osp.join(root, "train_gt", "sceneA", "disp0GT.pfm"), gt)
    out = _run_both(monkeypatch, tmp_path, "stereo",
                    ["--dataset", "ETH3DLowRes('train')", "--save", "metrics", "pred", "visu",
                     "err10", "submission", "--tile_overlap", "0.7"], float32)
    (jdir, jres), (pdir, pres) = out["jax"], out["port"]
    assert set(pres) == set(jres) == {"ETH3DLowRes_train"}
    res, ref = pres["ETH3DLowRes_train"], jres["ETH3DLowRes_train"]
    assert set(res) == set(ref)
    rtol = 1e-5 if float32 else 2e-2
    for k in ref:
        if k == "L1err":
            np.testing.assert_allclose(res[k], ref[k], rtol=rtol, err_msg=k)
        elif float32:  # shares of pixels past a threshold: equal unless a pixel sits on it
            np.testing.assert_allclose(res[k], ref[k], atol=100 / (48 * 96) + 1e-9, err_msg=k)
    jfile = [f for f in os.listdir(jdir) if f.endswith(".json")]
    assert [f for f in os.listdir(pdir) if f.endswith(".json")] == jfile
    with open(osp.join(pdir, jfile[0])) as fid:
        assert json.load(fid) == res
    for name in ("sceneA_pred.png", "sceneA_err10.png"):
        assert osp.isfile(osp.join(pdir, "train", name))
    pred, jpred = (np.load(osp.join(d, "train", "sceneA_pred.npy")) for d in (pdir, jdir))
    assert pred.shape == jpred.shape == (48, 96, 1) and np.isfinite(pred).all()
    tol = (1e-5 if float32 else 2e-2) * np.abs(jpred).max()
    np.testing.assert_allclose(pred, jpred, atol=tol, rtol=0)
    sub = "submission_conf_conf_expsigmoid_10_5_overlap_0.7"
    pfm, jpfm = (jdata.read_pfm(osp.join(d, sub, "low_res_two_view", "sceneA.pfm"))[0]
                 for d in (pdir, jdir))
    np.testing.assert_allclose(pfm, jpfm, atol=tol, rtol=0)
    with open(osp.join(pdir, sub, "low_res_two_view", "sceneA.txt")) as fid:
        assert fid.read().startswith("runtime ")
    names = [sorted(zipfile.ZipFile(osp.join(d, sub, "eth3d_low_res_two_view_results.zip"))
                    .namelist()) for d in (pdir, jdir)]
    assert names[0] == names[1] == ["low_res_two_view/sceneA.pfm", "low_res_two_view/sceneA.txt"]


def test_eval_cli_flow_sintel_matches_jax(tmp_path, monkeypatch):
    """MPI-Sintel's test_allpass in float32: the .flo submission files of
    both passes against the JAX CLI's."""
    tmp_path = str(tmp_path)
    root = osp.join(tmp_path, "stereoflow", "MPI-Sintel")
    for pas in ("clean", "final"):
        for i in (1, 2):
            _png(osp.join(root, "test", pas, "seq_1", f"frame_{i:04d}.png"), seed=i)
    out = _run_both(monkeypatch, tmp_path, "flow",
                    ["--dataset", "MPISintel('test_allpass')", "--save", "submission"], True)
    sub = osp.join("submission_conf_conf_expsigmoid_10_5_overlap_0.7", "submission")
    for pas in ("clean", "final"):
        flo, jflo = (pdata.read_flo(osp.join(out[k][0], sub, "test", pas, "seq_1",
                                              "frame_0001.flo")) for k in ("port", "jax"))
        assert flo.shape == jflo.shape == (48, 96, 2) and np.isfinite(flo).all()
        np.testing.assert_allclose(flo, jflo, atol=1e-5 * np.abs(jflo).max(), rtol=0)


@pytest.mark.parametrize("form", ["train_state", "loop_state"])
def test_eval_loads_a_training_state(tmp_path, form):
    """The eval CLI's weights file may hold a `TrainState` or a `LoopState`
    (what a training loop saves): the model gets their master weights,
    equal to those loaded from the bare state dict."""
    plain = _weights(str(tmp_path), "stereo")["port"]
    params = load_params(plain, device="cpu")
    state = TrainState(params=params, opt_state=AdamW(constant_schedule(1e-3)).init(params),
                       step=3)
    if form == "loop_state":
        state = LoopState(train=state, ema=None, generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / f"{form}.pt")
    save_params(path, state)
    with open(plain + ".json") as src, open(path + ".json", "w") as dst:
        dst.write(src.read())
    want = peval._load_model(plain, "", "cpu")[0].state_dict()
    got = peval._load_model(path, "", "cpu")[0].state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_eval_cli_needs_a_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = peval.get_args_parser().parse_args(["--model", str(tmp_path / "none.pt"),
                                               "--dataset", "Kitti15('test')"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peval.main(args)
