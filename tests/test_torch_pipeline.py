"""The photo -> video path of the port against the JAX package:
`ViewCrafterPipeline.run()` in `single_view_target` and `single_view_txt`
on the JAX package's tiny fixture (`tests/test_pipeline.py`: dust3r_tiny,
viewcrafter_tiny, 64 px, 4 frames, niter 5, 2 DDIM steps) with fp32 weight
storage. Both pipelines hold the same weights (DUSt3R's from the JAX
pipeline's seeded init, the diffusion stack's from `torch_parity`, every
leaf non-zero), carried across with `convert`, and get the same diffusion
noise: the draws the JAX `run_diffusion` makes from the key it splits off
its pipeline key, rebuilt by `torch_parity.jax_noise`.

Both pipelines build their networks in float32 here
(`torch_parity.pipelines_f32`). In bf16 the two packages round at other
points, and random DUSt3R weights give pointmaps whose small differences
expm1 and a five-step alignment of an ill-posed scene blow up (scene
depths 8x apart in a trial): no fixed tolerance holds that. The bf16 networks are held against the JAX package module by module
(`test_torch_dust3r.py`, `test_torch_generate.py`); the alignment and the
rasterizer are float32 in both packages whatever the networks' type.

Tolerances (each error relative to the largest magnitude of the JAX array):
scene depths, poses and focals within 2e-2; at least 99% of the rendered
guidance pixels within 2e-2 on every channel (a point that rounding moves
across a pixel border changes that pixel alone); the video within 5e-2 at
most and 5e-3 on average.
"""

import os

import jax
import numpy as np
import pytest
import torch

import torch_parity as tp
from viewcrafter_tpu.pipeline import InferenceOptions as JaxOptions
from viewcrafter_tpu_torch.pipeline import InferenceOptions, ViewCrafterPipeline

FIXTURE = dict(model="viewcrafter_tiny", dust3r_model="dust3r_tiny", ddim_steps=2,
               video_length=4, dust3r_size=64, niter=5, batch_size=2, d_theta=[5.0],
               d_phi=[10.0], d_r=[-0.1], weights_dtype="fp32")
TRAJ = "0 15 30\n0 2 4\n0 0 0\n"


def _make_image(path):
    from PIL import Image

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 255, size=(96, 128, 3), dtype=np.uint8)
    arr[30:60, 40:90] = [200, 50, 50]
    Image.fromarray(arr).save(path)


def _run_jax(p):
    """Run the JAX pipeline; returns (video, scene, guidance frames, the
    diffusion key)."""
    key = jax.random.split(p.rng)[1]  # the key run_diffusion splits off
    frames = []
    upscale = p._upscale_to_target

    def capture(f):
        frames.append(upscale(f))
        return frames[-1]

    p._upscale_to_target = capture
    try:
        video = p.run()
    finally:
        del p._upscale_to_target
    return video, p.scene, frames[0], key


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vc_torch")
    img = str(tmp / "scene.png")
    _make_image(img)
    traj = tmp / "traj.txt"
    traj.write_text(TRAJ)
    common = dict(image_dir=img, exp_name="t", traj_txt=str(traj), **FIXTURE)
    jp, tpipe = tp.pipelines_f32(
        JaxOptions(out_dir=str(tmp / "jax"), mode="single_view_target", **common),
        InferenceOptions(out_dir=str(tmp / "torch"), mode="single_view_target", **common))
    return jp, tpipe, {}


def _runs(pipelines, mode):
    """(JAX result, port result) of `mode`, each computed once per module."""
    jp, tpipe, cache = pipelines
    if mode not in cache:
        jp.opts.mode = tpipe.opts.mode = mode
        jvideo, jscene, jframes, key = _run_jax(jp)
        cfg = tpipe.model_cfg
        noise = tp.jax_noise(key, (1,) + jframes.shape, jp.opts.ddim_steps, cfg.vae.z_channels,
                             cfg.vae.downsample_factor)
        tvideo = tpipe.run(noise=noise)
        cache[mode] = ((np.asarray(jvideo), jscene, np.asarray(jframes)),
                       (tvideo, tpipe.scene, tpipe.guidance_frames))
    return cache[mode]


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("mode", ["single_view_target", "single_view_txt"])
def test_pipeline_matches_jax(pipelines, mode):
    (jvideo, jscene, jframes), (tvideo, tscene, tframes) = _runs(pipelines, mode)
    for name in ("depths", "poses", "focals"):
        err = _rel(getattr(tscene, name), getattr(jscene, name))
        assert err <= 2e-2, (name, err)
    assert tframes.shape == jframes.shape == (4, 32, 64, 3)
    close = np.all(np.abs(tframes - jframes) <= 2e-2, axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert tvideo.shape == jvideo.shape == (4, 32, 64, 3)
    assert np.isfinite(tvideo).all()
    err = np.abs(tvideo - jvideo)
    assert err.max() <= 5e-2 and err.mean() <= 5e-3, (err.max(), err.mean())


def test_pipeline_writes_the_artifacts(pipelines):
    _runs(pipelines, "single_view_txt")
    save = pipelines[1].opts.save_dir
    names = os.listdir(save)
    for stem in ("render0.mp4", "diffusion0.mp4", "viz_traj.mp4"):
        assert any(n.startswith(stem) for n in names), (stem, names)
    for name in ("pcd0.ply", "scene0.ply"):
        assert name in names
    with open(os.path.join(save, "pcd0.ply")) as f:
        assert f.readline() == "ply\n"


def test_pipeline_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opts = InferenceOptions(**FIXTURE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViewCrafterPipeline(opts, init_models=False)


def test_existing_checkpoint_and_mesh_raise(tmp_path):
    # an existing checkpoint path is loaded (tests/test_torch_checkpoint.py):
    # an empty file is no checkpoint
    ckpt = tmp_path / "model.ckpt"
    ckpt.write_bytes(b"")
    with pytest.raises(EOFError):
        ViewCrafterPipeline(InferenceOptions(ckpt_path=str(ckpt), **FIXTURE), device="cpu")
    # multi-device sampling needs a process group of mesh_devices ranks
    # (tests/test_torch_parallel.py runs one)
    with pytest.raises(RuntimeError, match="torchrun"):
        ViewCrafterPipeline(InferenceOptions(mesh_devices=2, **FIXTURE), device="cpu")


def test_cli_parses_into_the_ports_options():
    from viewcrafter_tpu_torch import cli

    args = cli.get_parser().parse_args(
        ["--mode", "single_view_target", "--image_dir", "test/images/fruit.png",
         "--device", "cpu", "--d_phi", "20", "--ddim_steps", "3", "--niter", "7"])
    opts = cli.opts_from_args(args)
    assert isinstance(opts, InferenceOptions)
    assert args.device == "cpu"
    assert (opts.mode, list(opts.d_phi), opts.ddim_steps, opts.niter) == (
        "single_view_target", [20.0], 3, 7)
    assert cli.get_parser().parse_args([]).device is None


def test_bf16_weight_storage_rounds_every_weight():
    """weights_dtype="bf16" (the default): every weight holds a bf16 value,
    the float32 ones (norms, the DPT heads) included, as the JAX package
    stores them; "fp32" keeps float32 values."""
    def bf16_valued(p):
        return torch.equal(p, p.to(torch.bfloat16).to(p.dtype))

    def params(pipe):
        return [*pipe.dust3r.parameters(), *pipe.engine.unet.parameters(),
                *pipe.engine.vae.parameters()]

    rounded = ViewCrafterPipeline(InferenceOptions(**dict(FIXTURE, weights_dtype="bf16")),
                                  device="cpu")
    assert all(bf16_valued(p) for p in params(rounded))
    assert any(p.dtype == torch.float32 for p in params(rounded))
    kept = ViewCrafterPipeline(InferenceOptions(**FIXTURE), device="cpu")
    assert not all(bf16_valued(p) for p in params(kept) if p.dtype == torch.float32)
