"""Every mode beyond the single-view pair, port against JAX package:
`ViewCrafterPipeline.run()` in sparse_view_interp, single_view_eval,
single_view_ref_iterative, single_view_1drc_iterative and single_view_nbv,
on the JAX package's tiny fixture (`tests/test_pipeline.py`: dust3r_tiny,
viewcrafter_tiny, 64 px, niter 5, 2 DDIM steps) with float32 networks on
both sides (`torch_parity.pipelines_f32`, for the reason given in
`tests/test_torch_pipeline.py`). Clips are 7 frames long, not 4: the iterative modes
add every 6th generated frame to the views, so at 7 frames each pass adds
one (the nbv passes see 2, 3 and 4 views); at 4 frames they would add none.
`bg_trd` is 0.5 and `min_conf_thr` 7, so that `_conf_bg_masks` leaves
some pixels out.

Each stage is held from common inputs, and its own output compared with
the JAX package's apart: each DUSt3R pass records the port's scene and
hands on the JAX scene; each diffusion call gets the draws the JAX pipeline
makes for it (the key it splits off its pipeline key, rebuilt by
`torch_parity.jax_noise`), runs on the JAX call's guidance frames, records
the port's video and hands on the JAX video. Random weights amplify: DUSt3R
and a 5-step alignment of an ill-posed scene (most depths near zero) turn
float32 rounding into scenes 1e-3 apart in a later pass, which moves points
across pixel borders in 2% of a render's pixels; and a few guidance pixels
coloured otherwise move a random-weight video past its tolerance. Chained,
no fixed tolerance would hold.

Tolerances, as in `tests/test_torch_pipeline.py` (each error relative to the
largest magnitude of the JAX array): every DUSt3R pass's scene depths, poses
and focals within 2e-2; at least 99% of each call's guidance pixels within
2e-2 on every channel, and of each raw render's; each render draws some
pixels beyond frame 0 (in single_view_eval, in frame 0); each call's video within 5e-2 at most and 5e-3 on
average; `_conf_bg_masks` equal on at least 99.9% of pixels; nbv's chosen
candidates, the views, the elevation and the files written equal.
"""

import os
import zlib

import jax
import numpy as np
import pytest
from PIL import Image

import torch_parity as tp
from viewcrafter_tpu.pipeline import InferenceOptions as JaxOptions
from viewcrafter_tpu.utils import tokenizer as jax_tokenizer
from viewcrafter_tpu_torch.pipeline import InferenceOptions
from viewcrafter_tpu_torch.utils import tokenizer as port_tokenizer

FIXTURE = dict(model="viewcrafter_tiny", dust3r_model="dust3r_tiny", ddim_steps=2,
               video_length=7, dust3r_size=64, niter=5, batch_size=2, bg_trd=0.5,
               min_conf_thr=7.0, weights_dtype="fp32")
MODES = {
    "sparse_view_interp": {},
    "single_view_eval": {},
    "single_view_ref_iterative": dict(d_theta=[5.0, 8.0], d_phi=[10.0, 15.0], d_r=[-0.1, -0.1],
                                      d_x=[0.0, 0.0], d_y=[0.0, 0.0]),
    "single_view_1drc_iterative": dict(d_theta=[5.0, 6.0], d_phi=[10.0, 12.0],
                                       d_r=[-0.1, -0.1], d_x=[0.0, 0.0], d_y=[0.0, 0.0]),
    # the JAX package's nbv test angles: the candidates' coverage is far from a tie
    "single_view_nbv": dict(d_theta=[15.0], d_phi=[20.0], d_r=[-0.1]),
}
MULTI_VIEW = ("sparse_view_interp", "single_view_eval")


def _write_inputs(tmp):
    """One photo, and a folder of three views of one scene panned sideways."""
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 255, size=(96, 128, 3), dtype=np.uint8)
    arr[30:60, 40:90] = [200, 50, 50]
    photo = str(tmp / "scene.png")
    Image.fromarray(arr).save(photo)
    views = tmp / "views"
    views.mkdir()
    base = np.random.default_rng(3).integers(0, 255, size=(96, 128, 3), dtype=np.uint8)
    base[30:70, 30:80] = [60, 180, 60]
    for i in range(3):
        Image.fromarray(np.roll(base, shift=i * 5, axis=1)).save(views / f"{i}.png")
    return photo, str(views)


def _record(p, names, rec):
    """Wrap p's methods `names` so that each call's result lands in
    rec[name]; returns the originals."""
    orig = {n: getattr(p, n) for n in names}

    def wrap(n):
        def call(*a, **kw):
            out = orig[n](*a, **kw)
            rec[n].append(out)
            return out
        return call

    for n in names:
        setattr(p, n, wrap(n))
    return orig


def _run_jax(p):
    rec = {"run_dust3r": [], "_conf_bg_masks": [], "run_render": [], "keys": [], "frames": [],
           "videos": []}
    orig = _record(p, ("run_dust3r", "_conf_bg_masks", "run_render"), rec)
    diffuse = p.run_diffusion

    def run_diffusion(frames01, cond_idx=0):
        rec["keys"].append(jax.random.split(p.rng)[1])  # the key run_diffusion splits off
        rec["frames"].append(np.array(frames01))
        rec["videos"].append(np.asarray(diffuse(frames01, cond_idx)))
        return rec["videos"][-1]

    p.run_diffusion = run_diffusion
    p.elevation = p.opts.elevation  # as the port, from the option at every run
    try:
        p.run()
    finally:
        for n in (*orig, "run_diffusion"):
            delattr(p, n)
    return rec


def _run_port(p, jrec):
    """The port with the JAX pipeline's inputs at every stage: each DUSt3R
    pass records the port's scene and continues from the JAX scene; each
    diffusion call records the port's video, made with the JAX draws from
    the JAX call's guidance frames, and continues from the JAX video."""
    rec = {"run_dust3r": [], "_conf_bg_masks": [], "run_render": [], "frames": [], "videos": []}
    orig = _record(p, ("_conf_bg_masks", "run_render"), rec)
    align, diffuse = p.run_dust3r, p.run_diffusion
    jax_scenes, jax_frames, jax_videos = (iter(jrec[k]) for k in ("run_dust3r", "frames", "videos"))

    def run_dust3r(images, clean_pc=False):
        rec["run_dust3r"].append(align(images, clean_pc))
        p.scene = next(jax_scenes)
        return p.scene

    def run_diffusion(frames01, cond_idx=0, noise=None):
        rec["frames"].append(np.array(frames01))
        rec["videos"].append(diffuse(next(jax_frames), cond_idx, noise))
        return next(jax_videos)

    p.run_dust3r, p.run_diffusion = run_dust3r, run_diffusion
    cfg = p.model_cfg
    noise = [tp.jax_noise(key, (1,) + f.shape, p.opts.ddim_steps, cfg.vae.z_channels,
                          cfg.vae.downsample_factor) for key, f in zip(jrec["keys"], jrec["frames"])]
    try:
        p.run(noise=noise)
    finally:
        for n in (*orig, "run_dust3r", "run_diffusion"):
            delattr(p, n)
    return rec


def _fixed_fallback_ids(text: str) -> list:
    """The tokenizers' hash fallback with crc32 in place of Python's salted
    `hash`: the same prompt ids in every process. With the salted ids the
    modes' videos, and so the iterative modes' later scenes, change from one
    process to the next, and at some salts both packages' later renders are
    empty (random weights)."""
    return [1000 + zlib.crc32(w.encode()) % 48000 for w in text.lower().split()]


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vc_modes")
    photo, views = _write_inputs(tmp)
    jp, tpipe = tp.pipelines_f32(JaxOptions(out_dir=str(tmp / "jax"), image_dir=photo, **FIXTURE),
                                 InferenceOptions(out_dir=str(tmp / "torch"), image_dir=photo,
                                                  **FIXTURE))
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_tokenizer, port_tokenizer):
            mp.setattr(mod, "_fallback_ids", _fixed_fallback_ids)
        yield jp, tpipe, {"photo": photo, "views": views}


def _configure(p, mode, inputs):
    opts, defaults = p.opts, InferenceOptions()
    opts.mode, opts.exp_name = mode, mode
    opts.image_dir = inputs["views"] if mode in MULTI_VIEW else inputs["photo"]
    for k in ("d_theta", "d_phi", "d_r", "d_x", "d_y"):
        setattr(opts, k, list(MODES[mode].get(k, getattr(defaults, k))))


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_matches_jax(pipelines, mode):
    jp, tpipe, inputs = pipelines
    _configure(jp, mode, inputs)
    _configure(tpipe, mode, inputs)
    jrec = _run_jax(jp)
    trec = _run_port(tpipe, jrec)

    calls = {"sparse_view_interp": 2, "single_view_eval": 1, "single_view_nbv": 3}.get(mode, 2)
    assert len(trec["videos"]) == len(jrec["videos"]) == calls
    assert len(trec["run_dust3r"]) == len(jrec["run_dust3r"]) == (
        2 if mode == "single_view_eval" else (1 if mode in MULTI_VIEW else calls))
    for ts, js in zip(trec["run_dust3r"], jrec["run_dust3r"]):
        assert ts.depths.shape == js.depths.shape
        for name in ("depths", "poses", "focals"):
            err = _rel(getattr(ts, name), getattr(js, name))
            assert err <= 2e-2, (name, err)
    assert len(trec["_conf_bg_masks"]) == len(jrec["_conf_bg_masks"])
    for tm, jm in zip(trec["_conf_bg_masks"], jrec["_conf_bg_masks"]):
        assert tm.shape == jm.shape and (tm == jm).mean() >= 0.999
    renders = [[np.asarray(r[0]) for r in rec["run_render"]] for rec in (trec, jrec)]
    assert len(renders[0]) == len(renders[1]) >= 1
    for tr, jr in zip(*renders):
        assert tr.shape == jr.shape
        assert np.all(np.abs(tr - jr) <= 2e-2, axis=-1).mean() >= 0.99
    for tf, jf in zip(trec["frames"], jrec["frames"]):
        assert tf.shape == jf.shape
        if mode != "single_view_eval":  # the render draws beyond frame 0 (the input view)
            assert min((tf[1:] > 0).any(-1).mean(), (jf[1:] > 0).any(-1).mean()) > 0
        close = np.all(np.abs(tf - jf) <= 2e-2, axis=-1)
        assert close.mean() >= 0.99, close.mean()
    for tv, jv in zip(trec["videos"], jrec["videos"]):
        assert tv.shape == jv.shape and np.isfinite(tv).all()
        err = np.abs(tv - jv)
        assert err.max() <= 5e-2 and err.mean() <= 5e-3, (err.max(), err.mean())

    assert len(tpipe.images) == len(jp.images)
    for ti, ji in zip(tpipe.images, jp.images):  # the generated views, taken down to DUSt3R's size
        assert ti.img.shape == ji.img.shape and tp.max_err(ti.img, ji.img) <= 1e-5
        assert tp.max_err(ti.img_ori, ji.img_ori) <= 1e-6
    assert tpipe.elevation == pytest.approx(jp.elevation)
    written = [sorted(os.listdir(p.opts.save_dir)) for p in (tpipe, jp)]
    assert written[0] == written[1]
    if mode == "single_view_nbv":
        assert len(tpipe.images) == 4  # 2, 3 then 4 views
        picks = [n for n in written[0] if n.startswith("candidate_mask")]
        assert [n.split("_nbv")[0] for n in picks] == [f"candidate_mask{i}" for i in range(3)]
    if mode == "single_view_eval":
        # With random weights the clip's alignment turns the cameras beyond
        # 0 far from camera 0, so they see little of frame 0's cloud, and at
        # 32x64 a splat is 0.16 px wide (radius_ndc 0.01): the render may
        # draw nothing beyond frame 0 (PERF.md). Frame 0 of the render, the
        # identity camera where the clip's alignment and frame 0's own meet,
        # must draw the cloud.
        assert min((r[-1][0] > 0).any(-1).mean() for r in renders) > 0
    if mode == "sparse_view_interp":
        assert len(trec["frames"][0]) == 7 and trec["videos"][0].shape[0] == 7
        assert all(0 < m.mean() < 0.99 for m in trec["_conf_bg_masks"])


def test_noise_list_must_cover_every_call(pipelines):
    _, tpipe, inputs = pipelines
    _configure(tpipe, "single_view_ref_iterative", inputs)
    cfg = tpipe.model_cfg
    one = tp.jax_noise(jax.random.PRNGKey(0), (1, 7, cfg.height, cfg.width, 3),
                       tpipe.opts.ddim_steps, cfg.vae.z_channels, cfg.vae.downsample_factor)
    with pytest.raises(ValueError, match="fewer draws"):
        tpipe.run(noise=[one])


@pytest.mark.parametrize("mode", MULTI_VIEW)
def test_multi_view_modes_need_two_views(pipelines, mode):
    _, tpipe, inputs = pipelines
    _configure(tpipe, mode, inputs)
    tpipe.opts.image_dir = inputs["photo"]
    with pytest.raises(ValueError, match=">= 2 input views"):
        tpipe.run()
