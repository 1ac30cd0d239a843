"""The port's hand-written CUDA kernels on the card (marker `cuda`).

Each kernel against its plain torch twin on the same bf16 inputs, at small
and ragged shapes (rows not a multiple of the 192-row tile, widths not a
multiple of the 160-column tile, T = 1 and 2 for the temporal conv's zero
padding, Sk not a multiple of the 128-key tile, Sq != Sk, a cross-attention
stream of more than 256 keys, T from 1 to 32 and pixels not a multiple of
the 4-pixel tile in the temporal layer), near one-hot softmax rows, reruns
that must give the same bits, and the model wiring: a small config whose
every gate takes the kernels, card against CPU. Skipped without a
CUDA device. This file imports no JAX, so it runs on a machine without it:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: both sides round at the same points; a different f32 summation
order may flip a bf16 rounding (2^-8 of the value), so the largest error may
be 4 * 2^-8 of the largest output, and the error's RMS 2^-7 of the output's
RMS (rounding flips alone stay near 2^-9; a systematic error of 1% does not).
GroupNorm on float32 input rounds nowhere: kernel and twin differ by the order
of their f32 sums and by the kernel's fast exp in the SiLU, so the largest
error may be 2^-14 of the largest output and the error's RMS 2^-16 of the
output's RMS.
"""

import pytest
import torch

from viewcrafter_tpu_torch.ops.kernels import (
    cross_attention,
    ff_layer,
    fullkv_attention,
    groupnorm,
    spatial_layer,
    temporal_attention,
    temporal_conv,
    temporal_layer,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _assert_close(got, ref, max_rel=4 * 2.0 ** -8, rms_tol=2.0 ** -7):
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    diff, ref = got.float() - ref.float(), ref.float()
    err, tol = diff.abs().max().item(), max_rel * ref.abs().max().item()
    rms_rel = (diff.square().mean().sqrt() / ref.square().mean().sqrt()).item()
    assert err <= tol and rms_rel <= rms_tol, (err, tol, rms_rel)


@pytest.mark.parametrize("shape", [
    (1, 5, 24, 64, 64), (2, 25, 40, 320, 320), (1, 3, 8, 64, 128), (1, 1, 64, 64, 64),
    (2, 2, 144, 72, 160), (2, 1, 576, 128, 72), (2, 25, 576, 320, 640), (2, 25, 144, 1280, 1280)])
def test_temporal_conv3_kernel(gen, shape):
    """T = 1 and 2 (every tap row past a frame edge reads the map's zero
    fill, a negative row coordinate at the first frame), S = 64, 144 and
    576 (tiles that cross frame boundaries), Cin != Cout, Cin = 72 (a
    ragged second k panel), Cout = 72 (a ragged column block)."""
    b, t, s, cin, cout = shape
    x = _randn(gen, b, t, s, cin)
    w = _randn(gen, cout, 3 * cin, scale=(3 * cin) ** -0.5)
    bias = _randn(gen, cout, scale=0.1, dtype=torch.float32)
    n0 = temporal_conv.launches
    got = temporal_conv.temporal_conv3(x, w, bias)
    assert temporal_conv.launches == n0 + 1
    _assert_close(got, temporal_conv.temporal_conv3_plain(x, w, bias))
    assert torch.equal(got, temporal_conv.temporal_conv3(x, w, bias))  # a rerun: the same bits


@pytest.mark.parametrize("n,c", [(200, 64), (1000, 320), (136, 1280), (4100, 64), (7200, 1280),
                                 (28801, 320)])
def test_ff_layer_kernel(gen, n, c):
    """N not a multiple of the 192-row tile; C = 64 (an 80-column h/gate
    block past I = 256 and a 160-column output block past C_out = 64)."""
    i = 4 * c
    args = (_randn(gen, n, c), 1 + _randn(gen, c, scale=0.1, dtype=torch.float32),
            _randn(gen, c, scale=0.1, dtype=torch.float32),
            _randn(gen, 2 * i, c, scale=c ** -0.5), _randn(gen, 2 * i, scale=0.1),
            _randn(gen, c, i, scale=i ** -0.5), _randn(gen, c, scale=0.1))
    n0 = ff_layer.launches
    got = ff_layer.fused_ff_layer(*args)
    assert ff_layer.launches == n0 + 1
    _assert_close(got, ff_layer.fused_ff_layer_plain(*args))
    assert torch.equal(got, ff_layer.fused_ff_layer(*args))  # a rerun: the same bits


@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 256, 256, 2, 64), (1, 100, 77, 3, 64),
                                         (2, 130, 333, 2, 128), (1, 576, 576, 4, 64),
                                         (2, 200, 333, 2, 64), (1, 256, 130, 2, 128),
                                         (50, 144, 256, 20, 64), (2, 576, 576, 16, 64),
                                         (2, 576, 576, 12, 64)])
def test_fullkv_attention_kernel(gen, b, sq, sk, h, d):
    q, k, v = _randn(gen, b, sq, h, d), _randn(gen, b, sk, h, d), _randn(gen, b, sk, h, d)
    _assert_close(fullkv_attention.fullkv_attention(q, k, v),
                  fullkv_attention.fullkv_attention_plain(q, k, v))


@pytest.mark.parametrize("b,t,s,h,d,w_mul", [
    (1, 5, 24, 2, 64, 1.0), (2, 25, 36, 5, 64, 1.0), (1, 8, 16, 2, 128, 1.0), (1, 32, 8, 1, 64, 1.0),
    (2, 1, 13, 2, 64, 1.0), (1, 2, 150, 3, 64, 1.0), (2, 25, 150, 20, 64, 1.0),
    (2, 32, 13, 2, 128, 1.0), (2, 25, 144, 20, 64, 1.0), (2, 25, 36, 5, 64, 4.0)])
def test_temporal_layer_kernel(gen, b, t, s, h, d, w_mul):
    """T = 1 (one key), 2, 25 and 32 (the padded 32-frame tile exactly
    full); S = 13 and 150 (a ragged last 4-pixel tile); C = 1280 with 20
    heads; D = 128 at B = 2; Wqkv scaled by 4 (near one-hot rows: the
    masked padded frames and the rounding of the probabilities decide)."""
    c = h * d
    args = (_randn(gen, b, t, s, c), 1 + _randn(gen, c, scale=0.1, dtype=torch.float32),
            _randn(gen, c, scale=0.1, dtype=torch.float32),
            _randn(gen, 3 * c, c, scale=w_mul * c ** -0.5),
            _randn(gen, c, c, scale=c ** -0.5), _randn(gen, c, scale=0.1))
    n0 = temporal_layer.launches
    got = temporal_layer.fused_temporal_layer(*args, heads=h, dim_head=d)
    assert temporal_layer.launches == n0 + 1
    _assert_close(got, temporal_layer.fused_temporal_layer_plain(*args, heads=h, dim_head=d))
    # a rerun: the same bits
    assert torch.equal(got, temporal_layer.fused_temporal_layer(*args, heads=h, dim_head=d))


@pytest.mark.parametrize("n,s,c,dtype,silu,eps", [
    (2, 100, 64, torch.bfloat16, True, 1e-5), (3, 50, 320, torch.float32, False, 1e-6),
    (1, 7, 32, torch.float32, True, 1e-5), (2, 230400, 320, torch.bfloat16, False, 1e-6),
    (50, 9216, 320, torch.bfloat16, True, 1e-5), (1, 589824, 128, torch.bfloat16, True, 1e-6),
    (50, 144, 2560, torch.bfloat16, True, 1e-5), (2, 3600, 1280, torch.bfloat16, True, 1e-5),
    (4, 144, 2560, torch.float32, True, 1e-6), (1, 64, 3840, torch.float32, False, 1e-5)])
def test_group_norm_kernel(gen, n, s, c, dtype, silu, eps):
    """One launch of a cooperative grid: activations that the blocks' shared
    memory holds whole ((2, 3600, 1280), 18 MB, read once) and ones it does
    not ((2, 230400, 320), 295 MB: the rest re-read); N = 50 at S = 144;
    float32 at C = 2560 and at the widest C, 3840."""
    x = _randn(gen, n, s, c, scale=2.0, dtype=dtype) + 0.5
    w = 1 + _randn(gen, c, scale=0.1, dtype=torch.float32)
    b = _randn(gen, c, scale=0.1, dtype=torch.float32)
    n0 = groupnorm.launches
    got = groupnorm.group_norm_fused(x, w, b, 32, eps, silu)
    assert groupnorm.launches == n0 + 1
    ref = groupnorm.group_norm_fused_plain(x, w, b, 32, eps, silu)
    if dtype == torch.float32:
        _assert_close(got, ref, max_rel=2.0 ** -14, rms_tol=2.0 ** -16)
    else:
        _assert_close(got, ref)
    again = groupnorm.group_norm_fused(x, w, b, 32, eps, silu)
    assert torch.equal(got, again)  # no float atomics: a rerun gives the same bits


@pytest.mark.parametrize("b,sq,h,d,lt,li", [(1, 200, 2, 64, 77, 16), (2, 128, 1, 128, 77, 16),
                                            (1, 300, 3, 64, 5, 1), (2, 640, 2, 64, 256, 256),
                                            (50, 9216, 5, 64, 77, 256), (2, 300, 2, 128, 77, 256),
                                            (1, 200, 2, 64, 77, 300), (1, 130, 2, 128, 1, 351)])
def test_dual_cross_attention_kernel(gen, b, sq, h, d, lt, li):
    q = _randn(gen, b, sq, h, d)
    kt, vt = _randn(gen, b, lt, h, d), _randn(gen, b, lt, h, d)
    ki, vi = _randn(gen, b, li, h, d), _randn(gen, b, li, h, d)
    n0 = cross_attention.launches
    got = cross_attention.dual_cross_attention(q, kt, vt, ki, vi)
    assert cross_attention.launches == n0 + 1
    _assert_close(got, cross_attention.dual_cross_attention_plain(q, kt, vt, ki, vi))


@pytest.mark.parametrize("d", [64, 128])
def test_attention_kernels_peaky_softmax(gen, d):
    """q scaled by 8: near one-hot rows, so the running-max rescale of
    fullkv and the masking of padded keys in both kernels decide the result
    (Sk and both streams are no multiple of a key tile)."""
    q = _randn(gen, 2, 200, 2, d, scale=8.0)
    k, v = _randn(gen, 2, 333, 2, d), _randn(gen, 2, 333, 2, d)
    _assert_close(fullkv_attention.fullkv_attention(q, k, v),
                  fullkv_attention.fullkv_attention_plain(q, k, v))
    kt, vt = _randn(gen, 2, 77, 2, d), _randn(gen, 2, 77, 2, d)
    ki, vi = _randn(gen, 2, 200, 2, d), _randn(gen, 2, 200, 2, d)
    _assert_close(cross_attention.dual_cross_attention(q, kt, vt, ki, vi),
                  cross_attention.dual_cross_attention_plain(q, kt, vt, ki, vi))


def test_attention_kernels_rerun_same_bits(gen):
    """No atomics and a fixed order of sums: a rerun gives the same bits."""
    q, k, v = _randn(gen, 4, 600, 5, 64), _randn(gen, 4, 600, 5, 64), _randn(gen, 4, 600, 5, 64)
    assert torch.equal(fullkv_attention.fullkv_attention(q, k, v),
                       fullkv_attention.fullkv_attention(q, k, v))
    kt, vt = _randn(gen, 4, 77, 5, 64), _randn(gen, 4, 77, 5, 64)
    ki, vi = _randn(gen, 4, 256, 5, 64), _randn(gen, 4, 256, 5, 64)
    assert torch.equal(cross_attention.dual_cross_attention(q, kt, vt, ki, vi),
                       cross_attention.dual_cross_attention(q, kt, vt, ki, vi))


@pytest.mark.parametrize("b,t,s,h,d", [(1, 40, 24, 2, 64), (2, 64, 8, 1, 128), (1, 7, 16, 2, 64),
                                       (1, 33, 5, 1, 64), (2, 40, 2560, 5, 64)])
def test_temporal_attention_kernel(gen, b, t, s, h, d):
    q, k, v = (_randn(gen, b, t, s, h, d) for _ in range(3))
    n0 = temporal_attention.launches
    got = temporal_attention.temporal_attention_fused(q, k, v)
    assert temporal_attention.launches == n0 + 1
    _assert_close(got, temporal_attention.temporal_attention_fused_plain(q, k, v))


@pytest.mark.parametrize("b,s,h,d", [(2, 200, 2, 64), (1, 64, 1, 128), (4, 2304, 10, 64),
                                     (50, 576, 20, 64)])
def test_spatial_layer_kernel(gen, b, s, h, d):
    c = h * d
    args = (_randn(gen, b, s, c, scale=0.5), 1 + _randn(gen, c, scale=0.1, dtype=torch.float32),
            _randn(gen, c, scale=0.1, dtype=torch.float32), _randn(gen, 3 * c, c, scale=c ** -0.5),
            _randn(gen, c, c, scale=c ** -0.5), _randn(gen, c, scale=0.1))
    n0 = spatial_layer.launches
    got = spatial_layer.fused_spatial_layer(*args, heads=h, dim_head=d)
    assert spatial_layer.launches == n0 + 1
    _assert_close(got, spatial_layer.fused_spatial_layer_plain(*args, heads=h, dim_head=d))


def test_wrappers_refuse_float32_on_the_card(gen):
    x = torch.zeros((1, 3, 8, 64), device="cuda")
    with pytest.raises(ValueError):
        temporal_conv.temporal_conv3(x, torch.zeros((64, 192), device="cuda"),
                                     torch.zeros(64, device="cuda"))


def test_generate_wiring_matches_cpu(gen):
    """`generate` on a small config whose every gate takes the kernels,
    card against CPU (the same check as chip_smoke.py's wiring phase)."""
    from chip_smoke import MAIN_KERNELS, run_wiring

    res, _ = run_wiring(gen)
    assert all(res["launches"][k] > 0 for k in MAIN_KERNELS)


@pytest.mark.parametrize("frames", [8, 40])
def test_generate_wiring_with_routes_matches_cpu(gen, frames):
    """The same with both routes on, and at 40 frames, where the temporal
    attentions leave the layer kernel for `temporal_attention_fused`."""
    from chip_smoke import run_wiring

    res, _ = run_wiring(gen, routes=True, frames=frames)
    assert res["launches"]["group_norm_fused"] > 0
    assert res["launches"]["dual_cross_attention"] > 0
    assert (res["launches"]["temporal_attention_fused"] > 0) == (frames > 32)


def test_geometry_wiring_matches_cpu(gen):
    """A small DUSt3R whose every attention takes the fullkv kernel, card
    against CPU, then aligner steps on both (chip_smoke.py's geometry_wiring
    phase)."""
    from chip_smoke import run_geometry_wiring

    res, sites = run_geometry_wiring(gen)
    assert res["launches"]["fullkv_attention"] > 0
    assert all(s[1] == 256 and s[4] == 64 for s in sites["fullkv_attention"])


@pytest.mark.parametrize("z_order", ["exact", "packed"])
def test_render_trajectory_on_the_card_matches_cpu(gen, z_order):
    """The rasterizer's sorts, searches and scatters on the card: the same
    frames as on the CPU (a projection rounded otherwise may move a point
    across a pixel border, which changes that pixel alone)."""
    from viewcrafter_tpu_torch.ops.rasterize import render_trajectory

    pts = torch.randn((150000, 3), generator=gen, device="cuda") + torch.tensor(
        [0.0, 0.0, 4.0], device="cuda")
    cols = torch.rand((150000, 3), generator=gen, device="cuda")
    w2c = torch.eye(4, device="cuda").repeat(2, 1, 1)
    w2c[1, 0, 3] = 0.1
    K = torch.tensor([[300.0, 0, 256], [0, 300.0, 144], [0, 0, 1]], device="cuda")
    got = render_trajectory(pts, cols, w2c, K, 288, 512, z_order=z_order).cpu()
    ref = render_trajectory(pts.cpu(), cols.cpu(), w2c.cpu(), K.cpu(), 288, 512, z_order=z_order)
    close = ((got - ref).abs() <= 1e-5).all(-1).float().mean().item()
    assert (ref > 0).any(-1).float().mean().item() > 0.5
    assert close >= 0.999, close


def test_resize_downsample_on_the_card_matches_cpu(gen):
    """The antialiased downsample of the iterative modes (a generated frame
    to DUSt3R's size, and a shrink of one axis with a growth of the other)
    on the card against the CPU."""
    from viewcrafter_tpu_torch.ops.resize import resize_bilinear

    for shape, out in (((1, 576, 1024, 3), (288, 512)), ((2, 40, 96, 3), (64, 20))):
        x = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
        got = resize_bilinear(x, *out).cpu()
        ref = resize_bilinear(x.cpu(), *out)
        assert got.shape == ref.shape and (got - ref).abs().max().item() <= 1e-5


def test_sequential_cfg_with_attention_reuse_matches_cpu(gen):
    """Sequential CFG under the attention cache (one UNet call per branch,
    each with its own cache: one full and one reuse step) on a small config
    whose every gate takes the kernels, card against CPU."""
    from chip_smoke import MAIN_KERNELS, run_wiring
    from viewcrafter_tpu_torch.sampling.ddim import GuidanceConfig

    for guidance in (GuidanceConfig(sequential=True), GuidanceConfig(cfg_img=1.5, sequential=True)):
        res, _ = run_wiring(gen, guidance=guidance, attn_reuse_interval=2)
        assert all(res["launches"][k] > 0 for k in MAIN_KERNELS)


def test_sparse_view_interp_on_the_card_matches_cpu(gen, tmp_path):
    """`ViewCrafterPipeline.run()` in sparse_view_interp on the tiny presets,
    bf16 on the card (the kernel wrappers take bf16 only) against float32 and
    bf16 on the CPU, each stage from common inputs as in
    `tests/test_torch_modes.py`: the CPU's DUSt3R pass continues from the
    card's scene and its diffusion calls run on the card's guidance frames
    with the card's draws. The yardstick is the CPU bf16 run's own distance
    from its float32 run (as chip_smoke.py's wiring phase): the scene within
    twice that plus 2e-2 (relative), each segment's video within twice that
    plus 1e-2 at most and 1e-3 on average; 99% of the guidance pixels within
    2e-2 (the render is float32 on both)."""
    import numpy as np

    from chip_smoke import shifted_views
    from viewcrafter_tpu_torch.models.lvdm import SUBMODELS
    from viewcrafter_tpu_torch.pipeline import InferenceOptions, ViewCrafterPipeline

    def pipeline(device, dtype):
        opts = InferenceOptions(mode="sparse_view_interp", model="viewcrafter_tiny",
                                dust3r_model="dust3r_tiny", ddim_steps=2, video_length=7,
                                dust3r_size=64, niter=5, batch_size=2,
                                out_dir=str(tmp_path / f"{device}_{dtype}"), exp_name="s")
        return ViewCrafterPipeline(opts, device=device, dtype=dtype)

    views = shifted_views(3, 4, 32, 64)
    card = pipeline("cuda", torch.bfloat16)
    rec = {"scenes": [], "frames": [], "noise": [], "videos": []}
    align, diffuse = card.run_dust3r, card.run_diffusion

    def card_dust3r(images, clean_pc=False):
        rec["scenes"].append(align(images, clean_pc))
        return rec["scenes"][-1]

    def card_diffusion(frames01, cond_idx=0, noise=None):
        noise = card.engine.draw_noise((1,) + frames01.shape, 2, card.generator)
        rec["frames"].append(frames01)
        rec["noise"].append(type(noise)(*(t.cpu() for t in (noise.x_T, noise.steps,
                                                             noise.posterior))))
        rec["videos"].append(diffuse(frames01, cond_idx, noise))
        return rec["videos"][-1]

    card.run_dust3r, card.run_diffusion = card_dust3r, card_diffusion
    card.run(images=views)

    def follow(dtype):
        """A CPU pipeline with the card's weights, continuing from the card's
        stages; returns its own scenes, frames and videos."""
        cpu = pipeline("cpu", dtype)
        cpu.load_params({k: v.cpu() for k, v in card.dust3r.state_dict().items()},
                        {n: {k: v.cpu() for k, v in getattr(card.engine, n).state_dict().items()}
                         for n in SUBMODELS})
        own = {"scenes": [], "frames": [], "videos": []}
        c_align, c_diffuse = cpu.run_dust3r, cpu.run_diffusion
        scenes, frames, noise, videos = (iter(rec[k]) for k in ("scenes", "frames", "noise",
                                                                   "videos"))

        def cpu_dust3r(images, clean_pc=False):
            own["scenes"].append(c_align(images, clean_pc))
            cpu.scene = next(scenes)
            return cpu.scene

        def cpu_diffusion(frames01, cond_idx=0, _noise=None):
            own["frames"].append(frames01)
            own["videos"].append(c_diffuse(next(frames), cond_idx, next(noise)))
            return next(videos)

        cpu.run_dust3r, cpu.run_diffusion = cpu_dust3r, cpu_diffusion
        cpu.run(images=views)
        return own

    f32, bf16 = follow(torch.float32), follow(torch.bfloat16)

    def rel(a, b):
        return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())

    assert len(f32["videos"]) == len(rec["videos"]) == 2
    for cs, s32, s16 in zip(rec["scenes"], f32["scenes"], bf16["scenes"]):
        for name in ("depths", "poses", "focals"):
            a, b, c = (getattr(x, name) for x in (cs, s32, s16))
            assert rel(a, b) <= 2 * rel(c, b) + 2e-2, name
    for cf, tf in zip(rec["frames"], f32["frames"]):
        assert np.all(np.abs(tf - cf) <= 2e-2, axis=-1).mean() >= 0.99
    for cv, v32, v16 in zip(rec["videos"], f32["videos"], bf16["videos"]):
        err, yard = np.abs(cv - v32), np.abs(v16 - v32)
        assert np.isfinite(cv).all()
        assert err.max() <= 2 * yard.max() + 1e-2 and err.mean() <= 2 * yard.mean() + 1e-3
