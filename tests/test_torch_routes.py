"""The port's kernel routes against the JAX package, on the CPU.

Four kernel modules (`group_norm_fused`, `dual_cross_attention`,
`temporal_attention_fused`, `fused_spatial_layer`): on the CPU each port
wrapper runs its plain twin; the JAX side runs the Pallas kernel in interpret
mode, as the JAX package's own tests do. The same numpy inputs go to both.
Then `UNet3D` with the routes on against the JAX package's default route.

Tolerances. float32 inputs: both sides compute in f32 and differ by the
order of their sums only (an exp of logits of order 10 and GroupNorm's
E[x^2] - mean^2 amplify that by an order of magnitude): atol 1e-4 on outputs
of order 1, the observed gap being up to 4e-5. bfloat16
inputs: both sides round at the same points, so they differ by a few bf16
ulps of values of order 1 where another summation order lands on the other
side of a rounding boundary: atol 3e-2. The UNet with the routes on computes
the same function as the default route, so it is held to the tolerances of
`test_torch_modules.py`: 1e-4 in f32, and in bf16 twice the JAX package's
own bf16-vs-f32 distance plus 1e-2.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from viewcrafter_tpu.ops.pallas import cross_attention as jca
from viewcrafter_tpu.ops.pallas import groupnorm as jgn
from viewcrafter_tpu.ops.pallas import spatial_layer as jsl
from viewcrafter_tpu.ops.pallas import temporal_attention as jta
from viewcrafter_tpu_torch.config import get_model_config
from viewcrafter_tpu_torch.convert import from_jax_params
from viewcrafter_tpu_torch.models import layers as tlayers
from viewcrafter_tpu_torch.models.lvdm import SUBMODELS, VideoDiffusionEngine
from viewcrafter_tpu_torch.models.unet3d import CrossAttention, UNet3D
from viewcrafter_tpu_torch.models.vae import AutoencoderKL
from viewcrafter_tpu_torch.ops.kernels import cross_attention as tca
from viewcrafter_tpu_torch.ops.kernels import groupnorm as tgn
from viewcrafter_tpu_torch.ops.kernels import spatial_layer as tsl
from viewcrafter_tpu_torch.ops.kernels import temporal_attention as tta
from viewcrafter_tpu_torch.utils import profiling

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _both(a: np.ndarray, jdt, tdt):
    """The same numbers as a JAX array and a torch tensor of one dtype."""
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _close(got: torch.Tensor, ref, atol: float):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=atol, rtol=0)


# -- the four kernels ---------------------------------------------------------


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n,s,c,silu,eps", [
    (2, 48, 64, True, 1e-5), (1, 40, 128, False, 1e-6), (3, 16, 320, True, 1e-5)])
def test_group_norm_fused_matches_pallas(dt, n, s, c, silu, eps):
    """N = 1 and C = 320 (ten channels per group) included; every shape
    passes the TPU tile rule, so the Pallas kernel itself is the reference."""
    jdt, tdt, atol = DTYPES[dt]
    assert jgn._pick_tile(s, c) is not None
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, s, c)) * 2 + 0.5
    w, b = 1 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c)
    (xj, xt) = _both(x, jdt, tdt)
    (wj, wt), (bj, bt) = _both(w, jnp.float32, torch.float32), _both(b, jnp.float32, torch.float32)
    ref = jgn.group_norm_fused(xj, wj, bj, num_groups=32, eps=eps, with_silu=silu, interpret=True)
    got = tgn.group_norm_fused(xt, wt, bt, num_groups=32, eps=eps, with_silu=silu)
    assert got.dtype == tdt
    _close(got, ref, atol)


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_fused_large_mean_matches_default_path(silu):
    """A group whose mean is large against its spread (x = 100 + N(0, 1)):
    the twin against the JAX package's default path, which takes the mean of
    squared deviations (the Pallas kernel is no reference here: it takes
    E[x^2] - mean^2, 6.3e-3 away in f32). f32, the file's tolerance."""
    rng = np.random.default_rng(4)
    x = 100 + rng.standard_normal((2, 64, 320))
    w, b = 1 + 0.1 * rng.standard_normal(320), 0.1 * rng.standard_normal(320)
    f32 = (jnp.float32, torch.float32)
    (xj, xt), (wj, wt), (bj, bt) = _both(x, *f32), _both(w, *f32), _both(b, *f32)
    ref = jgn.group_norm_silu(xj, wj, bj, num_groups=32, eps=1e-5, with_silu=silu)
    got = tgn.group_norm_fused(xt, wt, bt, num_groups=32, eps=1e-5, with_silu=silu)
    _close(got, ref, DTYPES["f32"][2])


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("li", [16, 256])
def test_dual_cross_attention_matches_pallas(dt, li):
    jdt, tdt, atol = DTYPES[dt]
    b, s, h, d, lt = 2, 128, 2, 64, 77
    rng = np.random.default_rng(1)
    pairs = [_both(rng.standard_normal(shape), jdt, tdt)
             for shape in ((b, s, h, d), (b, lt, h, d), (b, lt, h, d), (b, li, h, d), (b, li, h, d))]
    assert tca.supports_dual((b, s, h, d), lt, li)
    ref = jca.dual_cross_attention(*(p[0] for p in pairs), interpret=True)
    _close(tca.dual_cross_attention(*(p[1] for p in pairs)), ref, atol)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", [(1, 40, 16, 2, 64), (2, 7, 32, 1, 64)])
def test_temporal_attention_fused_matches_pallas(dt, shape):
    """T = 40 is the long clip's: past the layer kernel's 32, within 64."""
    jdt, tdt, atol = DTYPES[dt]
    rng = np.random.default_rng(2)
    (qj, qt), (kj, kt), (vj, vt) = (_both(rng.standard_normal(shape), jdt, tdt) for _ in range(3))
    assert tta.supports_fused(shape)
    ref = jta.temporal_attention_fused(qj, kj, vj, interpret=True)
    _close(tta.temporal_attention_fused(qt, kt, vt), ref, atol)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,s,heads,d", [(2, 64, 2, 64), (1, 32, 1, 128)])
def test_fused_spatial_layer_matches_pallas(dt, b, s, heads, d):
    jdt, tdt, atol = DTYPES[dt]
    c = heads * d
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, c)) * 0.5
    lns, lnb = 1 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c)
    wqkv = rng.standard_normal((c, 3 * c)) * c ** -0.5
    wo = rng.standard_normal((c, c)) * c ** -0.5
    bo = 0.1 * rng.standard_normal(c)
    f32 = (jnp.float32, torch.float32)
    (xj, xt) = _both(x, jdt, tdt)
    (sj, st), (lj, lt), (bj, bt) = _both(lns, *f32), _both(lnb, *f32), _both(bo, *f32)
    (wj, wt), (oj, ot) = _both(wqkv, jdt, tdt), _both(wo, jdt, tdt)
    ref = jsl.fused_spatial_layer(xj, sj, lj, wj, oj, bj, heads=heads, dim_head=d, interpret=True)
    got = tsl.fused_spatial_layer(xt, st, lt, wt.t(), ot.t(), bt, heads=heads, dim_head=d)
    _close(got, ref, atol)


GATE_SHAPES = [  # (B*T, S, H, D, T): flagship ds1/ds2/ds4/ds8, long clip, small
    (50, 9216, 5, 64, 25), (50, 2304, 10, 64, 25), (50, 576, 20, 64, 25), (50, 144, 20, 64, 25),
    (80, 2560, 5, 64, 40), (80, 40, 20, 64, 40), (8, 256, 1, 64, 8), (4, 32, 2, 16, 4),
    (2, 100, 2, 128, 70),
]


@pytest.mark.parametrize("bt,s,h,d,t", GATE_SHAPES)
def test_route_gates_match_jax(bt, s, h, d, t):
    for lt, li in ((77, 16), (77, 256), (77, 0), (300, 300)):
        assert (tca.supports_dual((bt, s, h, d), lt, li)
                == jca.supports_dual((bt, s, h, d), lt, li))
    q5 = (bt // t or 1, t, s, h, d)
    assert tta.supports_fused(q5) == jta.supports_fused(q5)
    x3 = (bt, s, h * d)
    assert (tsl.supports_fused_spatial(x3, h, d) == jsl.supports_fused_spatial(x3, h, d))


def test_group_norm_gate_is_wider_than_the_tpu_rule():
    """The TPU rule (C % 128 == 0 and an S tile) is a lane and VMEM rule; the
    port's gate asks only for whole groups and 16-byte rows."""
    for c in (320, 960):
        assert c % 128 != 0 and tgn.supports_group_norm((50, 9216, c), 32, 2)
    assert tgn.supports_group_norm((1, 589824, 128), 32, 2)
    assert tgn.supports_group_norm((2, 16, 36), 4, 4) and not tgn.supports_group_norm((2, 16, 36), 4, 2)
    assert not tgn.supports_group_norm((2, 16, 48), 32, 2)
    assert not tgn.supports_group_norm((2, 16, 64, 64), 32, 2)


# -- the routes in the modules ------------------------------------------------


def test_group_norm_module_takes_the_route_only_when_on(monkeypatch):
    calls = []
    real = tgn.group_norm_fused
    monkeypatch.setattr(tgn, "group_norm_fused", lambda *a, **k: calls.append(1) or real(*a, **k))
    gn = tlayers.GroupNorm32(64, with_silu=True)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 3, 5, 64)).astype(np.float32))
    with torch.no_grad():
        off = gn(x)
        assert not calls
        tlayers.set_group_norm_fused(gn, True)
        on = gn(x)
    assert calls and on.shape == x.shape
    np.testing.assert_allclose(on.numpy(), off.numpy(), atol=1e-4)


@pytest.mark.parametrize("impl,s,expect", [("xla", 128, 0), ("auto", 128, 1), ("auto", 144, 0)])
def test_cross_attention_route_mirrors_use_dual_kernel(monkeypatch, impl, s, expect):
    """attn2 takes the dual kernel only with the route on and a query length
    the gate takes (144 = the flagship's ds8 fails it); either way the output
    is that of the two-call path."""
    calls = []
    real = tca.dual_cross_attention
    monkeypatch.setattr(tca, "dual_cross_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    torch.manual_seed(0)
    attn = CrossAttention(2, 64, 128, context_dim=32, image_cross_attention=True, attn_impl=impl)
    ref = CrossAttention(2, 64, 128, context_dim=32, image_cross_attention=True, attn_impl="xla")
    ref.load_state_dict(attn.state_dict())
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, s, 128)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 77 + 16, 32)).astype(np.float32))
    with torch.no_grad():
        got, want = attn(x, context=ctx), ref(x, context=ctx)
    assert len(calls) == expect
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5)


# -- UNet3D with the routes on ------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    params = tp.random_params("viewcrafter_tiny", seed=0)
    cfg = get_model_config("viewcrafter_tiny")
    rng = np.random.default_rng(4)
    t, lat = cfg.video_length, cfg.diffusion.latent_size
    x = rng.standard_normal((1, t) + lat + (cfg.unet.in_channels,)).astype(np.float32)
    inputs = dict(x=np.concatenate([x, x]), ts=np.array([500.0, 500.0], np.float32),
                  ctx=rng.standard_normal((2, 77 + 16, cfg.unet.context_dim)).astype(np.float32))
    return params, cfg, inputs


def _routed_engine(cfg, params, tdt):
    eng = VideoDiffusionEngine(cfg, dtype=tdt, device="cpu", cross_attn_impl="auto", gn_fused=True)
    eng.load_params(from_jax_params(params))
    return eng


def test_unet_with_routes_matches_jax_default_route(tiny, monkeypatch):
    """The gate is opened for the preset's 16-wide heads (the twin takes any
    head dim), so that both routes carry the comparison."""
    params, cfg, inp = tiny
    monkeypatch.setattr(tca, "supports_dual", lambda q_shape, lt, li: li > 0)
    outs = {}
    for dt, (jdt, tdt) in {"f32": (jnp.float32, torch.float32),
                           "bf16": (jnp.bfloat16, torch.bfloat16)}.items():
        jeng, _ = tp.engines("viewcrafter_tiny", params, jdt, tdt)
        teng = _routed_engine(cfg, params, tdt)
        ref = jeng.unet.apply(params.unet, jnp.asarray(inp["x"]), jnp.asarray(inp["ts"]),
                              jnp.asarray(inp["ctx"]), shared_prefix=2)
        with torch.no_grad():
            got = teng.unet(*(torch.from_numpy(inp[k]) for k in ("x", "ts", "ctx")),
                            shared_prefix=2)
        outs[dt] = np.asarray(ref, np.float32), got.float().numpy()
    j32, t32 = outs["f32"]
    j16, t16 = outs["bf16"]
    assert np.abs(j32).mean() > 1e-2
    assert tp.max_err(j32, t32) <= 1e-4
    yard = tp.max_err(j16, j32)
    assert tp.max_err(t16, j16) <= 2 * yard + 1e-2, (tp.max_err(t16, j16), yard)


def test_routes_reach_the_wrappers_in_unet_and_vae(tiny, monkeypatch):
    """With the routes on, every GroupNorm of the UNet and the VAE and every
    image cross-attention whose shape passes the gate goes through the kernel
    wrappers (on the CPU: their twins); with both off none does."""
    params, cfg, inp = tiny
    calls = {"gn": 0, "dual": 0}
    real_gn, real_dual = tgn.group_norm_fused, tca.dual_cross_attention

    def gn(*a, **k):
        calls["gn"] += 1
        return real_gn(*a, **k)

    def dual(*a, **k):
        calls["dual"] += 1
        return real_dual(*a, **k)

    monkeypatch.setattr(tgn, "group_norm_fused", gn)
    monkeypatch.setattr(tca, "dual_cross_attention", dual)
    monkeypatch.setattr(tca, "supports_dual", lambda q_shape, lt, li: li > 0)
    args = tuple(torch.from_numpy(inp[k]) for k in ("x", "ts", "ctx"))
    z = torch.zeros((1,) + cfg.diffusion.latent_size + (cfg.vae.z_channels,))
    plain = VideoDiffusionEngine(cfg, dtype=torch.float32, device="cpu", gn_fused=False)
    with torch.no_grad():
        plain.unet(*args)
        plain.vae.decode(z)
    assert calls == {"gn": 0, "dual": 0}
    routed = _routed_engine(cfg, params, torch.float32)
    n_gn_unet = sum(isinstance(m, tlayers.GroupNorm32) for m in routed.unet.modules())
    n_gn_dec = sum(isinstance(m, tlayers.GroupNorm32) for m in routed.vae.decoder.modules())
    n_attn2 = sum(name.endswith("attn2") and isinstance(m, CrossAttention)
                  for name, m in routed.unet.named_modules())
    with torch.no_grad():
        routed.unet(*args)
        assert calls == {"gn": n_gn_unet, "dual": n_attn2}
        routed.vae.decode(z)
    assert calls["gn"] == n_gn_unet + n_gn_dec


def test_default_engine_takes_the_group_norm_route_only(tiny, monkeypatch):
    """A default-built engine sends every GroupNorm of the UNet and the VAE
    decoder through `group_norm_fused`, once per GroupNorm32, and no
    cross-attention through `dual_cross_attention`; `UNet3D` and
    `AutoencoderKL` built on their own keep the plain GroupNorm."""
    _, cfg, inp = tiny
    calls = {"gn": 0, "dual": 0}
    real_gn, real_dual = tgn.group_norm_fused, tca.dual_cross_attention

    def gn(*a, **k):
        calls["gn"] += 1
        return real_gn(*a, **k)

    def dual(*a, **k):
        calls["dual"] += 1
        return real_dual(*a, **k)

    monkeypatch.setattr(tgn, "group_norm_fused", gn)
    monkeypatch.setattr(tca, "dual_cross_attention", dual)
    monkeypatch.setattr(tca, "supports_dual", lambda q_shape, lt, li: li > 0)
    eng = VideoDiffusionEngine(cfg, dtype=torch.float32, device="cpu")
    n_gn_unet = sum(isinstance(m, tlayers.GroupNorm32) for m in eng.unet.modules())
    n_gn_dec = sum(isinstance(m, tlayers.GroupNorm32) for m in eng.vae.decoder.modules())
    z = torch.zeros((1,) + cfg.diffusion.latent_size + (cfg.vae.z_channels,))
    with torch.no_grad(), profiling.recording() as rec:
        eng.unet(*(torch.from_numpy(inp[k]) for k in ("x", "ts", "ctx")))
        assert calls == {"gn": n_gn_unet, "dual": 0}
        eng.vae.decode(z)
    assert calls == {"gn": n_gn_unet + n_gn_dec, "dual": 0}
    assert "group_norm_plain" not in rec.counters
    direct = (UNet3D(cfg.unet, dtype=torch.float32), AutoencoderKL(
        ch=cfg.vae.ch, ch_mult=cfg.vae.ch_mult, num_res_blocks=cfg.vae.num_res_blocks,
        embed_dim=cfg.vae.embed_dim, z_channels=cfg.vae.z_channels, dtype=torch.float32))
    assert not any(m.fused for net in direct for m in net.modules()
                   if isinstance(m, tlayers.GroupNorm32))


@pytest.mark.parametrize("n,takes", [(2, True), (3, False)])
def test_group_norm_route_falls_back_where_the_kernel_cannot_run(monkeypatch, n, takes):
    """On a CUDA tensor the route also needs at most as many samples as the
    kernel's cooperative grid holds (`target_blocks`, here 2): past that it
    runs `group_norm_silu`, where the kernel would raise, and counts one
    `group_norm_plain` inside `recording()` (nothing outside it). The card is
    stood in for: the gate's device test answers yes, and the wrapper on a
    CPU tensor runs the twin."""
    calls = []
    real = tgn.group_norm_fused
    monkeypatch.setattr(tgn, "group_norm_fused", lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tgn, "target_blocks", lambda itemsize: 2)
    monkeypatch.setattr(tlayers, "_kernel_runs", lambda x: True)
    gn = tlayers.set_group_norm_fused(tlayers.GroupNorm32(64, with_silu=True), True)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((n, 3, 5, 64))).bfloat16()
    with torch.no_grad():
        with profiling.recording() as rec:
            got = gn(x)
        gn(x)
    assert len(calls) == 2 * takes
    assert rec.counters.get("group_norm_plain", []) == ([] if takes else [1])
    if not takes:
        want = tlayers.group_norm_silu(x, gn.weight, gn.bias, 32, gn.eps, True)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_routes_add_no_parameters():
    """`convert.from_jax_params` maps every parameter the routes use: an
    engine built with the routes on has the state dict of one with them off."""
    cfg = get_model_config("viewcrafter_tiny")
    off = VideoDiffusionEngine(cfg, dtype=torch.float32, device="cpu", gn_fused=False)
    on = VideoDiffusionEngine(cfg, dtype=torch.float32, device="cpu", cross_attn_impl="auto",
                              gn_fused=True)
    for name in SUBMODELS:
        a, b = getattr(off, name).state_dict(), getattr(on, name).state_dict()
        assert list(a) == list(b)
        assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a)


def test_long_clip_config_takes_the_temporal_attention_gate():
    """A 40-frame copy of `viewcrafter_25_512` fails the layer kernel's gate
    and passes `supports_fused` at every temporal site."""
    from viewcrafter_tpu_torch.ops.kernels import temporal_layer as ttl

    cfg = dataclasses.replace(get_model_config("viewcrafter_25_512"), video_length=40)
    hh, ww = cfg.diffusion.latent_size
    for ds, ch in ((1, 320), (2, 640), (4, 1280), (8, 1280)):
        s, h = (hh // ds) * (ww // ds), ch // 64
        assert not ttl.supports_fused_layer((2, 40, s, ch), h, 64)
        assert tta.supports_fused((2, 40, s, h, 64))


@pytest.mark.parametrize("preset", ["viewcrafter_25", "viewcrafter_25_512"])
@pytest.mark.parametrize("frames", [16, 25, 32])
def test_short_clips_keep_the_layer_kernel_at_every_temporal_site(preset, frames):
    """`_temporal_attention` takes `temporal_attention_fused` wherever its gate
    holds. Up to 32 frames no temporal site of the full-width presets (16
    frames is the JAX package's `viewcrafter_16`) reaches it: the layer
    kernel's gate holds at each of them, for every CFG batch, so the default
    path launches what it launched before the kernel existed."""
    from viewcrafter_tpu_torch.ops.kernels import temporal_layer as ttl

    cfg = get_model_config(preset)
    hh, ww = cfg.diffusion.latent_size
    mc = cfg.unet.model_channels
    levels = [(2 ** i, mc * m) for i, m in enumerate(cfg.unet.channel_mult)]
    assert levels == [(1, 320), (2, 640), (4, 1280), (8, 1280)]
    for ds, ch in levels:
        s, h = (hh // ds) * (ww // ds), ch // cfg.unet.num_head_channels
        for batch in (1, 2, 3):
            assert ttl.supports_fused_layer((batch, frames, s, ch), h, 64)
            assert tta.supports_fused((batch, frames, s, h, 64))
