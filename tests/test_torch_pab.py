"""PAB attention reuse in the port against the JAX package, on the CPU:
`AttnCacheCtx` through `UNet3D.forward`, the windowed samplers, and
`generate_staged` with reuse intervals 1 and 3 on `viewcrafter_tiny`, batched
and with sequential CFG (K = 3).

The JAX engine draws its noise with jax.random; `torch_parity.jax_noise`
rebuilds those draws (prepare splits the key as `generate` does, each window
folds the step index into the sampling key) for the port's explicit-noise
argument. Every weight leaf is non-zero (numpy RNG).

Tolerances, float32 on both sides. One UNet pass and its cache entries: the
same math in another summation order, atol 1e-4 on values of order 1 (as
`test_torch_modules.py`). `generate_staged`: the same, amplified by CFG
(scale 7.5) over the steps: atol 5e-3 on a video in [-1, 1] (as
`test_torch_generate.py`). Feeding a pass its own cache back changes nothing
but the batch size of the context-free prefix: atol 1e-5. f8 storage rounds
each cached value to 3 mantissa bits (relative 2^-4): the JAX package's own
test allows 0.15 on the output, and so does this one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from viewcrafter_tpu.sampling.ddim import GuidanceConfig as JaxGuidance
from viewcrafter_tpu_torch.ops.schedule import DDIMSchedule
from viewcrafter_tpu_torch.sampling.ddim import (
    GuidanceConfig,
    ddim_sample,
    ddim_sample_window,
    ddim_sample_window_pab,
)

ALL_KINDS = ("spatial", "cross", "temporal", "ff")
DS1_SITES = ("down_0", "up_0", "init_attn")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def setup():
    params = tp.random_params("viewcrafter_tiny", seed=3)
    jeng, teng = tp.engines("viewcrafter_tiny", params, jnp.float32, torch.float32)
    cfg = jeng.cfg
    rng = np.random.default_rng(9)
    t, lat = cfg.video_length, cfg.diffusion.latent_size
    unet_in = dict(
        x=rng.standard_normal((2, t) + lat + (cfg.unet.in_channels,)).astype(np.float32),
        ts=np.array([500.0, 500.0], np.float32),
        ctx=rng.standard_normal((2, 77 + 16, cfg.unet.context_dim)).astype(np.float32))
    frames = rng.uniform(-1, 1, (1, t, cfg.height, cfg.width, 3)).astype(np.float32)
    ids, uids = tp.fixed_prompt_ids(6), tp.fixed_prompt_ids(0)
    return params, jeng, teng, cfg, unet_in, frames, ids, uids


def _unet(teng, inp, **kw):
    with torch.no_grad():
        return teng.unet(_t(inp["x"]), _t(inp["ts"]), _t(inp["ctx"]), **kw)


# -- the cache through UNet3D.forward -----------------------------------------


def test_collected_cache_matches_jax_site_by_site(setup):
    """Same site names, same values: the caches compare by key."""
    params, jeng, teng, _, inp, *_ = setup
    y_ref, cache_ref = jeng.unet.apply(params.unet, jnp.asarray(inp["x"]), jnp.asarray(inp["ts"]),
                                       jnp.asarray(inp["ctx"]), collect_cache=True,
                                       cache_kinds=ALL_KINDS)
    y, cache = _unet(teng, inp, collect_cache=True, cache_kinds=ALL_KINDS)
    assert set(cache) == set(cache_ref) and len(cache) > 0
    assert tp.max_err(y.numpy(), y_ref) <= 1e-4
    for name, val in cache.items():
        assert tuple(val.shape) == tuple(cache_ref[name].shape), name
        assert tp.max_err(val.numpy(), cache_ref[name]) <= 1e-4, name


def test_collect_then_reuse_is_identity_and_baseline_unchanged(setup):
    *_, teng, _, inp, _, _, _ = setup
    y0 = _unet(teng, inp)
    y1, cache = _unet(teng, inp, collect_cache=True)
    assert tp.max_err(y0.numpy(), y1.numpy()) <= 1e-5
    y2 = _unet(teng, inp, attn_cache=cache)
    assert tp.max_err(y2.numpy(), y1.numpy()) <= 1e-5


def test_stale_cache_is_consumed(setup):
    *_, teng, _, inp, _, _, _ = setup
    _, cache = _unet(teng, inp, collect_cache=True)
    inp2 = dict(inp, x=inp["x"] + 0.5)
    y_full, y_stale = _unet(teng, inp2), _unet(teng, inp2, attn_cache=cache)
    assert torch.isfinite(y_stale).all()
    assert tp.max_err(y_stale.numpy(), y_full.numpy()) > 1e-4


@pytest.mark.parametrize("kinds,suffixes", [
    (("cross",), ("attn2",)), (("temporal",), ("attn1", "attn2")), (("ff",), ("ff",))])
def test_cache_kind_filtering(setup, kinds, suffixes):
    *_, teng, _, inp, _, _, _ = setup
    _, cache_all = _unet(teng, inp, collect_cache=True, cache_kinds=ALL_KINDS)
    _, cache = _unet(teng, inp, collect_cache=True, cache_kinds=kinds)
    assert 0 < len(cache) < len(cache_all) and set(cache) <= set(cache_all)
    assert all(name.rsplit("/", 1)[1] in suffixes for name in cache)
    if kinds == ("cross",):
        assert all("spatial" in name for name in cache)
    if kinds == ("temporal",):
        assert all("temporal" in name or name.startswith("init_attn") for name in cache)


def test_site_filtering_and_partial_reuse(setup):
    """`cache_sites` keeps the matching prefixes only; a partial cache reuses
    those sites and recomputes the rest, so its own pass is reproduced."""
    *_, teng, cfg, inp, _, _, _ = setup
    z_cond = torch.zeros((1, cfg.video_length) + cfg.diffusion.latent_size + (4,))
    contexts = _t(inp["ctx"])[:, None]
    _, d_full, d_reuse = teng._denoise_fn(z_cond, contexts, 10.0, GuidanceConfig(),
                                          cache_sites=DS1_SITES)
    _, d_full_all, _ = teng._denoise_fn(z_cond, contexts, 10.0, GuidanceConfig())
    x_k, t_k = _t(inp["x"][..., :4]), _t(inp["ts"])
    with torch.no_grad():
        v, cache = d_full(x_k, t_k)
        _, cache_all = d_full_all(x_k, t_k)
        v_reuse = d_reuse(x_k, t_k, cache)
    assert 0 < len(cache) < len(cache_all)
    assert all(name.startswith(DS1_SITES) for name in cache)
    assert {n for n in cache_all if n.startswith(DS1_SITES)} == set(cache)
    assert tp.max_err(v_reuse.numpy(), v.numpy()) <= 1e-5


def test_f8_storage(setup):
    *_, teng, _, inp, _, _, _ = setup
    y_ref = _unet(teng, inp)
    _, cache = _unet(teng, inp, collect_cache=True, cache_kinds=ALL_KINDS,
                     cache_dtype=torch.float8_e4m3fn)
    assert all(v.dtype == torch.float8_e4m3fn for v in cache.values())
    y_f8 = _unet(teng, inp, attn_cache=cache, cache_kinds=ALL_KINDS)
    err = tp.max_err(y_f8.numpy(), y_ref.numpy())
    assert torch.isfinite(y_f8).all() and 0 < err < 0.15, err


# -- the windowed samplers ------------------------------------------------------


def _toy_chain(steps=7):
    """A denoiser whose cache is the step's own input, so that a reuse step
    differs from a full one, on the tiny preset's schedule."""
    from viewcrafter_tpu_torch.config import get_model_config
    from viewcrafter_tpu_torch.ops.schedule import DiffusionSchedule

    d = get_model_config("viewcrafter_tiny").diffusion
    sched = DiffusionSchedule.create(
        timesteps=d.timesteps, beta_schedule=d.beta_schedule, linear_start=d.linear_start,
        linear_end=d.linear_end, rescale_betas_zero_snr=d.rescale_betas_zero_snr,
        use_dynamic_rescale=d.use_dynamic_rescale, base_scale=d.base_scale,
        turning_step=d.turning_step)
    dd = DDIMSchedule.create(sched, steps, eta=1.0)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 2, 3, 4, 4), generator=g)
    noise = torch.randn((steps,) + x.shape, generator=g)
    calls = []

    def full(x_k, t_k):
        calls.append("full")
        return torch.tanh(x_k) * (1 + t_k[:, None, None, None, None] / 1000), {"a": x_k.clone()}

    def reuse(x_k, t_k, cache):
        calls.append("reuse")
        return torch.tanh(cache["a"]) * (1 + t_k[:, None, None, None, None] / 1000) + 0.1 * x_k

    return dd, x, (lambda i: noise[i]), full, reuse, calls


def test_window_chain_equals_ddim_sample():
    dd, x, step_noise, full, _, _ = _toy_chain()
    denoise = lambda x_k, t_k: full(x_k, t_k)[0]  # noqa: E731
    whole = ddim_sample(denoise, x, dd, step_noise)
    y = x
    for s0, n in ((0, 3), (3, 3), (6, 1)):
        y = ddim_sample_window(denoise, y, dd, step_noise, s0, n)
    assert torch.equal(y, whole)


def test_pab_cells_in_one_window_equal_one_window_per_cell():
    """One call with a cell count (interval 3 over 7 steps: two cells and a
    tail of 1) is the JAX package's multi-cell window plus remainder."""
    dd, x, step_noise, full, reuse, calls = _toy_chain()
    kinds = []
    one = ddim_sample_window_pab(full, reuse, x, dd, step_noise, 0, 7, 3,
                                 on_step=lambda i, kind: kinds.append((i, kind)))
    assert calls == ["full", "reuse", "reuse"] * 2 + ["full"]
    assert kinds == [(i, "full" if i % 3 == 0 else "reuse") for i in range(7)]
    y = x
    for s0, n in ((0, 3), (3, 3), (6, 1)):
        y = ddim_sample_window_pab(full, reuse, y, dd, step_noise, s0, n, 3)
    assert torch.equal(y, one)
    exact = ddim_sample(lambda x_k, t_k: full(x_k, t_k)[0], x, dd, step_noise)
    assert not torch.equal(exact, one)


# -- generate_staged ------------------------------------------------------------


def _staged_pair(setup, steps, guidance=None, **kw):
    """`generate_staged` of both packages on the same inputs and draws;
    guidance: GuidanceConfig's arguments (default K = 2, batched)."""
    params, jeng, teng, cfg, _, frames, ids, uids = setup
    key = jax.random.PRNGKey(11)
    ref = jeng.generate_staged(params, jnp.asarray(frames), jnp.asarray(ids), jnp.asarray(uids),
                               key, steps=steps, guidance=JaxGuidance(**(guidance or {})), **kw)
    noise = tp.jax_noise(key, frames.shape, steps, cfg.vae.z_channels, cfg.vae.downsample_factor)
    stages = []
    got = teng.generate_staged(torch.from_numpy(frames), torch.from_numpy(ids).long(),
                               torch.from_numpy(uids).long(), steps=steps,
                               guidance=GuidanceConfig(**(guidance or {})), noise=noise,
                               on_stage=stages.append, **kw)
    return np.asarray(ref, np.float32), got.numpy(), stages, noise


def test_generate_staged_interval1_matches_jax_and_generate(setup):
    ref, got, stages, noise = _staged_pair(setup, 3, chunk=2)
    assert got.shape == ref.shape and np.abs(ref).mean() > 1e-2
    assert tp.max_err(got, ref) <= 5e-3
    assert stages == ["prepare", "step", "step", "step", "decode"]
    _, _, teng, _, _, frames, ids, uids = setup
    mono = teng.generate(torch.from_numpy(frames), torch.from_numpy(ids).long(),
                         torch.from_numpy(uids).long(), steps=3, noise=noise)
    assert torch.equal(mono, torch.from_numpy(got))


def test_generate_staged_interval3_matches_jax(setup):
    """4 steps at interval 3: one cell (full, reuse, reuse) and a tail of one
    full step, with the ds1 site filter."""
    ref, got, stages, _ = _staged_pair(setup, 4, attn_reuse_interval=3,
                                       attn_reuse_sites=DS1_SITES)
    assert tp.max_err(got, ref) <= 5e-3
    assert stages == ["prepare", "full", "reuse", "reuse", "full", "decode"]


def test_generate_staged_sequential_cfg_with_reuse_matches_jax(setup):
    """Sequential CFG under the attention cache: one UNet call per branch,
    each branch with its own cache. K = 3 (multi-condition CFG), which runs
    the per-branch loop that K = 2 runs: one cell of 3 steps at interval 3
    with the ds1 site filter against the JAX package. Then one pass:
    sequential denoise_full returns K caches, each with the batched cache's
    filtered sites and the branches' values, and reusing them reproduces
    the pass."""
    ref, got, stages, _ = _staged_pair(setup, 3, guidance=dict(cfg_img=1.5, sequential=True),
                                       attn_reuse_interval=3, attn_reuse_sites=DS1_SITES)
    assert tp.max_err(got, ref) <= 5e-3
    assert stages == ["prepare", "full", "reuse", "reuse", "decode"]

    *_, teng, cfg, inp, _, _, _ = setup
    z_cond = torch.zeros((1, cfg.video_length) + cfg.diffusion.latent_size + (4,))
    x, t, ctx = _t(inp["x"][..., :4]), _t(inp["ts"]), _t(inp["ctx"])
    x_k, t_k, contexts = (torch.cat([a, a[:1]]) for a in (x, t, ctx))  # K = 3 branches
    fns = {seq: teng._denoise_fn(z_cond, contexts[:, None], 10.0,
                                 GuidanceConfig(cfg_img=1.5, sequential=seq),
                                 cache_sites=DS1_SITES) for seq in (False, True)}
    with torch.no_grad():
        v, cache = fns[False][1](x_k, t_k)
        v_seq, caches = fns[True][1](x_k, t_k)
        v_reuse = fns[True][2](x_k, t_k, caches)
        v_base = fns[True][0](x_k, t_k)
    assert isinstance(caches, list) and len(caches) == 3
    assert all(set(c) == set(cache) for c in caches)
    for name, val in cache.items():
        assert tp.max_err(torch.cat([c[name] for c in caches]).numpy(), val.numpy()) <= 1e-4
    assert tp.max_err(v_seq.numpy(), v.numpy()) <= 1e-4
    assert tp.max_err(v_reuse.numpy(), v_seq.numpy()) <= 1e-5
    assert tp.max_err(v_base.numpy(), v_seq.numpy()) <= 1e-5


def test_generate_staged_reuse_differs_from_exact_sampling(setup):
    """Reuse is an approximation: it must not silently run exact sampling.
    f8 storage and the ff kind run end to end and stay finite."""
    _, _, teng, cfg, _, frames, ids, uids = setup
    noise = tp.jax_noise(jax.random.PRNGKey(11), frames.shape, 4, cfg.vae.z_channels,
                         cfg.vae.downsample_factor)
    args = (torch.from_numpy(frames), torch.from_numpy(ids).long(), torch.from_numpy(uids).long())
    exact = teng.generate_staged(*args, steps=4, noise=noise)
    pab = teng.generate_staged(*args, steps=4, noise=noise, attn_reuse_interval=2,
                               attn_reuse_kinds=ALL_KINDS, attn_reuse_dtype="f8")
    assert torch.isfinite(pab).all() and pab.shape == exact.shape
    assert tp.max_err(pab.numpy(), exact.numpy()) > 1e-4


def test_unported_staged_options_raise(setup):
    """Tensor parallelism is ported (tests/test_torch_tp.py), attention reuse
    under it included: the denoise programs of a tp axis (two threads in
    for the ranks, `torch_parity.run_tp_threads`) collect the all-reduced
    outputs and reuse them as the unsharded programs do, to rounding (the
    same math in another summation order: 1e-4). What still raises: a tp
    mesh that does not factor the devices, a tp that does not divide the
    UNet's 32 GroupNorm groups (a stand-in mesh with the attributes
    `parallel.mesh.axis` reads), and an unknown cache dtype."""
    _, _, teng, cfg, inp, frames, ids, uids = setup
    args = (torch.from_numpy(frames), torch.from_numpy(ids).long(), torch.from_numpy(uids).long())
    from types import SimpleNamespace

    from viewcrafter_tpu_torch.parallel.mesh import NO_AXIS, make_mesh

    with pytest.raises(ValueError, match="cannot factor"):
        make_mesh(2, dp=1, tp=3)
    tp3_mesh = SimpleNamespace(mesh_dim_names=("dp", "sp", "tp"), shape=(1, 1, 3),
                               get_group=lambda name: None, get_local_rank=lambda name: 0)
    with pytest.raises(ValueError, match="32 GroupNorm groups"):
        teng.generate_staged(*args, steps=2, mesh=tp3_mesh)
    with pytest.raises(KeyError):
        teng.generate_staged(*args, steps=2, attn_reuse_interval=2, attn_reuse_dtype="f4")

    z_cond = torch.zeros((1, cfg.video_length) + cfg.diffusion.latent_size + (4,))
    contexts = _t(inp["ctx"])[:, None]
    x_k, t_k = _t(inp["x"][..., :4]), _t(inp["ts"])

    def programs(head_axis):
        _, d_full, d_reuse = teng._denoise_fn(z_cond, contexts, 10.0, GuidanceConfig(),
                                              cache_sites=DS1_SITES, head_axis=head_axis)
        with torch.no_grad():
            v, cache = d_full(x_k, t_k)
            return v, cache, d_reuse(x_k, t_k, cache)

    v, cache, v_reuse = programs(NO_AXIS)
    tp_v, tp_cache, tp_reuse = tp.run_tp_threads(programs, 2)[0]
    assert set(tp_cache) == set(cache) and len(cache) > 0
    for name, val in cache.items():
        assert tp.max_err(tp_cache[name].numpy(), val.numpy()) <= 1e-4, name
    assert tp.max_err(tp_v.numpy(), v.numpy()) <= 1e-4
    assert tp.max_err(tp_reuse.numpy(), v_reuse.numpy()) <= 1e-4
