"""Tensor parallelism of the port (`viewcrafter_tpu_torch/parallel/tp.py`)
on the CPU.

Each split module (`CrossAttention` self and dual, `TemporalSelfAttention`
on its plain route and on the layer kernel's route at the local width,
`FeedForward` on its plain and its kernel's route, `ResBlock`,
`TemporalConvBlock`, and the whole UNet) is cut into tp shards that run in
threads of this process (`torch_parity.run_tp_threads`: the all-reduce adds
the threads' partials), and the sum is held against the whole module at
1e-5 in float32, at tp 2 and 4 and with 3 heads (split 2/1 at tp = 2, and
1/1/1/0 at tp = 4: a rank without heads adds zeros). On a CPU tensor a
kernel's wrapper runs its plain twin, so the kernel routes are held here
through the twins at the local shapes the card launches.

Then `generate_staged` on gloo ranks (`parallel.mesh.spawn`, each spawn with
a timeout of its own), 2 DDIM steps, K = 2 CFG, on `viewcrafter_tiny` with
model_channels 96 and head width 32 in both packages (3 and 6 heads, so an
uneven split at tp = 2):
  - dp 1 x tp 2 on 2 ranks against the JAX package's own tp run
    (`make_mesh(2, dp=1, tp=2)` on the virtual CPU devices of
    tests/conftest.py) at the float32 `generate` bound, 5e-3, with the JAX
    draws carried as explicit noise;
  - the same arrangement against the port's single-device run at the JAX dry
    run's 2e-5, exact sampling and PAB reuse under sequential CFG;
  - dp 2 x tp 2 on 4 ranks (two samples over dp) against the single-device
    run at 2e-5.
The 2e-5 comparisons build their engines in float64
(`_dryrun.TP_DTYPE`): a split sum cannot match the unsharded one to the bit,
and in float32 this model's own rounding moves the video by more than 2e-5,
which the last test holds. The ranks run MKL in its batch-invariant mode
(`_dryrun.batch_invariant_cpu`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from viewcrafter_tpu.parallel.mesh import make_mesh as jax_make_mesh
from viewcrafter_tpu.sampling.ddim import GuidanceConfig as JaxGuidance
from viewcrafter_tpu_torch import _dryrun
from viewcrafter_tpu_torch.config import get_model_config
from viewcrafter_tpu_torch.convert import from_jax_params
from viewcrafter_tpu_torch.models.layers import FeedForward, LayerNormF32, init_random_
from viewcrafter_tpu_torch.models.unet3d import (
    CrossAttention,
    ResBlock,
    TemporalConvBlock,
    TemporalSelfAttention,
    UNet3D,
)
from viewcrafter_tpu_torch.ops.kernels import ff_layer, temporal_layer
from viewcrafter_tpu_torch.parallel import mesh as pm
from viewcrafter_tpu_torch.parallel.mesh import Axis
from viewcrafter_tpu_torch.parallel.tp import head_block, shard_unet_
from viewcrafter_tpu_torch.sampling.ddim import GuidanceConfig

MODULE_TOL = 1e-5
JAX_TOL = 5e-3
PORT_TOL = 2e-5
STEPS = 2
FS = 10
SPAWN_TIMEOUT = 300
WIDTHS = dict(model_channels=96, num_head_channels=32)
# (heads, tp): uneven, uneven with an empty block, even
HEAD_CASES = [(3, 2), (3, 4), (4, 4)]


def _module(cls, *args, seed=0, **kw):
    mod = cls(*args, **kw)
    init_random_(mod, torch.Generator().manual_seed(seed))
    return mod.eval()


def _randn(*shape, seed=1):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _shard_sum(module, size, call):
    """call(shard) on each of `size` shards of `module` in threads; every
    thread's result (the all-reduced output), checked equal, and the first."""
    shards = tp.shard_copies(module, size)
    outs = tp.run_tp_threads(lambda ax: call(tp.set_axis(shards[ax.index], ax)), size)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    return outs[0]


def _assert_close(got, ref, tol=MODULE_TOL):
    assert got.shape == ref.shape
    assert float(ref.abs().mean()) > 1e-2
    assert tp.max_err(got.numpy(), ref.numpy()) <= tol


@pytest.mark.parametrize("n,size,blocks", [
    (5, 2, [(0, 3), (3, 5)]), (5, 4, [(0, 2), (2, 3), (3, 4), (4, 5)]),
    (32, 4, [(0, 8), (8, 16), (16, 24), (24, 32)]), (3, 4, [(0, 1), (1, 2), (2, 3), (3, 3)])])
def test_head_block_takes_one_more_on_the_first_ranks(n, size, blocks):
    got = [head_block(n, Axis(None, size, i)) for i in range(size)]
    assert [(b.start, b.stop) for b in got] == blocks


@pytest.mark.parametrize("heads,size", HEAD_CASES)
@pytest.mark.parametrize("kind", ["self", "dual"])
def test_cross_attention_shards_sum_to_the_whole(kind, heads, size):
    """Self-attention on the plain route; the dual image cross-attention
    through `dual_cross_attention` (its twin here) on the local heads."""
    c = 96
    if kind == "self":
        mod = _module(CrossAttention, heads, 64, c)
        args = (_randn(2, 40, c),)
    else:
        mod = _module(CrossAttention, heads, 64, c, context_dim=48, image_cross_attention=True,
                      text_context_len=7, attn_impl="auto")
        args = (_randn(2, 128, c), _randn(2, 7 + 16, 48, seed=2))
    with torch.no_grad():
        ref = mod(*args)
    _assert_close(_shard_sum(mod, size, lambda m: m(*args)), ref)


@pytest.mark.parametrize("heads,size", HEAD_CASES)
@pytest.mark.parametrize("route", ["plain", "layer_kernel"])
def test_temporal_attention_shards_sum_to_the_whole(route, heads, size):
    """The plain route through the module; the layer kernel's route (the
    card's, at inner = local heads * 64 != C) through `fused_temporal_layer`
    on each shard's weights, its partials summed."""
    c = 96
    mod = _module(TemporalSelfAttention, heads, 64, c)
    ln = _module(LayerNormF32, c, seed=3)
    x = _randn(2, 5, 12, c)
    with torch.no_grad():
        ref = mod(x, ln=ln)
    if route == "plain":
        got = _shard_sum(mod, size, lambda m: m(x, ln=ln))
    else:
        got = torch.zeros_like(ref)
        for shard in tp.shard_copies(mod, size):
            if shard.heads == 0:
                continue
            wqkv = torch.cat([shard.to_q.weight, shard.to_k.weight, shard.to_v.weight])
            assert wqkv.shape == (3 * shard.heads * 64, c)
            with torch.no_grad():
                got += temporal_layer.fused_temporal_layer(
                    x, ln.weight, ln.bias, wqkv, shard.to_out.weight, shard.to_out.bias,
                    heads=shard.heads, dim_head=64)
    _assert_close(got, ref)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("route", ["plain", "ff_kernel"])
def test_feed_forward_shards_sum_to_the_whole(route, size):
    """GEGLU hidden 4C split over tp from both halves of the (2I, C)
    weight; the kernel's route through `fused_ff_layer` on (2I/tp, C) and
    (C, I/tp)."""
    c = 96
    mod = _module(FeedForward, c)
    ln = _module(LayerNormF32, c, seed=3)
    x = _randn(2, 30, c)
    with torch.no_grad():
        ref = mod(x, ln=ln)
    if route == "plain":
        got = _shard_sum(mod, size, lambda m: m(x, ln=ln))
    else:
        got = torch.zeros_like(ref)
        for shard in tp.shard_copies(mod, size):
            assert shard.inner == 4 * c // size
            with torch.no_grad():
                got += ff_layer.fused_ff_layer(x, ln.weight, ln.bias, shard.geglu.proj.weight,
                                               shard.geglu.proj.bias, shard.out.weight,
                                               shard.out.bias)
    _assert_close(got, ref)


@pytest.mark.parametrize("size", [2, 4])
def test_resblock_shards_sum_to_the_whole(size):
    """in 64 -> out 96 channels (a replicated 1x1 skip), with its temporal
    conv block: both all-reduces of the row-parallel convs."""
    mod = _module(ResBlock, 64, 96, 48, use_temporal_conv=True)
    x, emb = _randn(2 * 4, 6, 8, 64), _randn(2 * 4, 48, seed=2)
    with torch.no_grad():
        ref = mod(x, emb, 2)
    _assert_close(_shard_sum(mod, size, lambda m: m(x, emb, 2)), ref)
    shard = tp.shard_copies(mod, size)[0]
    assert shard.out_norm.num_groups == 32 // size
    assert shard.temporal_conv.conv_1.weight.shape == (96, 96 // size, 3, 1, 1)


@pytest.mark.parametrize("size", [2, 4])
def test_temporal_conv_block_shards_sum_to_the_whole(size):
    mod = _module(TemporalConvBlock, 64)
    x = _randn(2, 6, 4, 8, 64)
    with torch.no_grad():
        ref = mod(x)
    _assert_close(_shard_sum(mod, size, lambda m: m(x)), ref)


@pytest.mark.parametrize("size", [2, 4])
def test_unet_shards_match_the_whole(size):
    """The whole UNet at 96 channels (3 and 6 heads, init_attn 8 heads of
    32), PAB collect included: the cache's entries are the reduced outputs."""
    cfg = dataclasses.replace(get_model_config("viewcrafter_tiny").unet, **WIDTHS)
    unet = _module(UNet3D, cfg, dtype=torch.float32)
    args = (_randn(2, 4, 4, 8, cfg.in_channels), torch.tensor([500.0, 500.0]),
            _randn(2, 77 + 16, cfg.context_dim, seed=2))
    with torch.no_grad():
        ref, cache = unet(*args, collect_cache=True)
    shards = tp.shard_copies(unet, size)
    got, got_cache = tp.run_tp_threads(
        lambda ax: tp.set_axis(shards[ax.index], ax)(*args, collect_cache=True), size)[0]
    _assert_close(got, ref)
    assert set(got_cache) == set(cache)
    assert max(tp.max_err(got_cache[k].numpy(), v.numpy()) for k, v in cache.items()) <= MODULE_TOL


def test_tp_must_divide_the_groups_and_the_devices():
    unet = UNet3D(get_model_config("viewcrafter_tiny").unet, dtype=torch.float32)
    with pytest.raises(ValueError, match="32 GroupNorm groups"):
        shard_unet_(unet, Axis(None, 3, 0))
    assert shard_unet_(unet, Axis()) is unet  # tp = 1: untouched
    with pytest.raises(ValueError, match="cannot factor"):
        pm.make_mesh(2, dp=1, tp=3)


# -- generate_staged on gloo ranks ----------------------------------------------


@pytest.fixture(scope="module")
def sharded():
    """The JAX package's tp run and the port's runs on 2 and 4 ranks."""
    jcfg = tp.jax_model_config("viewcrafter_tiny")
    jcfg = dataclasses.replace(jcfg, unet=dataclasses.replace(jcfg.unet, **WIDTHS))
    cfg = get_model_config("viewcrafter_tiny")
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, **WIDTHS))
    jeng = tp.JaxEngine(jcfg, dtype=jnp.float32)
    params = tp.fill_tree(jax.eval_shape(jeng.init_params, jax.random.PRNGKey(0)),
                          np.random.default_rng(5))
    state = {n: {k: v.numpy() for k, v in sd.items()} for n, sd in from_jax_params(params).items()}
    rng = np.random.default_rng(6)

    def inputs(b):
        frames = rng.uniform(-1, 1, (b, cfg.video_length, cfg.height, cfg.width, 3)
                             ).astype(np.float32)
        return (frames, np.repeat(tp.fixed_prompt_ids(6), b, 0).astype(np.int64),
                np.repeat(tp.fixed_prompt_ids(0), b, 0).astype(np.int64))

    one, two = inputs(1), inputs(2)
    key = jax.random.PRNGKey(13)
    jax_video = np.asarray(jeng.generate_staged(
        params, *map(jnp.asarray, one), key, steps=STEPS, guidance=JaxGuidance(), fs=FS,
        chunk=STEPS, mesh=jax_make_mesh(2, dp=1, tp=2,
                                        devices=jax.local_devices(backend="cpu")[:2])),
        np.float32)
    noise = tp.jax_noise(key, one[0].shape, STEPS, cfg.vae.z_channels, cfg.vae.downsample_factor)
    noise = tuple(a.numpy() for a in (noise.x_T, noise.steps, noise.posterior))
    kw = dict(steps=STEPS, guidance=GuidanceConfig(), fs=FS, chunk=STEPS)
    pab = dict(kw, guidance=GuidanceConfig(sequential=True), attn_reuse_interval=2)
    f64, tp2 = _dryrun.TP_DTYPE, {"dp": 1, "tp": 2}
    runs2 = {"vs_jax": _dryrun.Run(*one, noise, kw, tp2),
             "exact": _dryrun.Run(*one, noise, kw, tp2, f64),
             "pab_sequential": _dryrun.Run(*one, noise, pab, tp2, f64)}
    runs4 = {"dp2_tp2": _dryrun.Run(*two, None, kw, {"dp": 2, "tp": 2}, f64)}
    port = {}
    for world, runs in ((2, runs2), (4, runs4)):
        results = pm.spawn(_dryrun.generate_on_mesh, world, "gloo", devices=["cpu"] * world,
                           args=(cfg, state, list(runs.values())), timeout=SPAWN_TIMEOUT)
        for j, name in enumerate(runs):
            port[name] = [r[j] for r in results]
    return {"jax": jax_video, "port": port}


def test_tp_generate_matches_the_jax_tp_run(sharded):
    got, _ = sharded["port"]["vs_jax"][0]
    ref = sharded["jax"]
    assert got.shape == ref.shape == (1, 4, 32, 64, 3)
    assert np.abs(ref).mean() > 1e-2
    assert tp.max_err(got, ref) <= JAX_TOL


@pytest.mark.parametrize("case,ranks", [("exact", 2), ("pab_sequential", 2), ("dp2_tp2", 4)])
def test_tp_generate_matches_single_device(sharded, case, ranks):
    """Every rank returns the whole video, the same on each, within 2e-5 of
    the single-device run."""
    per_rank = sharded["port"][case]
    got, single = per_rank[0]
    assert len(per_rank) == ranks
    assert all(np.array_equal(v, got) for v, _ in per_rank[1:])
    assert single is not None and single.shape == got.shape and np.abs(single).mean() > 1e-2
    assert tp.max_err(got, single) <= PORT_TOL


def test_float32_rounding_alone_exceeds_the_dry_run_bound():
    """Why the 2e-5 comparisons run in float64: on the dry run's inputs
    (its CFG-branch run, `viewcrafter_tiny`, seeded weights) the unsharded
    float32 video already differs from the float64 one by more than the
    dry run's bound, so no rounding-level change, a split sum included, could
    be held to it in float32."""
    cfg, runs = _dryrun.dryrun_runs(4, get_model_config("viewcrafter_tiny"))
    run = runs["cfg_branch_dp"]
    videos = []
    for dtype in (torch.float32, _dryrun.TP_DTYPE):
        eng = _dryrun.engine_on_rank(cfg, None, dtype)
        videos.append(eng.generate_staged(
            *map(torch.from_numpy, (run.frames, run.ids, run.uids)),
            generator=torch.Generator().manual_seed(_dryrun.SEED), **run.kwargs).numpy())
    err = tp.max_err(*videos)
    assert _dryrun.ATOL < err < 1e-3, err
