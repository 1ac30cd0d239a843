"""The port's modules against the JAX package's, on the CPU.

Weights: every leaf of the JAX tree filled from a numpy RNG (none zero, so
no branch drops out), carried to the port by `convert.from_jax_params`.

Tolerances. float32 on both sides: the same math in another summation order,
atol 1e-4 on outputs of order 1 (the observed gap is ~1e-5). bfloat16 on
both sides: the frameworks round at slightly different points (e.g. a conv's
bias is added before or after the output rounding), and through a deep net
with random weights those 1-ulp differences grow; the yardstick is the JAX
package's own bf16 distance from its float32 output: the port's bf16 output
must lie within twice that distance (plus 1e-2) of the JAX bf16 output.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from viewcrafter_tpu.models import layers as jlayers
from viewcrafter_tpu.models.clip import clip_preprocess as jax_clip_preprocess
from viewcrafter_tpu.ops import schedule as jsched
from viewcrafter_tpu.ops.pallas.groupnorm import group_norm_silu as jax_gn
from viewcrafter_tpu_torch.config import get_model_config
from viewcrafter_tpu_torch.convert import convert_tree, from_jax_params
from viewcrafter_tpu_torch.models import layers as tlayers
from viewcrafter_tpu_torch.models.clip import clip_preprocess
from viewcrafter_tpu_torch.models.lvdm import SUBMODELS, VideoDiffusionEngine
from viewcrafter_tpu_torch.ops import schedule as tsched

F32_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# -- schedule ---------------------------------------------------------------


def test_schedule_arrays_equal_jax():
    d = get_model_config("viewcrafter_25").diffusion
    kw = dict(timesteps=d.timesteps, beta_schedule=d.beta_schedule, linear_start=d.linear_start,
              linear_end=d.linear_end, rescale_betas_zero_snr=True, use_dynamic_rescale=True,
              base_scale=d.base_scale, turning_step=d.turning_step)
    js, ts = jsched.DiffusionSchedule.create(**kw), tsched.DiffusionSchedule.create(**kw)
    for f in dataclasses.fields(js):
        np.testing.assert_array_equal(getattr(js, f.name), getattr(ts, f.name))
    for steps, spacing in ((50, "uniform_trailing"), (3, "uniform_trailing"), (25, "uniform")):
        jd = jsched.DDIMSchedule.create(js, steps, eta=1.0, timestep_spacing=spacing)
        td = tsched.DDIMSchedule.create(ts, steps, eta=1.0, timestep_spacing=spacing)
        for f in dataclasses.fields(jd):
            np.testing.assert_array_equal(getattr(jd, f.name), getattr(td, f.name))


def test_schedule_tensor_helpers_match_jax():
    rng = np.random.default_rng(0)
    t = np.array([0.0, 1.0, 499.0, 999.0], np.float32)
    np.testing.assert_allclose(tsched.timestep_embedding(_t(t), 64).numpy(),
                               np.asarray(jsched.timestep_embedding(jnp.asarray(t), 64)),
                               atol=1e-5)
    cfg_v, text_v = rng.standard_normal((2, 3, 4, 5)), rng.standard_normal((2, 3, 4, 5))
    np.testing.assert_allclose(
        tsched.rescale_noise_cfg(_t(cfg_v), _t(text_v), 0.7).numpy(),
        np.asarray(jsched.rescale_noise_cfg(jnp.asarray(cfg_v, jnp.float32),
                                            jnp.asarray(text_v, jnp.float32), 0.7)),
        atol=1e-5)


# -- layers -----------------------------------------------------------------


@pytest.mark.parametrize("shape,silu,eps", [((2, 4, 6, 64), True, 1e-5), ((3, 5, 32), False, 1e-6)])
def test_group_norm_matches_jax(shape, silu, eps):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape) * 2 + 0.5
    w, b = 1 + 0.1 * rng.standard_normal(shape[-1]), 0.1 * rng.standard_normal(shape[-1])
    ref = jax_gn(jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32),
                 jnp.asarray(b, jnp.float32), eps=eps, with_silu=silu)
    got = tlayers.group_norm_silu(_t(x), _t(w), _t(b), eps=eps, with_silu=silu)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_ATOL)


def test_layer_norm_and_feedforward_match_jax():
    c = 32
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, c))
    ff = jlayers.FeedForward(c, dtype=jnp.float32)
    params = tp.fill_tree(jax.eval_shape(ff.init, jax.random.PRNGKey(0), jnp.zeros((2, 6, c))),
                          rng)
    w, b = 1 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c)
    ref = ff.apply(params, jnp.asarray(x, jnp.float32),
                   ln=(jnp.asarray(w, jnp.float32), jnp.asarray(b, jnp.float32)))
    tff = tlayers.FeedForward(c)
    ln = tlayers.LayerNormF32(c)
    with torch.no_grad():
        tff.load_state_dict(convert_tree(params))
        ln.weight.copy_(_t(w))
        ln.bias.copy_(_t(b))
        got = tff(_t(x), ln=ln)
        np.testing.assert_allclose(ln(_t(x)).numpy(),
                                   np.asarray(jlayers.layer_norm_f32(
                                       jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32),
                                       jnp.asarray(b, jnp.float32))), atol=F32_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_ATOL)


@pytest.mark.parametrize("hw", [(32, 64), (320, 512), (224, 224), (576, 1024)])
def test_clip_preprocess_matches_jax_resize(hw):
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, (1,) + hw + (3,)).astype(np.float32)
    ref = np.asarray(jax_clip_preprocess(jnp.asarray(img)))
    np.testing.assert_allclose(clip_preprocess(_t(img)).numpy(), ref, atol=F32_ATOL)


# -- the five submodels on viewcrafter_tiny -----------------------------------


@pytest.fixture(scope="module")
def tiny():
    """JAX and port engines in f32 and bf16 around one set of weights, plus
    inputs for every submodel."""
    params = tp.random_params("viewcrafter_tiny", seed=0)
    engs = {dt: tp.engines("viewcrafter_tiny", params, jdt, tdt)
            for dt, (jdt, tdt) in {"f32": (jnp.float32, torch.float32),
                                   "bf16": (jnp.bfloat16, torch.bfloat16)}.items()}
    cfg = engs["f32"][0].cfg
    rng = np.random.default_rng(4)
    t = cfg.video_length
    lat = cfg.diffusion.latent_size
    x = rng.standard_normal((1, t) + lat + (cfg.unet.in_channels,)).astype(np.float32)
    inputs = dict(
        x=np.concatenate([x, x]),  # two identical CFG branches: shared_prefix=2 holds
        ts=np.array([500.0, 500.0], np.float32),
        ctx=rng.standard_normal((2, 77 + 16, cfg.unet.context_dim)).astype(np.float32),
        frames=rng.uniform(-1, 1, (1, 2, cfg.height, cfg.width, 3)).astype(np.float32),
        z=rng.standard_normal((1, 2) + lat + (cfg.vae.z_channels,)).astype(np.float32),
        ids=tp.fixed_prompt_ids(3),
    )
    return params, engs, inputs


def _run(which, jeng, teng, params, inp):
    """(JAX output, port output) of one submodel as float32 numpy."""
    j = {
        "unet": lambda: jeng.unet.apply(params.unet, jnp.asarray(inp["x"]), jnp.asarray(inp["ts"]),
                                        jnp.asarray(inp["ctx"]), shared_prefix=2),
        "encode": lambda: jeng.encode_frames(params.vae, jnp.asarray(inp["frames"])),
        "decode": lambda: jeng.decode_latents(params.vae, jnp.asarray(inp["z"])),
        "text": lambda: jeng.text_context(params, jnp.asarray(inp["ids"])),
        "image": lambda: jeng.image_context(params, jnp.asarray(inp["frames"][:, 0])),
    }[which]()
    with torch.no_grad():
        t = {
            "unet": lambda: teng.unet(_t(inp["x"]), _t(inp["ts"]), _t(inp["ctx"]), shared_prefix=2),
            "encode": lambda: teng.encode_frames(_t(inp["frames"])),
            "decode": lambda: teng.decode_latents(_t(inp["z"])),
            "text": lambda: teng.text_context(torch.from_numpy(inp["ids"]).long()),
            "image": lambda: teng.image_context(_t(inp["frames"][:, 0])),
        }[which]()
    return np.asarray(j, np.float32), t.float().numpy()


@pytest.mark.parametrize("which", ["unet", "encode", "decode", "text", "image"])
def test_submodel_matches_jax(tiny, which):
    params, engs, inp = tiny
    j32, t32 = _run(which, *engs["f32"], params, inp)
    j16, t16 = _run(which, *engs["bf16"], params, inp)
    assert np.abs(j32).mean() > 1e-2  # non-zero weights: the output is not trivial
    assert tp.max_err(j32, t32) <= F32_ATOL
    yard = tp.max_err(j16, j32)
    assert tp.max_err(t16, j16) <= 2 * yard + 1e-2, (tp.max_err(t16, j16), yard)


def test_shared_prefix_dedup_is_output_identical(tiny):
    params, engs, inp = tiny
    teng = engs["f32"][1]
    with torch.no_grad():
        args = (_t(inp["x"]), _t(inp["ts"]), _t(inp["ctx"]))
        np.testing.assert_allclose(teng.unet(*args, shared_prefix=2).numpy(),
                                   teng.unet(*args, shared_prefix=1).numpy(), atol=1e-5)


# -- weights carried across ---------------------------------------------------


def test_from_jax_params_consumes_every_leaf_and_sets_every_parameter():
    params = tp.random_params("viewcrafter_tiny", seed=5)
    state = from_jax_params(params)
    eng = VideoDiffusionEngine(get_model_config("viewcrafter_tiny"), dtype=torch.float32,
                               device="cpu")
    for name in SUBMODELS:
        leaves = jax.tree_util.tree_leaves(getattr(params, name))
        port = getattr(eng, name).state_dict()
        assert len(leaves) == len(state[name])  # each leaf used exactly once
        assert set(state[name]) == set(port)  # every port parameter set, nothing extra
        for key, val in state[name].items():
            assert tuple(val.shape) == tuple(port[key].shape), key
    eng.load_params(state)
    assert all(bool((p != 0).any()) for n in SUBMODELS
               for p in getattr(eng, n).parameters())
