"""The slice end to end: `VideoDiffusionEngine.generate` of the port against
the JAX package on `viewcrafter_tiny`, 2 DDIM steps, K = 2 and K = 3 CFG.

The JAX engine draws its noise with jax.random; `torch_parity.jax_noise`
rebuilds those draws from the same key (split(rng, 3); the x_T key; a
fold_in of the sampling key per step; the per-frame split carry of
`encode_frames`) and hands them to the port's explicit-noise argument.
Every weight leaf is non-zero (numpy RNG).

Tolerances. float32 on both sides: the same math in another summation order,
amplified by CFG (scale 7.5) over the steps: atol 5e-3 on a video in [-1, 1]
(the observed gap is ~5e-4). bfloat16 on both sides: the port's bf16 video
must lie within twice the JAX package's own bf16-vs-f32 distance (plus 1e-2)
of the JAX bf16 video, as in test_torch_modules.py.

Prompt ids: fixed (`torch_parity.fixed_prompt_ids`, default_rng(0)), not
tokenized: without a BPE file the tokenizers hash words with Python's salted
`hash`, which would draw other ids, and another bf16 margin, in every process.
With these ids the bf16 error is 0.4824 against a limit of 0.8359
(2 x 0.4129 + 1e-2): err / limit = 0.577, the same under any PYTHONHASHSEED.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from viewcrafter_tpu.sampling.ddim import GuidanceConfig as JaxGuidance
from viewcrafter_tpu_torch.sampling.ddim import GuidanceConfig

STEPS = 2
GUIDANCE = {"k2": {}, "k3": {"cfg_img": 3.0}}


@pytest.fixture(scope="module")
def setup():
    params = tp.random_params("viewcrafter_tiny", seed=7)
    engs = {"f32": tp.engines("viewcrafter_tiny", params, jnp.float32, torch.float32),
            "bf16": tp.engines("viewcrafter_tiny", params, jnp.bfloat16, torch.bfloat16)}
    cfg = engs["f32"][0].cfg
    rng = np.random.default_rng(8)
    frames = rng.uniform(-1, 1, (1, cfg.video_length, cfg.height, cfg.width, 3)).astype(np.float32)
    ids, uids = tp.fixed_prompt_ids(6), tp.fixed_prompt_ids(0)
    return params, engs, cfg, frames, ids, uids, {}


def _generate(setup, dt, k):
    """(JAX video, port video) for dtype `dt` and guidance `k`, computed once
    per module."""
    params, engs, cfg, frames, ids, uids, cache = setup
    if (dt, k) in cache:
        return cache[dt, k]
    jeng, teng = engs[dt]
    key = jax.random.PRNGKey(11)
    ref = jeng.generate(params, jnp.asarray(frames), jnp.asarray(ids), jnp.asarray(uids), key,
                        steps=STEPS, guidance=JaxGuidance(**GUIDANCE[k]))
    noise = tp.jax_noise(key, frames.shape, STEPS, cfg.vae.z_channels,
                         cfg.vae.downsample_factor)
    got = teng.generate(torch.from_numpy(frames), torch.from_numpy(ids).long(),
                        torch.from_numpy(uids).long(), steps=STEPS,
                        guidance=GuidanceConfig(**GUIDANCE[k]), noise=noise)
    cache[dt, k] = np.asarray(ref, np.float32), got.numpy()
    return cache[dt, k]


@pytest.mark.parametrize("k", GUIDANCE)
def test_generate_matches_jax_f32(setup, k):
    ref, got = _generate(setup, "f32", k)
    assert got.shape == ref.shape == (1,) + setup[3].shape[1:]
    assert np.abs(ref).mean() > 1e-2
    assert tp.max_err(got, ref) <= 5e-3


def test_sequential_cfg_matches_batched(setup):
    """Sequential CFG (one UNet call per branch, no shared-prefix dedup)
    gives the batched result: the same math, f32 rounding apart."""
    params, engs, cfg, frames, ids, uids, _ = setup
    teng = engs["f32"][1]
    noise = tp.jax_noise(jax.random.PRNGKey(11), frames.shape, STEPS, cfg.vae.z_channels,
                         cfg.vae.downsample_factor)
    args = (torch.from_numpy(frames), torch.from_numpy(ids).long(), torch.from_numpy(uids).long())
    batched = teng.generate(*args, steps=STEPS, guidance=GuidanceConfig(), noise=noise)
    seq = teng.generate(*args, steps=STEPS, guidance=GuidanceConfig(sequential=True), noise=noise)
    assert tp.max_err(seq.numpy(), batched.numpy()) <= 1e-4


def test_generate_matches_jax_bf16(setup):
    ref32, _ = _generate(setup, "f32", "k2")
    ref16, got16 = _generate(setup, "bf16", "k2")
    yard = tp.max_err(ref16, ref32)
    assert np.isfinite(got16).all()
    assert tp.max_err(got16, ref16) <= 2 * yard + 1e-2, (tp.max_err(got16, ref16), yard)
