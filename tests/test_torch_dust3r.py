"""The port's DUSt3R and its ops against the JAX package.

Inputs come from numpy seeds; weights are the JAX model's seeded init with
every leaf perturbed by N(0, 0.02^2) (so no bias is zero), carried across
with `convert.dust3r_from_jax_params`. The JAX side runs as its own tests
run it (VIEWCRAFTER_ATTN_IMPL=xla, tests/conftest.py), so both sides take
the plain attention on the CPU.

Tolerances:
  - rope2d and both resizes: 1e-6 (the same float32 arithmetic); the
    antialiased downsample 1e-4 (torch's and XLA's kernel weights summed in
    another order).
  - the network in float32 on both sides (dust3r_tiny, 48x64 input so the
    DPT head crops an odd grid): 1e-4 of the largest magnitude of each
    output (float32 sums in another order, amplified by expm1).
  - the network in bf16 on both sides: within twice the JAX package's own
    bf16-vs-float32 distance, plus 1e-2, each relative to the largest
    magnitude of the float32 output.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from viewcrafter_tpu.config import get_dust3r_config as jax_dust3r_config
from viewcrafter_tpu.models import dust3r as jd
from viewcrafter_tpu.ops.resize import resize_bilinear as jax_resize
from viewcrafter_tpu.ops.resize import resize_bilinear_align_corners as jax_resize_ac
from viewcrafter_tpu.ops.rope2d import rope_2d as jax_rope
from viewcrafter_tpu_torch.config import get_dust3r_config
from viewcrafter_tpu_torch.convert import dust3r_from_jax_params
from viewcrafter_tpu_torch.models import dust3r as td
from viewcrafter_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_align_corners
from viewcrafter_tpu_torch.ops.rope2d import rope_2d

H, W = 48, 64
OUT_KEYS = ("pts3d1", "conf1", "pts3d2_in_view1", "conf2")


def _rel(got, ref, scale=None) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref if scale is None else scale)))


# -- ops --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope2d_matches_jax(dtype):
    rng = np.random.default_rng(0)
    tokens = rng.standard_normal((2, 24, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 40, (2, 24, 2))
    ref = jax_rope(jnp.asarray(tokens, dtype), jnp.asarray(pos), 100.0)
    got = rope_2d(torch.from_numpy(tokens).to(getattr(torch, dtype)), torch.from_numpy(pos), 100.0)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got.float().numpy(), np.asarray(ref, np.float32)) <= 1e-6


@pytest.mark.parametrize("shape,out", [((2, 5, 7, 3), (10, 14)), ((1, 4, 6, 8), (3, 11)),
                                       ((1, 1, 5, 2), (4, 1))])
def test_resize_align_corners_matches_jax(shape, out):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref = jax_resize_ac(jnp.asarray(x), *out)
    got = resize_bilinear_align_corners(torch.from_numpy(x), *out)
    assert got.shape == ref.shape
    assert _rel(got.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("shape,out", [((4, 36, 64, 3), (72, 128)), ((2, 9, 16, 3), (18, 32)),
                                       ((1, 8, 8, 3), (8, 8))])
def test_resize_bilinear_upsample_matches_jax_image_resize(shape, out):
    """The pipeline's 2x render upsample (and the identity): torch's clamped
    half-pixel coordinate against jax.image.resize's renormalised border
    weights."""
    x = np.random.default_rng(2).uniform(0, 1, shape).astype(np.float32)
    ref = jax_resize(jnp.asarray(x), *out)
    got = resize_bilinear(torch.from_numpy(x), *out)
    assert got.shape == ref.shape
    assert _rel(got.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("shape,out", [((1, 576, 1024, 3), (288, 512)),
                                       ((2, 96, 128, 3), (40, 56)),
                                       ((1, 576, 1024, 3), (320, 512)),
                                       ((1, 8, 20, 3), (16, 7)),
                                       ((1, 8, 8, 3), (4, 4))])
def test_resize_bilinear_downsample_matches_jax_image_resize(shape, out):
    """The antialiased downsample (the fourth case shrinks one axis and
    grows the other) against jax.image.resize: within 1e-4. It is not the
    aliased bilinear sampling that torch's F.interpolate does by default
    (two source pixels per output pixel, whatever the scale): it widens the
    kernel by the scale, as jax.image.resize does."""
    x = np.random.default_rng(5).uniform(-1, 1, shape).astype(np.float32)
    ref = jax_resize(jnp.asarray(x), *out)
    got = resize_bilinear(torch.from_numpy(x), *out)
    assert got.shape == ref.shape
    assert _rel(got.numpy(), ref) <= 1e-4
    aliased = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=out, mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1)
    assert _rel(got.numpy(), aliased.numpy()) > 1e-2


def test_resize_to_dust3r_matches_jax():
    """A generated frame in [-1, 1] taken down to DUSt3R's size, as the
    iterative modes do: against the JAX package's `resize_to_dust3r`."""
    from viewcrafter_tpu.utils.io import resize_to_dust3r as jax_resize_to_dust3r
    from viewcrafter_tpu_torch.utils.io import resize_to_dust3r

    frame = np.random.default_rng(6).uniform(-1, 1, (576, 1024, 3)).astype(np.float32)
    got = resize_to_dust3r(frame, hw=(288, 512), device="cpu")
    ref = jax_resize_to_dust3r(frame, hw=(288, 512))
    assert isinstance(got, np.ndarray) and got.shape == ref.shape == (288, 512, 3)
    assert _rel(got, ref) <= 1e-4


@pytest.mark.parametrize("cin,cout,k", [(8, 8, 4), (6, 10, 4), (8, 8, 2), (12, 5, 2)])
def test_conv_transpose_mapping(cin, cout, k):
    """flax ConvTranspose (kernel (k, k, in, out), not flipped) -> torch's
    ConvTranspose2d (in, out, k, k) with both spatial axes flipped, at
    in = out (where the Conv rule's weight has the right shape) and in !=
    out; the Conv rule must fail the same check."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 5, cin)).astype(np.float32)
    layer = fnn.ConvTranspose(cout, (k, k), strides=(k, k), dtype=jnp.float32)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(
        np.float32), layer.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = np.asarray(layer.apply(params, jnp.asarray(x)))
    module = td.ConvTranspose(cin, cout, k, stride=k)
    state = dust3r_from_jax_params({"act1_up": params["params"]})
    module.load_state_dict({n.split(".", 1)[1]: v for n, v in state.items()})
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 3 * k, 5 * k, cout)
    assert _rel(got, ref) <= 1e-5
    if cin == cout:  # the generic Conv rule maps a weight of the right shape
        wrong = dust3r_from_jax_params({"other": params["params"]})
        module.load_state_dict({n.split(".", 1)[1]: v for n, v in wrong.items()})
        with torch.no_grad():
            assert _rel(module(torch.from_numpy(x)).numpy(), ref) > 1e-2


# -- the network ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _weights(head_type: str = "dpt"):
    import dataclasses

    cfg = dataclasses.replace(jax_dust3r_config("dust3r_tiny"), head_type=head_type)
    x = jnp.zeros((1, H, W, 3))
    params = jax.jit(jd.Dust3rModel(cfg, dtype=jnp.float32).init)(jax.random.PRNGKey(0), x, x)
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), params)
    return cfg, params


def _images(b: int = 2, seed: int = 5):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (b, H, W, 3)).astype(np.float32) for _ in range(2)]


def _port(head_type: str, dtype):
    import dataclasses

    cfg = dataclasses.replace(get_dust3r_config("dust3r_tiny"), head_type=head_type)
    model = td.Dust3rModel(cfg, dtype=dtype)
    model.load_state_dict(dust3r_from_jax_params(_weights(head_type)[1]), strict=True)
    return model.eval()


def _jax_out(head_type, jdtype, img1, img2, **flags):
    cfg, params = _weights(head_type)
    apply = jax.jit(jd.Dust3rModel(cfg, dtype=jdtype).apply,
                    static_argnames=("is_portrait1", "is_portrait2"))
    out = apply(params, jnp.asarray(img1), jnp.asarray(img2), **flags)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


@torch.no_grad()
def _port_out(model, img1, img2, **flags):
    out = model(torch.from_numpy(img1), torch.from_numpy(img2), **flags)
    return {k: v.float().numpy() for k, v in out.items()}


@pytest.mark.parametrize("head_type", ["dpt", "linear"])
def test_dust3r_matches_jax_f32(head_type):
    img1, img2 = _images()
    ref = _jax_out(head_type, jnp.float32, img1, img2)
    got = _port_out(_port(head_type, torch.float32), img1, img2)
    for k in OUT_KEYS:
        assert got[k].shape == ref[k].shape
        assert _rel(got[k], ref[k]) <= 1e-4, (k, _rel(got[k], ref[k]))


def test_dust3r_parts_match_jax_f32():
    """The encoder, the decoder's per-depth outputs, and each head alone."""
    cfg, params = _weights()
    p = params["params"]
    model = _port("dpt", torch.float32)
    img1, img2 = _images()
    imgs = np.concatenate([img1, img2])
    tok, pos = jax.jit(jd.Dust3rEncoder(cfg, dtype=jnp.float32).apply)(
        {"params": p["encoder"]}, jnp.asarray(imgs))
    with torch.no_grad():
        ttok, tpos = model.encoder(torch.from_numpy(imgs))
    assert _rel(ttok.numpy(), tok) <= 1e-4 and np.array_equal(tpos.numpy(), np.asarray(pos))
    f1, f2 = np.split(np.asarray(tok), 2)
    p1, p2 = np.split(np.asarray(pos), 2)
    outs1, outs2 = jax.jit(jd.Dust3rDecoder(cfg, dtype=jnp.float32).apply)(
        {"params": p["decoder"]}, f1, p1, f2, p2)
    with torch.no_grad():
        touts1, touts2 = model.decoder(*map(torch.from_numpy, (f1, p1, f2, p2)))
    for a, b in zip(outs1 + outs2, touts1 + touts2):
        assert _rel(b.numpy(), a) <= 1e-4
    feats = [f1] + [np.asarray(o) for o in outs1[1:4]]  # the hooks [0, 2, 3, 4]
    for name in ("head1", "head2"):
        ref = jax.jit(jd.DPTHead(cfg).apply, static_argnums=(2, 3))({"params": p[name]}, feats,
                                                                     H, W)
        with torch.no_grad():
            got = getattr(model, name)([torch.from_numpy(f) for f in feats], H, W)
        assert _rel(got.numpy(), ref) <= 1e-4, name


def test_dust3r_matches_jax_bf16():
    img1, img2 = _images()
    ref32 = _jax_out("dpt", jnp.float32, img1, img2)
    ref16 = _jax_out("dpt", jnp.bfloat16, img1, img2)
    got16 = _port_out(_port("dpt", torch.bfloat16), img1, img2)
    for k in OUT_KEYS:
        yard = _rel(ref16[k], ref32[k])
        err = _rel(got16[k], ref16[k], scale=ref32[k])
        assert np.isfinite(got16[k]).all()
        assert err <= 2 * yard + 1e-2, (k, err, yard)


@torch.no_grad()
def test_encode_decode_pairs_matches_call():
    """Encoding each image once and decoding gathered pairs gives what the
    two-view call gives for the same pairs."""
    model = _port("dpt", torch.float32)
    img1, img2 = _images()
    imgs = torch.from_numpy(np.concatenate([img1, img2]))  # images 0, 1 | 2, 3
    tokens, pos = model.encode(imgs)
    idx1, idx2 = torch.tensor([0, 1]), torch.tensor([2, 3])
    got = model.decode_pairs(tokens, pos, idx1, idx2, H, W)
    ref = model(torch.from_numpy(img1), torch.from_numpy(img2))
    for k in OUT_KEYS:
        assert _rel(got[k].numpy(), ref[k].numpy()) <= 1e-6


def test_portrait_batch_matches_jax():
    """A mixed ManyAR batch: per-image portrait flags on both views."""
    img1, img2 = _images()
    flags = dict(is_portrait1=None, is_portrait2=None)
    ref_l = _jax_out("dpt", jnp.float32, img1, img2, **flags)
    cfg, params = _weights()
    jm = jd.Dust3rModel(cfg, dtype=jnp.float32)
    f1, f2 = np.array([True, False]), np.array([False, True])
    ref = jax.jit(jm.apply)(params, jnp.asarray(img1), jnp.asarray(img2),
                            is_portrait1=jnp.asarray(f1), is_portrait2=jnp.asarray(f2))
    got = _port_out(_port("dpt", torch.float32), img1, img2, is_portrait1=torch.from_numpy(f1),
                    is_portrait2=torch.from_numpy(f2))
    for k in OUT_KEYS:
        assert _rel(got[k], np.asarray(ref[k])) <= 1e-4, k
    # the flags change the result (the portrait path really ran)
    assert _rel(got["pts3d1"], ref_l["pts3d1"]) > 1e-3
