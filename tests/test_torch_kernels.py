"""The port's four kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain twin (the kernel's arithmetic in
plain torch); the JAX side runs the Pallas kernel in interpret mode, as the
JAX package's own tests do. The same numpy inputs go to both.

Tolerances. float32 inputs: both sides compute in f32 with f32 sums, so they
differ by summation order only (and, for the FF layer, by the TPU kernel's
A&S erf polynomial, max error 1.5e-7): atol 2e-5. bfloat16 inputs: both
sides round at the same points (the kernels' own rounding points), so they
differ by at most a few bf16 ulps of values of order 1, from a different
summation order landing on the other side of a rounding boundary: atol 3e-2.
The gates are copies of the JAX package's and must agree on every shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viewcrafter_tpu.ops.pallas import ff_layer as jff
from viewcrafter_tpu.ops.pallas import fullkv_attention as jfa
from viewcrafter_tpu.ops.pallas import temporal_conv as jtc
from viewcrafter_tpu.ops.pallas import temporal_layer as jtl
from viewcrafter_tpu_torch.ops.kernels import ff_layer as tff
from viewcrafter_tpu_torch.ops.kernels import fullkv_attention as tfa
from viewcrafter_tpu_torch.ops.kernels import temporal_conv as ttc
from viewcrafter_tpu_torch.ops.kernels import temporal_layer as ttl

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _both(a: np.ndarray, jdt, tdt):
    """The same numbers as a JAX array and a torch tensor of one dtype."""
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _close(got: torch.Tensor, ref, atol: float):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=atol, rtol=0)


# (B, T, S, Cin, Cout): T = 1 and 2 put every shifted tap row past a frame
# edge; S = 144 is a frame that the kernel's row tiles cross. The first
# shape keeps the bare dtype as its id.
CONV_SHAPES = {"": (2, 5, 16, 64, 128), "-t1s16": (1, 1, 16, 16, 24), "-t2s144": (2, 2, 144, 24, 16),
               "-t5s144": (1, 5, 144, 16, 40), "-t1s144": (2, 1, 144, 8, 16)}


@pytest.mark.parametrize("dt,shape", [pytest.param(dt, shape, id=dt + name)
                                      for name, shape in CONV_SHAPES.items() for dt in DTYPES])
def test_temporal_conv3_matches_pallas(dt, shape):
    jdt, tdt, atol = DTYPES[dt]
    bsz, t, s, cin, cout = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((bsz, t, s, cin))
    w = rng.standard_normal((3, cin, cout)) * cin ** -0.5
    b = rng.standard_normal(cout) * 0.1
    (xj, xt), (wj, wt), (bj, bt) = _both(x, jdt, tdt), _both(w, jdt, tdt), _both(b, jnp.float32, torch.float32)
    ref = jtc.temporal_conv3(xj, wj, bj, interpret=True)
    rows = wt.permute(2, 0, 1).reshape(cout, 3 * cin)  # (3, Cin, Cout) -> (Cout, 3*Cin)
    _close(ttc.temporal_conv3(xt, rows, bt), ref, atol)


@pytest.mark.parametrize("dt,lead", [pytest.param(dt, lead, id=dt + name)  # N = 160 and 168 rows
                                     for name, lead in (("", (2, 5, 16)), ("-n168", (3, 7, 8)))
                                     for dt in DTYPES])
def test_ff_layer_matches_pallas(dt, lead):
    jdt, tdt, atol = DTYPES[dt]
    c, inner = 64, 256
    rng = np.random.default_rng(1)
    x = rng.standard_normal(lead + (c,)) * 0.5
    lns, lnb = 1 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c)
    w1 = rng.standard_normal((c, 2 * inner)) * c ** -0.5
    b1 = 0.1 * rng.standard_normal(2 * inner)
    w2 = rng.standard_normal((inner, c)) * inner ** -0.5
    b2 = 0.1 * rng.standard_normal(c)
    f32 = (jnp.float32, torch.float32)
    (xj, xt) = _both(x, jdt, tdt)
    (sj, st), (lj, lt) = _both(lns, *f32), _both(lnb, *f32)
    (w1j, w1t), (b1j, b1t), (w2j, w2t), (b2j, b2t) = (_both(a, jdt, tdt) for a in (w1, b1, w2, b2))
    ref = jff.fused_ff_layer(xj, sj, lj, w1j, b1j, w2j, b2j, interpret=True)
    got = tff.fused_ff_layer(xt, st, lt, w1t.t(), b1t, w2t.t(), b2t)
    _close(got, ref, atol)


@pytest.mark.parametrize("dt", DTYPES)
def test_fullkv_attention_matches_pallas(dt):
    jdt, tdt, atol = DTYPES[dt]
    rng = np.random.default_rng(2)
    (qj, qt), (kj, kt), (vj, vt) = (_both(rng.standard_normal((2, 128, 2, 64)), jdt, tdt)
                                    for _ in range(3))
    ref = jfa.fullkv_attention(qj, kj, vj, interpret=True)
    _close(tfa.fullkv_attention(qt, kt, vt), ref, atol)


# (B, T, S, heads, dim_head): T = 1 (a softmax over one key) and 25 (the
# flagship's frames), dim_head 128. The first shape keeps the bare dtype as
# its id.
LAYER_SHAPES = {"": (2, 5, 16, 2, 64), "-t1": (2, 1, 16, 2, 64), "-t25": (1, 25, 16, 2, 64),
                "-d128": (2, 5, 16, 1, 128)}


@pytest.mark.parametrize("dt,shape", [pytest.param(dt, shape, id=dt + name)
                                      for name, shape in LAYER_SHAPES.items() for dt in DTYPES])
def test_temporal_layer_matches_pallas(dt, shape):
    jdt, tdt, atol = DTYPES[dt]
    bsz, t, s, heads, d = shape
    c = heads * d
    rng = np.random.default_rng(3)
    x = rng.standard_normal((bsz, t, s, c)) * 0.5
    lns, lnb = 1 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c)
    wqkv = rng.standard_normal((c, 3 * c)) * c ** -0.5
    wo = rng.standard_normal((c, c)) * c ** -0.5
    bo = 0.1 * rng.standard_normal(c)
    f32 = (jnp.float32, torch.float32)
    (xj, xt) = _both(x, jdt, tdt)
    (sj, st), (lj, lt), (bj, bt) = _both(lns, *f32), _both(lnb, *f32), _both(bo, *f32)
    (wj, wt), (oj, ot) = _both(wqkv, jdt, tdt), _both(wo, jdt, tdt)
    ref = jtl.fused_temporal_layer(xj, sj, lj, wj, oj, bj, heads=heads, dim_head=d,
                                   interpret=True)
    got = ttl.fused_temporal_layer(xt, st, lt, wt.t(), ot.t(), bt, heads=heads, dim_head=d)
    _close(got, ref, atol)


def test_fullkv_plain_handles_ragged_keys():
    """The plain twin (and so the kernel it checks) keeps every key when Sk
    is not a multiple of any chunk: it equals exact softmax attention."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 40, 2, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 77, 2, 64)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 77, 2, 64)).astype(np.float32))
    ref = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / 8.0, -1)
    ref = torch.einsum("bhqk,bkhd->bqhd", ref, v)
    np.testing.assert_allclose(tfa.fullkv_attention(q, k, v).numpy(), ref.numpy(), atol=2e-5)


FLAGSHIP_SITES = [  # (B, T, S, C) at 576x1024x25 with K*B = 2 (ds1, ds2, ds4, ds8, init_attn)
    (2, 25, 9216, 320), (2, 25, 2304, 640), (2, 25, 576, 1280), (2, 25, 144, 1280),
    (2, 25, 9216, 512), (1, 4, 32, 32), (1, 4, 8, 64), (2, 40, 16, 128), (1, 5, 12, 64),
]


@pytest.mark.parametrize("shape", FLAGSHIP_SITES)
def test_gates_match_jax(shape):
    b, t, s, c = shape
    assert ttc.supports_fused(shape, c, c) == jtc.supports_fused(shape, c, c)
    assert tff.supports_fused_ff(shape, c, 4 * c) == jff.supports_fused_ff(shape, c, 4 * c)
    for d in (16, 64, 128):
        if c % d == 0:
            assert (ttl.supports_fused_layer(shape, c // d, d)
                    == jtl.supports_fused_layer(shape, c // d, d))
            q = (b * t, s, c // d, d)
            assert tfa.supports_fullkv(q, q) == jfa.supports_fullkv(q, q)
