"""The UNet's relative-position bias and causal temporal attention against
the JAX package, on the CPU.

`UNet3D` at viewcrafter_tiny with `use_relative_position`, with
`use_causal_attention` and with both, the same seeded numpy weights on both
sides (the tables carried across by `convert`), one denoiser call each.

Tolerance, that of the UNet parity test in float32
(tests/test_torch_modules.py): atol 1e-4 on outputs of order 1, float32 on
both sides. The bf16 comparison of that test is not repeated here: the JAX
package's bf16 relative-position einsums (bf16 x bf16 -> f32 against a shared
table) do not run on XLA's CPU backend, and each JAX compile costs the suite
about 10 s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from viewcrafter_tpu.config import get_model_config as jax_model_config
from viewcrafter_tpu.models.unet3d import UNet3D as JaxUNet3D
from viewcrafter_tpu.models.unet3d import _gather_relative as jax_gather_relative
from viewcrafter_tpu_torch.config import get_model_config
from viewcrafter_tpu_torch.convert import convert_tree
from viewcrafter_tpu_torch.models.layers import cast_weights
from viewcrafter_tpu_torch.models.unet3d import UNet3D, _gather_relative, _temporal_attention

F32_ATOL = 1e-4
VARIANTS = {"relative_position": (True, False), "causal": (False, True), "both": (True, True)}


def _configs(rel: bool, causal: bool):
    flags = dict(use_relative_position=rel, use_causal_attention=causal)
    return (dataclasses.replace(jax_model_config("viewcrafter_tiny").unet, **flags),
            dataclasses.replace(get_model_config("viewcrafter_tiny").unet, **flags))


@pytest.fixture(scope="module")
def setup():
    """Inputs, and numpy weights for every leaf of the relative-position
    tree (the causal-only tree is the same without the tables)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 4, 4, 8, 8)).astype(np.float32)
    ts = np.array([500.0], np.float32)
    ctx = rng.standard_normal((1, 77 + 16, 64)).astype(np.float32)
    jcfg, _ = _configs(True, False)
    shapes = jax.eval_shape(JaxUNet3D(cfg=jcfg, dtype=jnp.float32).init, jax.random.PRNGKey(0),
                            jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))
    return tp.fill_tree(shapes, np.random.default_rng(0)), (x, ts, ctx)


def _without_tables(tree):
    if isinstance(tree, dict):
        return {k: _without_tables(v) for k, v in tree.items()
                if k not in ("rel_k_table", "rel_v_table")}
    return tree


def _run(variant, params, inputs):
    rel, causal = VARIANTS[variant]
    jcfg, tcfg = _configs(rel, causal)
    if not rel:
        params = _without_tables(params)
    j = jax.jit(JaxUNet3D(cfg=jcfg, dtype=jnp.float32).apply)(params, *map(jnp.asarray, inputs))
    model = UNet3D(tcfg, dtype=torch.float32)
    model.load_state_dict(convert_tree(params), strict=True)
    with torch.no_grad():
        t = model(*(torch.from_numpy(a) for a in inputs))
    return np.asarray(j, np.float32), t.float().numpy()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_unet_matches_jax(setup, variant):
    params, inputs = setup
    j32, t32 = _run(variant, params, inputs)
    assert np.abs(j32).mean() > 1e-2
    assert tp.max_err(j32, t32) <= F32_ATOL


def test_relative_position_tables_and_mask_take_effect():
    """The tables are float32 parameters of every temporal attention, kept
    float32 by `cast_weights`, gathered as the JAX package gathers them; the
    mask makes frame 0 independent of the later frames."""
    _, tcfg = _configs(True, True)
    model = UNet3D(tcfg, dtype=torch.bfloat16)
    cast_weights(model, torch.bfloat16)
    tables = {k: v for k, v in model.state_dict().items() if k.endswith(("rel_k_table",
                                                                          "rel_v_table"))}
    n_temporal = sum(k.endswith(".norm.weight") and "temporal" in k or k == "init_attn.norm.weight"
                     for k in model.state_dict())
    assert len(tables) == 4 * n_temporal  # attn1 and attn2, k and v
    assert all(v.dtype == torch.float32 and v.shape == (2 * tcfg.temporal_length + 1, 16)
               for v in tables.values())
    table = np.random.default_rng(1).standard_normal((9, 16)).astype(np.float32)
    for t in (3, 6, 11):
        np.testing.assert_array_equal(_gather_relative(torch.from_numpy(table), t, t, 4).numpy(),
                                      np.asarray(jax_gather_relative(jnp.asarray(table), t, t, 4)))

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 5, 3, 2, 8), generator=g) for _ in range(3))
    mask = torch.tril(torch.ones((5, 5), dtype=torch.bool))
    out = _temporal_attention(q, k, v, mask)
    k2, v2 = k.clone(), v.clone()
    k2[:, 1:], v2[:, 1:] = 0.0, 0.0  # later frames changed
    assert torch.allclose(_temporal_attention(q, k2, v2, mask)[:, 0], out[:, 0])
    unmasked = _temporal_attention(q, k, v)
    assert not torch.allclose(_temporal_attention(q, k2, v2)[:, 0], unmasked[:, 0])
