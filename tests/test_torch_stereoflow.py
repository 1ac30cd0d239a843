"""The port's CroCo downstream stereo/flow suite against the JAX package, on
the CPU: the binocular model (stereo and flow heads) and the monocular
encoder, every loss and metric and the streaming accumulators, the tile
offsets, `jax.image.resize`'s cubic, `tiled_pred`, one train step and the
checkpoint translators. Small configurations in float32 (TINY, the
`TINY_CROCO` of tests/test_stereoflow_eval.py), every JAX weight leaf filled
from a seeded numpy generator (`torch_parity.fill_tree`) and carried across
with `convert.croco_downstream_from_jax_params`; every input seeded with
numpy.

Tolerances, each with its reason:
  - the models' outputs: 1e-5 of the largest output, absolute (float32 on
    both sides; the sums run in other orders);
  - the losses and per-batch metrics: rtol 1e-6 (float32 reductions of the
    same terms); the bad-pixel shares and the streaming accumulators'
    counts exactly (the same comparisons of the same float32 errors);
  - the tile offsets: exactly (numpy on both sides);
  - the cubic resize: 1e-5 of the largest value (the JAX einsum's float32
    sums against the port's two products);
  - `tiled_pred`: 1e-5 of the largest prediction and confidence (the model's
    own error, averaged); the tiled loss rtol 1e-5;
  - one train step: the loss rtol 1e-5; the gradients 2e-5 of the largest
    JAX gradient, absolute (as tests/test_torch_pretrain.py); the weights
    after Adam's first step within 2e-3 of the learning rate where the JAX
    gradient is at least 1e-5, and everywhere within 2.1 x lr;
  - the translators: exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity as tp
from viewcrafter_tpu.models import croco_downstream as jcd
from viewcrafter_tpu.stereoflow import criterion as jcrit
from viewcrafter_tpu.stereoflow import engine as jeng
from viewcrafter_tpu.utils import checkpoint as jax_ckpt
from viewcrafter_tpu_torch.convert import croco_downstream_from_jax_params
from viewcrafter_tpu_torch.models import croco_downstream as pcd
from viewcrafter_tpu_torch.ops.resize import resize_cubic
from viewcrafter_tpu_torch.stereoflow import criterion as pcrit
from viewcrafter_tpu_torch.stereoflow import engine as peng
from viewcrafter_tpu_torch.train_loop import AdamW, constant_schedule
from viewcrafter_tpu_torch.training import create_train_state
from viewcrafter_tpu_torch.utils import checkpoint as port_ckpt

TINY = dict(
    img_size=(32, 64), patch_size=16, enc_embed_dim=32, enc_depth=2,
    enc_num_heads=2, dec_embed_dim=32, dec_depth=8, dec_num_heads=2,
    dpt_layer_dims=(8, 16, 24, 32), dpt_feature_dim=16,
    dpt_last_dim=8, hooks_idx=(1, 4, 7, 9),
)
MONO = dict(TINY, hooks_idx=None, enc_depth=4)  # hooks 0..3 of 4 encoder blocks
LR = 1e-3
# the models: (JAX class, port class, config fields, num_channels)
KINDS = {"stereo": (jcd.CroCoDownstreamBinocular, pcd.CroCoDownstreamBinocular, TINY, 2),
         "flow": (jcd.CroCoDownstreamBinocular, pcd.CroCoDownstreamBinocular, TINY, 3),
         "mono": (jcd.CroCoDownstreamMonocularEncoder, pcd.CroCoDownstreamMonocularEncoder,
                  MONO, 2)}


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _images(seed, b=2, h=32, w=64):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, w, 3)) * 0.5).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def models():
    """Per kind: the JAX model (float32), its seeded weights, the port model
    (float32) holding them, and both configs."""
    out = {}
    for i, (kind, (jcls, pcls, fields, nch)) in enumerate(KINDS.items()):
        jcfg = jcd.CroCoDownstreamConfig(num_channels=nch, **fields)
        pcfg = pcd.CroCoDownstreamConfig(**dataclasses.asdict(jcfg))
        jmodel = jcls(cfg=jcfg, dtype=jnp.float32)
        z = jnp.zeros((1, 32, 64, 3))
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *((z,) if kind == "mono"
                                                                      else (z, z)))
        params = tp.fill_tree(shapes, np.random.default_rng(10 + i))
        pmodel = pcls(pcfg, dtype=torch.float32).eval()
        pmodel.load_state_dict(croco_downstream_from_jax_params(_np_tree(params)), strict=True)
        out[kind] = {"jmodel": jmodel, "params": params, "pmodel": pmodel, "jcfg": jcfg,
                     "pcfg": pcfg, "apply": jax.jit(jmodel.apply)}
    return out


# -- the models -----------------------------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
def test_model_matches_jax(models, kind):
    """The binocular model with a stereo (1 + conf) and a flow (2 + conf)
    head, and the monocular encoder: the same weights, the same images."""
    m = models[kind]
    imgs = _images(1)[:1 if kind == "mono" else 2]
    ref = np.asarray(m["apply"](m["params"], *map(jnp.asarray, imgs)))
    with torch.no_grad():
        got = m["pmodel"](*map(torch.from_numpy, imgs))
    nch = KINDS[kind][3]
    assert got.shape == ref.shape == (2, 32, 64, nch) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_hooks_and_head_widths():
    assert pcd.default_hooks(24, 12) == jcd.default_hooks(24, 12) == (23, 27, 31, 35)
    for e, d in ((2, 8), (24, 12), (12, 24)):
        assert pcd.default_hooks(e, d) == jcd.default_hooks(e, d)
    cfg = pcd.CroCoDownstreamConfig()
    with torch.device("meta"):
        mono = pcd.CroCoDownstreamMonocularEncoder(cfg)
        bino = pcd.CroCoDownstreamBinocular(cfg)
    assert pcd.monocular_hooks(cfg) == (5, 11, 17, 23)
    assert mono.head.act1_proj.weight.shape[1] == mono.head.act4_proj.weight.shape[1] == 1024
    assert bino.head.act1_proj.weight.shape[1] == 1024  # the last encoder block
    assert bino.head.act4_proj.weight.shape[1] == 768  # the last decoder block
    assert bino.head.head_conv2.weight.shape[0] == 32 and bino.head.head_conv3.weight.shape[0] == 2
    # the head stays float32 in a bf16 model, the blocks do not
    assert bino.head.head_conv3.weight.dtype == torch.float32
    assert bino.enc_block_0.attn.qkv.weight.dtype == torch.bfloat16


# -- losses and metrics -----------------------------------------------------


def _gt(seed, c, b=2, h=6, w=8, scale=3.0):
    """gt with ~20% invalid pixels (+-inf in one or both channels) and a few
    large values (past max_gtnorm)."""
    rng = np.random.default_rng(seed)
    gt = (rng.standard_normal((b, h, w, c)) * scale).astype(np.float32)
    bad = rng.uniform(size=(b, h, w)) < 0.2
    gt[bad, 0] = np.inf
    gt[rng.uniform(size=(b, h, w)) < 0.05, -1] = -np.inf
    gt[0, 0, 0] = 40.0
    pred = (rng.standard_normal((b, h, w, c)) * scale).astype(np.float32)
    conf = rng.standard_normal((b, h, w)).astype(np.float32)
    return pred, gt, conf


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("name", list(pcrit.LOSSES))
@pytest.mark.parametrize("max_gtnorm", [None, 10.0])
def test_losses_match_jax(name, c, max_gtnorm):
    """Each loss, on stereo (1) and flow (2) channels, with non-finite gt,
    with and without max_gtnorm; its value and its gradients with respect
    to the prediction and the confidence."""
    pred, gt, conf = _gt(3 + c, c)
    kw = {} if max_gtnorm is None else {"max_gtnorm": max_gtnorm}
    jf, pf = jcrit.LOSSES[name], pcrit.LOSSES[name]
    if pcrit.WITH_CONF[name]:
        ref, jgrads = jax.value_and_grad(lambda p, q: jf(p, jnp.asarray(gt), q, **kw),
                                         argnums=(0, 1))(jnp.asarray(pred), jnp.asarray(conf))
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (pred, conf)]
        got = pf(leaves[0], torch.from_numpy(gt), leaves[1], **kw)
    else:
        ref, jgrads = jax.value_and_grad(lambda p: jf(p, jnp.asarray(gt), **kw),
                                         argnums=(0,))(jnp.asarray(pred))
        leaves = [torch.from_numpy(pred).requires_grad_(True)]
        got = pf(leaves[0], torch.from_numpy(gt), **kw)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    for g, jg in zip(torch.autograd.grad(got, leaves), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(np.asarray(jg)).max()))


@pytest.mark.parametrize("c", [1, 2])
def test_batch_metrics_match_jax(c):
    pred, gt, _ = _gt(5, c, b=3)
    jf, pf = (jcrit.stereo_metrics, pcrit.stereo_metrics) if c == 1 else (
        jcrit.flow_metrics, pcrit.flow_metrics)
    ref = jf(jnp.asarray(pred), jnp.asarray(gt))
    got = pf(torch.from_numpy(pred), torch.from_numpy(gt))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("c", [1, 2])
def test_dataset_metrics_match_jax(c):
    """Three batches streamed, one of them with no valid pixel; flow's
    speed bins all populated (gt up to ~60)."""
    jm = jcrit.StereoDatasetMetrics() if c == 1 else jcrit.FlowDatasetMetrics()
    pm = pcrit.StereoDatasetMetrics() if c == 1 else pcrit.FlowDatasetMetrics()
    for seed in range(3):
        pred, gt, _ = _gt(20 + seed, c, scale=20.0)
        if seed == 1:
            gt[:] = np.inf
        jm.add_batch(jnp.asarray(pred), jnp.asarray(gt))
        pm.add_batch(torch.from_numpy(pred), torch.from_numpy(gt))
    assert pm.agg_n == jm.agg_n > 0 and pm.agg_nbad == jm.agg_nbad
    ref, got = jm.get_results(), pm.get_results()
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    if c == 2:
        assert all(n > 0 for n in pm.agg_n_speed) and pm.agg_n_speed == jm.agg_n_speed


# -- tiles and resizes ------------------------------------------------------


def test_overlapping_offsets_match_jax():
    for total in (32, 33, 48, 96, 97, 375, 436, 1024, 1242, 1272):
        for window in (32, 64, 352, 384, 704, 768):
            if window > total:
                continue
            for overlap in (0.0, 0.5, 0.7, 0.9):
                assert peng.overlapping_offsets(total, window, overlap) == \
                    jeng.overlapping_offsets(total, window, overlap), (total, window, overlap)
    assert peng.overlapping_offsets(1272, 768, 0.5) == [0, 252, 504]  # rounded half to even


@pytest.mark.parametrize("size, new", [((20, 30), (32, 64)), ((32, 64), (20, 30)),
                                       ((24, 40), (38, 64)), ((38, 64), (24, 40)),
                                       ((7, 9), (7, 20))])
@pytest.mark.parametrize("c", [1, 2, 3])
def test_resize_matches_jax(size, new, c):
    """`resize_cubic` against the JAX `_resize_img` (c = 3) and
    `_resize_stereo_or_flow` (c = 1, 2) up and
    down, an axis left unchanged in the last case."""
    x = np.random.default_rng(c).standard_normal((2, *size, c)).astype(np.float32)
    if c == 3:
        ref = np.asarray(jeng._resize_img(jnp.asarray(x), new))
        got = resize_cubic(torch.from_numpy(x), *new).numpy()
    else:
        ref = np.asarray(jeng._resize_stereo_or_flow(jnp.asarray(x), new))
        got = peng._resize_stereo_or_flow(torch.from_numpy(x), new).numpy()
    assert got.shape == ref.shape == (2, *new, c)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


TILED_CASES = {
    "conf_expsigmoid": dict(conf_mode="conf_expsigmoid_10_5"),
    "conf_expbeta": dict(conf_mode="conf_expbeta3"),
    "no_conf": dict(with_conf=False),
    "tile_batch": dict(tile_batch=3),
    "criterion": dict(criterion="laplacian_loss_bounded2"),
    "upscale": dict(size=(24, 40), criterion="laplacian_loss_bounded2"),
}


@pytest.mark.parametrize("case", list(TILED_CASES))
def test_tiled_pred_matches_jax(models, case):
    """`tiled_pred` through the stereo model at crop 32x64, overlap 0.5, on
    48x96 pairs (4 tiles), or on 24x40 pairs smaller than the crop (the
    cubic upscale to 38x64, 2 tiles, and the antialiased resize back): the
    prediction, the confidence map and the tiled loss."""
    m = models["stereo"]
    kw = dict(TILED_CASES[case])
    size = kw.pop("size", (48, 96))
    crit = kw.pop("criterion", None)
    imgs = _images(7, b=1, h=size[0], w=size[1])
    gt = np.abs(np.random.default_rng(8).standard_normal((1, *size, 1))).astype(np.float32) * 4
    gt[0, :3, :5] = np.inf
    common = dict(crop=(32, 64), overlap=0.5, **kw)
    ref = jeng.tiled_pred(lambda a, b: m["apply"](m["params"], a, b), *map(jnp.asarray, imgs),
                          jnp.asarray(gt), criterion=getattr(jcrit, crit) if crit else None,
                          **common)
    got = peng.tiled_pred(m["pmodel"], *map(torch.from_numpy, imgs), torch.from_numpy(gt),
                          criterion=getattr(pcrit, crit) if crit else None, **common)
    for g, r, name in zip(got[::2], ref[::2], ("pred", "conf")):
        r = np.asarray(r)
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 * np.abs(r).max(), rtol=0, err_msg=name)
    assert got[0].shape == (1, *size, 2 if kw.get("with_conf") is False else 1)
    if crit:
        np.testing.assert_allclose(got[1].item(), float(ref[1]), rtol=1e-5)
    else:
        assert got[1] is None and ref[1] is None


# -- one train step -----------------------------------------------------------


def _recording(tx):
    """`tx` whose state also keeps the raw gradients of the last update."""
    return optax.GradientTransformation(
        lambda p: (jax.tree.map(jnp.zeros_like, p), tx.init(p)),
        lambda g, s, p=None: (lambda u, s2: (u, (g, s2)))(*tx.update(g, s[1], p)))


@pytest.fixture(scope="module")
def jax_step(models):
    """One JAX `train_step` (optax.adam(LR), laplacian_loss_bounded2) from
    the stereo model's weights, and the gradients it took."""
    m = models["stereo"]
    img1, img2 = _images(11, b=2)
    gt = (np.random.default_rng(12).standard_normal((2, 32, 64, 1)) * 3).astype(np.float32)
    gt[:, :4] = np.inf
    opt = _recording(optax.adam(LR))
    step = jax.jit(jeng.train_step, static_argnums=(0, 3, 7, 8))
    params1, opt_state, loss = step(m["jmodel"], m["params"], opt.init(m["params"]), opt,
                                    *map(jnp.asarray, (img1, img2, gt)),
                                    jcrit.laplacian_loss_bounded2, True)
    return {"inputs": (img1, img2, gt), "loss": float(loss), "grads": opt_state[0],
            "params1": params1}


def test_one_train_step_matches_jax(models, jax_step):
    """`make_stereoflow_train_step` with the port's AdamW at optax.adam's
    settings: the loss, every gradient and every updated weight."""
    m, ref = models["stereo"], jax_step
    model = pcd.CroCoDownstreamBinocular(m["pcfg"], dtype=torch.float32)
    tx = AdamW(constant_schedule(LR), grad_clip=float("inf"), weight_decay=0.0)
    state = create_train_state(model, m["pcfg"],
                               croco_downstream_from_jax_params(_np_tree(m["params"])), tx)
    seen = {}
    for name, p in model.named_parameters():
        p.register_post_accumulate_grad_hook(lambda q, name=name: seen.__setitem__(
            name, q.grad.detach().clone()))
    step = peng.make_stereoflow_train_step(model, tx, pcrit.laplacian_loss_bounded2, True)
    _, loss, grad_norm = step(state, *map(torch.from_numpy, ref["inputs"]))
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    assert state.step == 1 and np.isfinite(float(grad_norm))
    jgrads = croco_downstream_from_jax_params(_np_tree(ref["grads"]))
    assert set(jgrads) == set(seen) == set(state.params)
    atol = 2e-5 * max(float(g.abs().max()) for g in jgrads.values())
    for name, g in jgrads.items():
        np.testing.assert_allclose(seen[name].numpy(), g.numpy(), atol=atol, rtol=0, err_msg=name)
    np.testing.assert_allclose(float(grad_norm), float(np.sqrt(sum(
        float((g.double() ** 2).sum()) for g in jgrads.values()))), rtol=1e-5)
    well = total = 0
    for name, w in croco_downstream_from_jax_params(_np_tree(ref["params1"])).items():
        err = (state.params[name] - w).abs()
        assert float(err.max()) <= 2.1 * LR, name
        sure = jgrads[name].abs() >= 1e-5
        if sure.any():
            assert float(err[sure].max()) <= 2e-3 * LR, name
        well, total = well + int(sure.sum()), total + sure.numel()
    assert well / total > 0.9
    for name, p in model.named_parameters():
        assert torch.equal(p, state.params[name])


# -- the checkpoint translators ---------------------------------------------


@pytest.mark.parametrize("kind", ["stereo", "mono"])
def test_translators_round_trip_through_jax(models, kind):
    """JAX params -> the port (`convert`) -> `croco_downstream_to_reference`
    -> the JAX `translate_croco_downstream_checkpoint`: the JAX params,
    exactly; the port's own map back gives the port's state dict; a missing
    key raises with its name."""
    m = models[kind]
    mono = kind == "mono"
    state = croco_downstream_from_jax_params(_np_tree(m["params"]))
    ref = port_ckpt.croco_downstream_to_reference(state, m["pcfg"], monocular=mono)
    assert "head.dpt.act_postprocess.0.1.weight" in ref and "enc_blocks.0.attn.qkv.weight" in ref
    assert ("dec_blocks.0.cross_attn.projq.weight" in ref) != mono
    back = jax_ckpt.translate_croco_downstream_checkpoint(
        {"model": {k: v.numpy() for k, v in ref.items()}}, m["jcfg"], monocular=mono)
    want = jax.tree_util.tree_leaves_with_path(_np_tree(m["params"]))
    have = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(want) == len(have)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(have[path]), leaf, err_msg=str(path))
    got = port_ckpt.croco_downstream_from_reference({"model": ref}, m["pcfg"], monocular=mono)
    assert set(got) == set(state) and all(torch.equal(got[k], state[k]) for k in state)
    with pytest.raises(ValueError, match="head.dpt.head.4.weight"):
        port_ckpt.croco_downstream_from_reference(
            {k: v for k, v in ref.items() if k != "head.dpt.head.4.weight"}, m["pcfg"],
            monocular=mono)
