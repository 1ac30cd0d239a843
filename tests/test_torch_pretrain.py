"""DUSt3R and CroCo training in the port against the JAX package, on the
CPU: the losses, the CroCo model, one step of each train step, the CroCo
translator, and dp 2 on gloo ranks. Small configurations in float32
(`_dryrun.pretrain_configs`, those of tests/test_training_extras.py), the
JAX side on its XLA path (tests/conftest.py), every JAX weight leaf filled
from a seeded numpy generator (`torch_parity.fill_tree`) and carried across
with `convert`.

Tolerances, each with its reason:
  - the losses' values: rtol 1e-5 (float32 on both sides; the sums run in
    other orders); their gradients: 1e-6 of the largest, absolute;
  - the medians' gradient with ties: equal positions (both select the same
    element of a stable sort), values as above;
  - the CroCo forward: 1e-5 of the largest prediction, absolute; the target
    exactly (the same reshapes);
  - one train step: the loss rtol 1e-5; the gradients 2e-5 of the largest
    JAX gradient, absolute (as tests/test_torch_training.py); the weights
    after Adam's first step, where the JAX gradient is at least 1e-5,
    within 2e-3 of the learning rate, and everywhere within 2.1 x lr (Adam's
    first step moves a weight by about lr times the sign of its gradient,
    so a gradient at rounding noise may flip it);
  - dp 2 on 2 gloo ranks: the first step's loss within rtol 2e-5 of the
    single device (the JAX dry run's bound; `_dryrun.pretrain_dryrun`);
  - the translator: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity as tp
from viewcrafter_tpu.config import Dust3rConfig as JaxDust3rConfig
from viewcrafter_tpu.models import dust3r_losses as jl
from viewcrafter_tpu.models.croco_pretrain import CroCoPretrain as JaxCroCo
from viewcrafter_tpu.models.croco_pretrain import CroCoPretrainConfig as JaxCroCoConfig
from viewcrafter_tpu.models.croco_pretrain import masked_mse_loss as jax_masked_mse
from viewcrafter_tpu.models.croco_pretrain import random_mask as jax_random_mask
from viewcrafter_tpu.models.dust3r import Dust3rModel as JaxDust3r
from viewcrafter_tpu.pretrain import collate_views as jax_collate_views
from viewcrafter_tpu.pretrain import make_croco_pretrain_step as jax_croco_step
from viewcrafter_tpu.pretrain import make_dust3r_train_step as jax_dust3r_step
from viewcrafter_tpu.training import TrainState as JaxTrainState
from viewcrafter_tpu.utils import checkpoint as jax_ckpt
from viewcrafter_tpu_torch import _dryrun
from viewcrafter_tpu_torch.convert import croco_pretrain_from_jax_params, dust3r_from_jax_params
from viewcrafter_tpu_torch.models import dust3r_losses as pl
from viewcrafter_tpu_torch.models.croco_pretrain import masked_mse_loss, random_mask
from viewcrafter_tpu_torch.pretrain import (
    collate_views, make_croco_pretrain_step, make_dust3r_train_step)
from viewcrafter_tpu_torch.train_loop import adamw
from viewcrafter_tpu_torch.training import create_train_state
from viewcrafter_tpu_torch.utils import checkpoint as port_ckpt

CFGS = _dryrun.pretrain_configs()
LR = _dryrun.PRETRAIN_LR
B = 2


def _jax_cfg(kind):
    fields = dataclasses.asdict(CFGS[kind])
    return JaxDust3rConfig(**fields) if kind == "dust3r" else JaxCroCoConfig(**fields)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- the losses ---------------------------------------------------------------


def _loss_inputs(seed=0, b=2, h=6, w=8, z_ties=False):
    """gt view dicts (random poses, ~80% valid) and predictions, every point
    away from the origin and from the gt (so that no norm is taken at 0)."""
    rng = np.random.default_rng(seed)

    def view(shift):
        pose = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
        pose[:, :3, 3] = rng.normal(size=(b, 3)) * 0.3 + shift
        return {"pts3d": (rng.normal(size=(b, h, w, 3)) + [0, 0, 3]).astype(np.float32),
                "camera_pose": pose, "valid_mask": rng.uniform(size=(b, h, w)) > 0.2}

    gt1, gt2 = view(0.0), view(0.5)
    preds = [(rng.normal(size=(b, h, w, 3)) + [0, 0, 2]).astype(np.float32) for _ in range(2)]
    if z_ties:  # a few depths only: the medians fall on tied values
        for p in preds:
            p[..., 2] = np.round(p[..., 2] * 2) / 2
    confs = [(1 + rng.uniform(size=(b, h, w))).astype(np.float32) for _ in range(2)]
    return gt1, gt2, preds, confs


def _jax_loss(gt1, gt2, mode):
    jgt1 = {k: jnp.asarray(v) for k, v in gt1.items()}
    jgt2 = {k: jnp.asarray(v) for k, v in gt2.items()}

    def f(p1, p2, c1, c2):
        total, parts = jl.conf_loss(jgt1, jgt2, {"pts3d": p1, "conf": c1},
                                    {"pts3d_in_other_view": p2, "conf": c2}, mode=mode)
        return total, parts

    return f


def _port_loss(gt1, gt2, mode, p1, p2, c1, c2):
    tgt1 = {k: torch.from_numpy(np.asarray(v)) for k, v in gt1.items()}
    tgt2 = {k: torch.from_numpy(np.asarray(v)) for k, v in gt2.items()}
    return pl.conf_loss(tgt1, tgt2, {"pts3d": p1, "conf": c1},
                        {"pts3d_in_other_view": p2, "conf": c2}, mode=mode)


def _check_loss_and_grads(gt1, gt2, preds, confs, mode):
    inputs = [*preds, *confs]
    (jtotal, jparts), jgrads = jax.value_and_grad(_jax_loss(gt1, gt2, mode), argnums=(0, 1, 2, 3),
                                                  has_aux=True)(*map(jnp.asarray, inputs))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    total, parts = _port_loss(gt1, gt2, mode, *leaves)
    grads = torch.autograd.grad(total, leaves)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]), rtol=1e-5, err_msg=k)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jgrads)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6 * scale, rtol=0,
                                   err_msg=f"input {i}")
    return grads, jgrads


@pytest.mark.parametrize("mode", pl.MODES)
def test_regr3d_and_conf_loss_match_jax(mode):
    """Per-pixel regr3d losses and masks, the ConfLoss total and its parts,
    and their gradients with respect to the predicted points and
    confidences, in each of the four modes."""
    gt1, gt2, preds, confs = _loss_inputs(seed=1)
    jgt = [{k: jnp.asarray(v) for k, v in g.items()} for g in (gt1, gt2)]
    ref = jl.regr3d_loss(*jgt, {"pts3d": jnp.asarray(preds[0])},
                         {"pts3d_in_other_view": jnp.asarray(preds[1])}, mode=mode)
    got = pl.regr3d_loss(*({k: torch.from_numpy(v) for k, v in g.items()} for g in (gt1, gt2)),
                         {"pts3d": torch.from_numpy(preds[0])},
                         {"pts3d_in_other_view": torch.from_numpy(preds[1])}, mode=mode)
    for g, r in zip(got, ref):
        if g.dtype == torch.bool:
            assert np.array_equal(g.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
    _check_loss_and_grads(gt1, gt2, preds, confs, mode)


def test_median_gradient_with_ties_matches_jax():
    """shift_inv on predicted depths with many exact ties: the joint median
    falls on a tied value, and the gradient reaches the same element in
    both packages (a stable sort's lower middle)."""
    gt1, gt2, preds, confs = _loss_inputs(seed=2, z_ties=True)
    z = np.concatenate([preds[0][..., 2].reshape(2, -1), preds[1][..., 2].reshape(2, -1)], 1)
    assert len(np.unique(z)) < z.size // 4  # ties everywhere
    grads, jgrads = _check_loss_and_grads(gt1, gt2, preds, confs, "shift_inv")
    for g, jg in zip(grads[:2], jgrads[:2]):
        assert np.array_equal(g[..., 2].numpy() != 0, np.asarray(jg)[..., 2] != 0)


@pytest.mark.parametrize("ties", [False, True])
def test_nanmedian_lower_is_torch_nanmedian(ties):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 40)).astype(np.float32)
    if ties:
        x = np.round(x)
    x[rng.uniform(size=x.shape) < 0.3] = np.nan
    t = torch.from_numpy(x)
    assert torch.equal(pl._nanmedian_lower(t, dim=1), torch.nanmedian(t, dim=1).values)
    np.testing.assert_array_equal(pl._nanmedian_lower(t, dim=1).numpy(),
                                  np.asarray(jl._nanmedian_lower(jnp.asarray(x), axis=1)))


def test_conf_loss_rewards_confidence_on_good_pixels():
    """The JAX package's case: a perfect prediction costs -alpha log(conf)
    per view; a corrupted one costs more."""
    gt1, gt2, _, _ = _loss_inputs(seed=4, b=1)
    for g in (gt1, gt2):
        g["camera_pose"] = np.eye(4, dtype=np.float32)[None]
        g["valid_mask"][:] = True
    conf = np.full((1, 6, 8), 2.0, np.float32)
    args = [torch.from_numpy(gt1["pts3d"]), torch.from_numpy(gt2["pts3d"]),
            torch.from_numpy(conf), torch.from_numpy(conf)]
    total, _ = _port_loss(gt1, gt2, "plain", *args)
    np.testing.assert_allclose(total.item(), -0.2 * np.log(2.0) * 2, atol=1e-4)
    args[1] = args[1] + 0.5
    assert _port_loss(gt1, gt2, "plain", *args)[0].item() > total.item()


# -- the CroCo model ----------------------------------------------------------


def _croco_weights():
    model = JaxCroCo(cfg=_jax_cfg("croco"), dtype=jnp.float32)
    b, (h, w) = B, CFGS["croco"].img_size
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((b, h, w, 3)),
                            jnp.zeros((b, h, w, 3)), rng=jax.random.PRNGKey(1))
    return model, tp.fill_tree(shapes, np.random.default_rng(0))


@pytest.fixture(scope="module")
def croco_forward():
    model, params = _croco_weights()
    batch = _dryrun.pretrain_batch("croco", CFGS["croco"], B)
    pred, mask, target = jax.jit(model.apply)(params, batch["img1"], batch["img2"],
                                              mask=jnp.asarray(batch["mask"]))
    return {"params": params, "batch": batch, "pred": np.array(pred),
            "mask": np.array(mask), "target": np.array(target)}


def test_croco_forward_matches_jax(croco_forward):
    model = _dryrun.pretrain_model("croco", CFGS["croco"], "cpu")
    model.load_state_dict(croco_pretrain_from_jax_params(_np_tree(croco_forward["params"])))
    batch = croco_forward["batch"]
    with torch.no_grad():
        pred, mask, target = model(torch.from_numpy(batch["img1"]), torch.from_numpy(batch["img2"]),
                                   mask=torch.from_numpy(batch["mask"]))
    ref = croco_forward["pred"]
    assert pred.shape == ref.shape and pred.dtype == torch.float32
    np.testing.assert_allclose(pred.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    assert np.array_equal(mask.numpy(), croco_forward["mask"])
    assert np.array_equal(target.numpy(), croco_forward["target"])


@pytest.mark.parametrize("norm_pix", [False, True])
def test_masked_mse_loss_matches_jax(croco_forward, norm_pix):
    f = croco_forward
    ref = float(jax_masked_mse(jnp.asarray(f["pred"]), jnp.asarray(f["mask"]),
                               jnp.asarray(f["target"]), norm_pix_loss=norm_pix))
    got = masked_mse_loss(*(torch.from_numpy(f[k]) for k in ("pred", "mask", "target")),
                          norm_pix_loss=norm_pix)
    np.testing.assert_allclose(got.item(), ref, rtol=1e-6)
    everywhere = masked_mse_loss(*(torch.from_numpy(f[k]) for k in ("pred", "mask", "target")),
                                 norm_pix_loss=norm_pix, masked=False)
    np.testing.assert_allclose(everywhere.item(), float(jax_masked_mse(
        jnp.asarray(f["pred"]), jnp.asarray(f["mask"]), jnp.asarray(f["target"]),
        norm_pix_loss=norm_pix, masked=False)), rtol=1e-6)


@pytest.mark.parametrize("n, num_mask", [(6, 3), (196, 176), (768, 100)])
def test_random_mask_draws_num_mask_a_row(n, num_mask):
    gen = torch.Generator().manual_seed(n)
    mask = random_mask(gen, 5, n, num_mask)
    assert mask.shape == (5, n) and mask.dtype == torch.bool
    assert (mask.sum(1) == num_mask).all()
    assert not torch.equal(mask[0], mask[1])  # rows draw apart
    again = random_mask(torch.Generator().manual_seed(n), 5, n, num_mask)
    assert torch.equal(mask, again)


# -- one train step against the JAX step --------------------------------------


def _recording(tx):
    """`tx` whose state also keeps the raw gradients of the last update."""
    return optax.GradientTransformation(
        lambda p: (jax.tree.map(jnp.zeros_like, p), tx.init(p)),
        lambda g, s, p=None: (lambda u, s2: (u, (g, s2)))(*tx.update(g, s[1], p)))


def _dust3r_batch():
    return _dryrun.pretrain_batch("dust3r", CFGS["dust3r"], B)


@pytest.fixture(scope="module")
def jax_steps():
    """One step of each JAX train step (optax.adamw(LR)) from seeded
    weights: the weights before and after, the loss and the raw
    gradients; the CroCo mask drawn from the step's key."""
    out = {}
    tx = _recording(optax.adamw(LR))

    def state_of(params):
        return JaxTrainState(params=params, opt_state=tx.init(params),
                             step=jnp.zeros((), jnp.int32))

    model, params = _croco_weights()
    batch = _dryrun.pretrain_batch("croco", CFGS["croco"], B)
    key = jax.random.PRNGKey(2)
    cfg = CFGS["croco"]
    n = (cfg.img_size[0] // cfg.patch_size) * (cfg.img_size[1] // cfg.patch_size)
    state, loss = jax_croco_step(model, tx)(
        state_of(params), {k: jnp.asarray(batch[k]) for k in ("img1", "img2")}, key)
    out["croco"] = {"params0": params, "batch": batch, "loss": float(loss),
                    "mask": np.asarray(jax_random_mask(key, B, n, cfg.num_mask(n))),
                    "grads": state.opt_state[0], "params1": state.params}

    jmodel = JaxDust3r(cfg=_jax_cfg("dust3r"), dtype=jnp.float32)
    batch = _dust3r_batch()
    jbatch = {g: jax_collate_views([{k: v[i] for k, v in batch[g].items()} for i in range(B)])
              for g in ("gt1", "gt2")}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jbatch["gt1"]["img"],
                            jbatch["gt2"]["img"])
    params = tp.fill_tree(shapes, np.random.default_rng(1))
    state, loss, parts = jax_dust3r_step(jmodel, tx, symmetrized=True)(state_of(params), jbatch)
    out["dust3r"] = {"params0": params, "batch": batch, "loss": float(loss),
                     "parts": {k: float(v) for k, v in parts.items()},
                     "grads": state.opt_state[0], "params1": state.params}
    return out


def _to_port(kind, tree):
    tree = _np_tree(tree)
    return dust3r_from_jax_params(tree) if kind == "dust3r" else croco_pretrain_from_jax_params(tree)


@pytest.mark.parametrize("kind", ["croco", "dust3r"])
def test_one_train_step_matches_jax(jax_steps, kind):
    """The loss, every gradient and every updated weight of one step; for
    DUSt3R (symmetrized) also the loss parts."""
    ref = jax_steps[kind]
    cfg = CFGS[kind]
    model = _dryrun.pretrain_model(kind, cfg, "cpu")
    tx = adamw(LR)
    state = create_train_state(model, cfg, _to_port(kind, ref["params0"]), tx)
    seen = {}
    for name, p in model.named_parameters():  # the gradients as the step takes them
        p.register_post_accumulate_grad_hook(lambda q, name=name: seen.__setitem__(
            name, q.grad.detach().clone()))
    if kind == "croco":
        out = make_croco_pretrain_step(model, tx)(
            state, {k: torch.from_numpy(ref["batch"][k]) for k in ("img1", "img2")},
            mask=torch.from_numpy(ref["mask"]))
    else:
        batch = {g: collate_views([{k: v[i] for k, v in ref["batch"][g].items()}
                                   for i in range(B)]) for g in ("gt1", "gt2")}
        out = make_dust3r_train_step(model, tx, symmetrized=True)(state, batch)
        for k, v in ref["parts"].items():
            np.testing.assert_allclose(out[2][k].item(), v, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(out[1].item(), ref["loss"], rtol=1e-5)
    assert state.step == 1 and np.isfinite(float(out[-1]))
    jgrads = _to_port(kind, ref["grads"])
    assert set(jgrads) == set(seen) == set(state.params)
    atol = 2e-5 * max(float(g.abs().max()) for g in jgrads.values())
    for name, g in jgrads.items():
        np.testing.assert_allclose(seen[name].numpy(), g.numpy(), atol=atol, rtol=0,
                                   err_msg=name)
    well = total = 0
    for name, w in _to_port(kind, ref["params1"]).items():
        err = (state.params[name] - w).abs()
        assert float(err.max()) <= 2.1 * LR, name
        sure = jgrads[name].abs() >= 1e-5
        if sure.any():
            assert float(err[sure].max()) <= 2e-3 * LR, name
        well, total = well + int(sure.sum()), total + sure.numel()
    assert well / total > 0.9
    for name, p in model.named_parameters():  # the module holds the new weights
        assert torch.equal(p, state.params[name])


@pytest.mark.parametrize("kind, steps", [("croco", 8), ("dust3r", 6)])
def test_train_step_learns(kind, steps):
    """The JAX package's "learns" checks: one batch (and for CroCo one
    mask) repeated, the loss falls."""
    cfg = CFGS[kind]
    batch = _dryrun.pretrain_batch(kind, cfg, B)
    run = _dryrun.pretrain_steps(kind, cfg, None, [batch] * steps)
    assert np.isfinite(run["loss"]).all()
    assert run["loss"][-1] < run["loss"][0], run["loss"]


def test_data_parallel_step_on_two_ranks():
    """dp 2 on 2 gloo CPU ranks (one spawn): the first step's DUSt3R and
    CroCo losses against the single-device step at rtol 2e-5
    (`_dryrun.pretrain_dryrun` raises beyond it)."""
    errs = _dryrun.pretrain_dryrun(2, timeout=240)
    assert set(errs) == {"dust3r", "croco"}
    assert all(e <= _dryrun.ATOL for e in errs.values())


# -- the CroCo translator -----------------------------------------------------


def test_map_croco_pretrain_matches_the_jax_translator():
    """One reference-layout dict (the port's seeded weights written under
    the reference CroCoNet's names): the port's map and the JAX translator
    (then `convert`) give the same state dict, which is the one written;
    every reference key is used; a missing key raises."""
    cfg = CFGS["croco"]
    state = _dryrun.seeded_weights("croco", cfg)
    ref = port_ckpt.croco_pretrain_to_reference(state, cfg)
    assert "patch_embed.proj.weight" in ref and "enc_blocks.0.attn.qkv.weight" in ref
    assert "dec_blocks.0.cross_attn.projq.weight" in ref and "mask_token" in ref
    got = port_ckpt.croco_pretrain_from_reference({"model": ref}, cfg)
    t = jax_ckpt.Translator({k: v.numpy() for k, v in ref.items()})
    jax_ckpt.map_croco_pretrain(t, cfg.enc_depth, cfg.dec_depth)
    assert t.used == set(ref)
    via_jax = croco_pretrain_from_jax_params(t.nested())
    assert set(got) == set(via_jax) == set(state)
    for k in state:
        assert torch.equal(got[k], via_jax[k]), k
        assert torch.equal(got[k], state[k]), k
    model = _dryrun.pretrain_model("croco", cfg, "cpu")
    model.load_state_dict(got, strict=True)
    with pytest.raises(ValueError, match="mask_token"):
        port_ckpt.croco_pretrain_from_reference(
            {k: v for k, v in ref.items() if k != "mask_token"}, cfg)
