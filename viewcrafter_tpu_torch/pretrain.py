"""Train steps for CroCo pretraining and DUSt3R two-view fine-tuning: the
port of the JAX package's pretrain.py, on the conventions of `training.py`.

- CroCo pretraining (extern/dust3r/croco/pretrain.py: the MaskedMSE
  criterion): `make_croco_pretrain_step`;
- DUSt3R fine-tuning (extern/dust3r/train.py: ConfLoss(Regr3D(L21)) over
  pairs and their swaps): `make_dust3r_train_step`, with the loss stack of
  `models/dust3r_losses.py`.

As in `training.make_train_step`: the train state holds float32 master
weights (`training.create_train_state`, which takes any of the port's
models), the module its dtype copy, refreshed after each update; the step
updates the state in place; `tx` is the port's `train_loop.AdamW` (optax's
`adamw(lr)` is `train_loop.adamw(lr)`). Each step returns the global
gradient norm before clipping beside what the JAX step returns.

The JAX CroCo step draws its mask inside the step from its key. Here the
mask is an argument, or is drawn for the whole batch from a
`torch.Generator`.

Under a mesh (dp over the batch; sp and tp stay 1): every rank passes the
whole batch and keeps its rows; each rank's loss is its share of the global
masked mean (the masked sums over its rows, divided by the whole batch's
count), so that the ranks' losses sum to the single-device loss; the
gradients are summed over every rank (`training.apply_gradients_`) and every
rank applies the same update. DUSt3R's per-sample normalizations and
medians stay within a rank's samples.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from viewcrafter_tpu_torch.models.croco_pretrain import (
    CroCoPretrain, masked_mse_loss, random_mask)
from viewcrafter_tpu_torch.models.dust3r import Dust3rModel
from viewcrafter_tpu_torch.models.dust3r_losses import conf_loss
from viewcrafter_tpu_torch.parallel import mesh as pm
from viewcrafter_tpu_torch.training import TrainState, apply_gradients_

VIEW_KEYS = ("img", "pts3d", "valid_mask", "camera_pose")
PARTS = ("conf_loss_1", "conf_loss_2", "regr3d_1", "regr3d_2")


def _dp_axis(mesh):
    """(the dp axis, the group the gradients are summed over) of `mesh`."""
    if mesh is None:
        return pm.NO_AXIS, None
    shape = pm.mesh_shape(mesh)
    if shape["sp"] != 1 or shape["tp"] != 1:
        raise ValueError(f"the pretraining steps shard over dp only, not {shape}")
    return pm.axis(mesh, "dp"), dist.group.WORLD


def _device(model) -> torch.device:
    return next(model.parameters()).device


def make_croco_pretrain_step(model: CroCoPretrain, tx, mesh=None):
    """The CroCo pretraining step: step(state, batch, mask=None,
    generator=None) -> (state, loss, grad_norm). Batch: img1, img2
    (B, H, W, 3) in [-1, 1]; img1 is masked and reconstructed. `mask`:
    (B, N) bool, exactly cfg.num_mask(N) True a row; else drawn for the
    whole batch from `generator` (`random_mask`). The loss is MaskedMSE
    with the model's cfg.norm_pix_loss (croco/pretrain.py:120-121)."""
    norm_pix = model.cfg.norm_pix_loss
    params = dict(model.named_parameters())
    dp, group = _dp_axis(mesh)
    checked = []

    def step(state: TrainState, batch: dict, mask: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None):
        device = _device(model)
        img1, img2 = batch["img1"].to(device), batch["img2"].to(device)
        b, h, w = img1.shape[:3]
        p = model.cfg.patch_size
        n = (h // p) * (w // p)
        num_mask = model.cfg.num_mask(n)
        if mask is None:
            if generator is None:
                raise ValueError("pass a mask, or a generator to draw one from")
            mask = random_mask(generator, b, n, num_mask)
        mask = mask.to(device)
        count = None
        if group is not None:
            if not checked:  # every rank must start from the same weights
                pm.assert_replicated(state.params.values())
                checked.append(True)
            img1, img2, mask = dp.local(img1, 0), dp.local(img2, 0), dp.local(mask, 0)
            count = torch.tensor(float(b * num_mask), device=device)
        with torch.enable_grad():
            with record_function("train_step.forward"):
                pred, mask, target = model(img1, img2, mask=mask)
                loss = masked_mse_loss(pred, mask, target, norm_pix_loss=norm_pix, count=count)
            loss.backward()
        with record_function("train_step.optimizer"):
            grad_norm = apply_gradients_(model, params, state, tx, group)
            loss = loss.detach() if group is None else pm.all_reduce_sum(loss.detach(), group)
        state.step += 1
        return state, loss, grad_norm

    return step


def make_dust3r_train_step(model: Dust3rModel, tx, mesh=None, alpha: float = 0.2,
                           mode: str = "plain", symmetrized: bool = False):
    """The DUSt3R fine-tuning step, ConfLoss(Regr3D) over a two-view batch:
    step(state, batch) -> (state, loss, parts, grad_norm). Batch: gt1 and
    gt2 dicts with img (B, H, W, 3) in [-1, 1], pts3d (B, H, W, 3) in the
    world frame, valid_mask (B, H, W) and camera_pose (B, 4, 4) camera to
    world, the Co3dPairDataset layout (`collate_views`). `symmetrized` also
    runs the swapped pair and averages the two losses (the reference's
    pairs and their swaps in one batch); `parts` are the first direction's
    (extern/dust3r/train.py: ConfLoss(Regr3D(L21), alpha=0.2))."""
    params = dict(model.named_parameters())
    dp, group = _dp_axis(mesh)
    checked = []

    def pair_loss(gt1, gt2, counts):
        out = model(gt1["img"], gt2["img"])
        pred1 = {"pts3d": out["pts3d1"], "conf": out["conf1"]}
        pred2 = {"pts3d_in_other_view": out["pts3d2_in_view1"], "conf": out["conf2"]}
        return conf_loss(gt1, gt2, pred1, pred2, alpha=alpha, mode=mode, counts=counts)

    def step(state: TrainState, batch: dict):
        device = _device(model)
        gt1, gt2 = ({k: v[k].to(device) for k in VIEW_KEYS} for v in (batch["gt1"], batch["gt2"]))
        counts = None
        if group is not None:
            if not checked:
                pm.assert_replicated(state.params.values())
                checked.append(True)
            counts = tuple(g["valid_mask"].sum().float() for g in (gt1, gt2))
            gt1, gt2 = ({k: dp.local(v, 0) for k, v in g.items()} for g in (gt1, gt2))
        with torch.enable_grad():
            with record_function("train_step.forward"):
                total, parts = pair_loss(gt1, gt2, counts)
                if symmetrized:
                    total2, _ = pair_loss(gt2, gt1, None if counts is None else counts[::-1])
                    total = 0.5 * (total + total2)
            total.backward()
        with record_function("train_step.optimizer"):
            grad_norm = apply_gradients_(model, params, state, tx, group)
            both = torch.stack([total.detach()] + [parts[k].detach() for k in PARTS])
            if group is not None:
                both = pm.all_reduce_sum(both, group)
        state.step += 1
        return state, both[0], dict(zip(PARTS, both[1:])), grad_norm

    return step


def collate_views(views: Sequence[dict]) -> dict:
    """Stack Co3dPairDataset view dicts into a batched gt dict of CPU
    tensors (img, pts3d, valid_mask, camera_pose), dropping the other
    entries."""
    return {k: torch.as_tensor(np.stack([np.asarray(v[k]) for v in views])) for k in VIEW_KEYS}
