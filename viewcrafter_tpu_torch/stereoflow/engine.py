"""Stereo/flow tiled inference and the training step: the port of the JAX
package's `stereoflow/engine.py`.

Parity target: extern/dust3r/croco/stereoflow/engine.py:
  - tiled_pred (:179-264): the network on overlapping crops, the
    predictions averaged with confidence weights; crop offsets by linspace
    (_overlapping :267-271); the weight modes 'conf_expsigmoid_B_S'
    (w = exp(-B * 2 * (sigmoid(c / S) - 0.5))) and 'conf_expbetaB'
    (w = exp(-B * c)) (:206-211, 239-244);
  - train_one_epoch (:25-98): forward, split the confidence, the criterion,
    the update.

As in the JAX package every tile rides one batch axis through one forward
(the reference runs a forward per tile), `tile_batch` splitting it into
chunks; an image smaller than the crop is first upscaled with
`jax.image.resize`'s cubic (`ops.resize.resize_cubic`, not torch's bicubic)
and the prediction brought back to the original size with the same resize,
antialiased, its disparity or flow rescaled.

The train step follows `pretrain.py`: float32 master weights in a
`training.TrainState`, the module in its dtype, `training.apply_gradients_`
for the update; it returns the loss and the gradient norm before clipping.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from viewcrafter_tpu_torch.models.croco_downstream import split_prediction_conf
from viewcrafter_tpu_torch.ops.resize import resize_cubic
from viewcrafter_tpu_torch.training import TrainState, apply_gradients_


def overlapping_offsets(total: int, window: int, overlap: float = 0.5) -> List[int]:
    """Crop start offsets: 1 + ceil((total - window) / ((1 - overlap) *
    window)) windows spread by linspace over [0, total - window], rounded
    half to even as numpy rounds (engine.py:267-271)."""
    assert total >= window and 0 <= overlap < 1, (total, window, overlap)
    num_windows = 1 + int(np.ceil((total - window) / ((1 - overlap) * window)))
    return np.linspace(0, total - window, num_windows).round().astype(int).tolist()


def _parse_conf_mode(conf_mode: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The tile weight of a confidence map (engine.py:206-211, 239-244)."""
    if conf_mode.startswith("conf_expsigmoid_"):
        beta, betasigmoid = map(float, conf_mode[len("conf_expsigmoid_"):].split("_"))
        return lambda c: torch.exp(-beta * 2.0 * (torch.sigmoid(c / betasigmoid) - 0.5))
    if conf_mode.startswith("conf_expbeta"):
        beta = float(conf_mode[len("conf_expbeta"):])
        return lambda c: torch.exp(-beta * c)
    raise NotImplementedError(f"conf_mode {conf_mode} is not implemented")


def _resize_stereo_or_flow(data: torch.Tensor, new_size: Tuple[int, int]) -> torch.Tensor:
    """The resize, then the disparity or flow rescaled (engine.py:165-175):
    channel 0 with x, channel 1 (flow) with y."""
    assert data.shape[-1] in (1, 2)
    scale = [new_size[1] / float(data.shape[2]), new_size[0] / float(data.shape[1])]
    out = resize_cubic(data, *new_size)
    return out * out.new_tensor(scale[:data.shape[-1]])


@torch.no_grad()
def tiled_pred(apply_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               img1: torch.Tensor, img2: torch.Tensor, gt: Optional[torch.Tensor] = None, *,
               crop: Tuple[int, int] = (352, 704), overlap: float = 0.5,
               conf_mode: str = "conf_expsigmoid_10_5", with_conf: bool = True,
               criterion: Optional[Callable] = None, tile_batch: int = 0):
    """Overlapping-crop inference with confidence-weighted averaging.

    apply_fn: the model's forward (img1, img2) -> (N, ch, cw, C[+1]).
    img1 / img2: (B, H, W, 3) channels-last, on the model's device. Returns
    (pred (B, H, W, C) float32, the mean tiled loss or None, the weighted
    confidence map (B, H', W'), at the upscaled size H' x W' when the image
    was smaller than the crop). `tile_batch` > 0 runs the tiles in chunks of
    that many (bounding the activations); 0 runs them in one forward."""
    b, h, w, _ = img1.shape
    win_h, win_w = crop

    # upscale so that the crop fits (engine.py:195-204; the reference's
    # upscale factor uses W in both ratios, a slip the JAX package does not keep)
    do_change_scale = h < win_h or w < win_w
    if do_change_scale:
        upscale = max(win_w / w, win_h / h)
        original_size = (h, w)
        new_size = (round(h * upscale), round(w * upscale))
        img1, img2 = resize_cubic(img1, *new_size), resize_cubic(img2, *new_size)
        if gt is not None:
            gt = _resize_stereo_or_flow(gt, new_size)
        h, w = new_size

    offsets = [(sy, sx) for sy in overlapping_offsets(h, win_h, overlap)
               for sx in overlapping_offsets(w, win_w, overlap)]
    n_tiles = len(offsets)
    weight_fn = _parse_conf_mode(conf_mode)

    # every tile on one batch axis: (T * B, win_h, win_w, 3)
    t1 = torch.cat([img1[:, sy:sy + win_h, sx:sx + win_w] for sy, sx in offsets])
    t2 = torch.cat([img2[:, sy:sy + win_h, sx:sx + win_w] for sy, sx in offsets])
    if tile_batch and tile_batch < n_tiles:
        step = tile_batch * b
        raw = torch.cat([apply_fn(t1[i:i + step], t2[i:i + step])
                         for i in range(0, n_tiles * b, step)])
    else:
        raw = apply_fn(t1, t2)
    pred_t, conf_t = split_prediction_conf(raw.float(), with_conf)
    c_ch = pred_t.shape[-1]
    if conf_t is None:  # without a confidence the average is uniform
        conf_t = torch.zeros(pred_t.shape[:-1], dtype=torch.float32, device=pred_t.device)
    weights = weight_fn(conf_t)

    tiled_losses = []
    if criterion is not None and gt is not None:
        for ti, (sy, sx) in enumerate(offsets):
            gtc = gt[:, sy:sy + win_h, sx:sx + win_w]
            p = pred_t[ti * b:(ti + 1) * b]
            tiled_losses.append(criterion(p, gtc, conf_t[ti * b:(ti + 1) * b]) if with_conf
                                else criterion(p, gtc))

    dev = pred_t.device
    accu_pred = torch.zeros((b, h, w, c_ch), dtype=torch.float32, device=dev)
    accu_w = torch.full((b, h, w), 1e-16, dtype=torch.float32, device=dev)
    accu_c = torch.zeros((b, h, w), dtype=torch.float32, device=dev)
    for ti, (sy, sx) in enumerate(offsets):
        p = pred_t[ti * b:(ti + 1) * b]
        cw = weights[ti * b:(ti + 1) * b]
        cc = conf_t[ti * b:(ti + 1) * b]
        accu_pred[:, sy:sy + win_h, sx:sx + win_w] += p * cw[..., None]
        accu_w[:, sy:sy + win_h, sx:sx + win_w] += cw
        accu_c[:, sy:sy + win_h, sx:sx + win_w] += cc * cw
    pred = accu_pred / accu_w[..., None]
    c = accu_c / accu_w
    if do_change_scale:
        pred = _resize_stereo_or_flow(pred, original_size)
    loss = torch.stack(tiled_losses).mean() if tiled_losses else None
    return pred, loss, c


def make_stereoflow_train_step(model, tx, loss_fn: Callable, with_conf: bool):
    """The downstream train step (engine.py:25-98 without its logging):
    step(state, img1, img2, gt) -> (state, loss, grad_norm), `state` (from
    `training.create_train_state`) updated in place, the loss and the
    gradient norm before clipping 0-dim tensors. img1 / img2 (B, H, W, 3),
    gt (B, H, W, C) with +-inf at invalid pixels, moved to the model's
    device. `loss_fn(pred, gt[, conf])`: a criterion of `criterion.LOSSES`,
    with the confidence when `with_conf`."""
    params = dict(model.named_parameters())

    def step(state: TrainState, img1: torch.Tensor, img2: torch.Tensor, gt: torch.Tensor):
        device = next(model.parameters()).device
        img1, img2, gt = img1.to(device), img2.to(device), gt.to(device)
        with torch.enable_grad():
            with record_function("train_step.forward"):
                pred, conf = split_prediction_conf(model(img1, img2).float(), with_conf)
                loss = loss_fn(pred, gt, conf) if with_conf else loss_fn(pred, gt)
            loss.backward()
        with record_function("train_step.optimizer"):
            grad_norm = apply_gradients_(model, params, state, tx)
        state.step += 1
        return state, loss.detach(), grad_norm

    return step
