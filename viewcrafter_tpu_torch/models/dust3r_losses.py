"""DUSt3R training losses (pointmap regression and confidence weighting), on
torch tensors: the port of the JAX package's `models/dust3r_losses.py`.

Parity targets (extern/dust3r/dust3r/losses.py:140-297):
  - Regr3D: L2 regression of both views' pointmaps in view1's camera frame,
    with 'avg_dis' normalization of the predicted and the true clouds apart;
  - ConfLoss: conf-weighted pixel loss minus alpha * log(conf);
  - the shift-, scale- and scale-and-shift-invariant variants.

Masked means stand where the reference indexes with a boolean mask, as in
the JAX package (the same value). The medians are the lower middle element
among the valid values, taken from a stable sort, so that the gradient
reaches the same element as the JAX package's (`take_along_axis` of its
stable sort), ties included. `joint_pointcloud_center_scale` runs without
grad, as the reference computes it under no_grad and the JAX package under
stop_gradient.

One difference at a single point: the gradient of a vector norm at exactly
zero is NaN in JAX and zero here (torch's subgradient).

Under data parallelism each rank holds its samples; `counts` gives the
masked means the global valid-pixel counts, so that the ranks' losses sum to
the loss of the whole batch (`pretrain.make_dust3r_train_step`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from viewcrafter_tpu_torch.geometry.transforms import geotrf, inv_se3

MODES = ("plain", "shift_inv", "scale_inv", "scale_shift_inv")


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None,
                 count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum(x * mask) / max(sum(mask), 1) over `dim` (all of them by
    default); `count`, when given, replaces sum(mask) (a global count)."""
    m = mask.to(x.dtype)
    if dim is None:
        total, n = (x * m).sum(), m.sum()
    else:
        total, n = (x * m).sum(dim), m.sum(dim)
    return total / torch.clamp(n if count is None else count.to(x.dtype), min=1.0)


def normalize_pointcloud(pts1, pts2, valid1, valid2):
    """'avg_dis' norm: divide both clouds by the average distance to the
    origin of all valid points of the sample (losses.py normalize_pointcloud)."""
    b = pts1.shape[0]
    all_d = torch.cat([torch.linalg.vector_norm(pts1, dim=-1).reshape(b, -1),
                       torch.linalg.vector_norm(pts2, dim=-1).reshape(b, -1)], dim=1)
    all_m = torch.cat([valid1.reshape(b, -1), valid2.reshape(b, -1)], dim=1)
    norm = torch.clamp(_masked_mean(all_d, all_m, dim=1), min=1e-8)[:, None, None, None]
    return pts1 / norm, pts2 / norm


def _nan_where(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask[..., None] if x.ndim == mask.ndim + 1 else mask
    return torch.where(m, x, torch.full_like(x, float("nan")))


def _nanmedian_lower(x: torch.Tensor, dim: int) -> torch.Tensor:
    """torch.nanmedian's value (the lower middle element among the non-NaNs),
    selected from a stable sort (NaNs sort last), so that with ties the
    gradient goes to the element the JAX package's sort selects."""
    s = torch.sort(x, dim=dim, stable=True).values
    n = (~torch.isnan(x)).sum(dim=dim, keepdim=True)
    idx = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, x.shape[dim] - 1)
    return torch.gather(s, dim, idx).squeeze(dim)


def joint_pointcloud_depth(z1, z2, valid1, valid2) -> torch.Tensor:
    """Joint masked median depth over both views, (B,)
    (dust3r/utils/geometry.py:308-319, quantile 0.5)."""
    b = z1.shape[0]
    z = torch.cat([_nan_where(z1, valid1).reshape(b, -1),
                   _nan_where(z2, valid2).reshape(b, -1)], dim=1)
    return _nanmedian_lower(z, dim=-1)


@torch.no_grad()
def joint_pointcloud_center_scale(pts1, pts2, valid1, valid2):
    """Joint masked median center (B, 1, 3) and median distance to it (B,)
    (dust3r/utils/geometry.py:323-337), without grad."""
    b = pts1.shape[0]
    pts = torch.cat([_nan_where(pts1.detach(), valid1).reshape(b, -1, 3),
                     _nan_where(pts2.detach(), valid2).reshape(b, -1, 3)], dim=1)
    center = _nanmedian_lower(pts, dim=1)[:, None, :]
    norm = torch.linalg.vector_norm(pts - center, dim=-1)  # NaN rows stay NaN
    return center, _nanmedian_lower(norm, dim=1)


def _shift_z(pts: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts[..., :2], pts[..., 2:] - shift[:, None, None, None]], dim=-1)


def _shift_inv(gt_pts1, gt_pts2, pr_pts1, pr_pts2, valid1, valid2):
    """Subtract the joint median depth from z (losses.py:239-262
    Regr3D_ShiftInv)."""
    gs = joint_pointcloud_depth(gt_pts1[..., 2], gt_pts2[..., 2], valid1, valid2)
    ps = joint_pointcloud_depth(pr_pts1[..., 2], pr_pts2[..., 2], valid1, valid2)
    return _shift_z(gt_pts1, gs), _shift_z(gt_pts2, gs), _shift_z(pr_pts1, ps), \
        _shift_z(pr_pts2, ps)


def _scale_inv(gt_pts1, gt_pts2, pr_pts1, pr_pts2, valid1, valid2, gt_scale: bool):
    """Rescale by the joint median scene scale (losses.py:265-295
    Regr3D_ScaleInv)."""
    _, g = joint_pointcloud_center_scale(gt_pts1, gt_pts2, valid1, valid2)
    _, p = joint_pointcloud_center_scale(pr_pts1, pr_pts2, valid1, valid2)
    g4 = g[:, None, None, None]
    p4 = torch.clamp(p, 1e-3, 1e3)[:, None, None, None]
    if gt_scale:
        return gt_pts1, gt_pts2, pr_pts1 * (g4 / p4), pr_pts2 * (g4 / p4)
    return gt_pts1 / g4, gt_pts2 / g4, pr_pts1 / p4, pr_pts2 / p4


def regr3d_loss(gt1: Dict, gt2: Dict, pred1: Dict, pred2: Dict, norm_mode: bool = True,
                gt_scale: bool = False, dist_clip: Optional[float] = None,
                mode: str = "plain") -> Tuple[torch.Tensor, ...]:
    """Per-pixel L2 losses and masks of both views: (loss1, mask1, loss2,
    mask2), each (B, H, W).

    gt dicts: pts3d (B, H, W, 3) in the world frame, camera_pose (B, 4, 4)
    camera to world, valid_mask (B, H, W). pred dicts: pts3d /
    pts3d_in_other_view (B, H, W, 3). mode: "plain" (Regr3D), "shift_inv",
    "scale_inv" or "scale_shift_inv" (losses.py:140-297); the avg_dis
    normalization comes first, then the shift, then the scale."""
    if mode not in MODES:
        raise ValueError(f"unknown regr3d mode {mode!r}")
    in_cam1 = inv_se3(gt1["camera_pose"].float())
    b, h, w, _ = gt1["pts3d"].shape
    gt_pts1 = geotrf(in_cam1, gt1["pts3d"].float().reshape(b, -1, 3)).reshape(b, h, w, 3)
    gt_pts2 = geotrf(in_cam1, gt2["pts3d"].float().reshape(b, -1, 3)).reshape(b, h, w, 3)
    valid1, valid2 = gt1["valid_mask"].bool(), gt2["valid_mask"].bool()
    if dist_clip is not None:
        valid1 = valid1 & (torch.linalg.vector_norm(gt_pts1, dim=-1) <= dist_clip)
        valid2 = valid2 & (torch.linalg.vector_norm(gt_pts2, dim=-1) <= dist_clip)
    pr_pts1, pr_pts2 = pred1["pts3d"], pred2["pts3d_in_other_view"]
    if norm_mode:
        pr_pts1, pr_pts2 = normalize_pointcloud(pr_pts1, pr_pts2, valid1, valid2)
        if not gt_scale:
            gt_pts1, gt_pts2 = normalize_pointcloud(gt_pts1, gt_pts2, valid1, valid2)
    if mode in ("shift_inv", "scale_shift_inv"):
        gt_pts1, gt_pts2, pr_pts1, pr_pts2 = _shift_inv(
            gt_pts1, gt_pts2, pr_pts1, pr_pts2, valid1, valid2)
    if mode in ("scale_inv", "scale_shift_inv"):
        gt_pts1, gt_pts2, pr_pts1, pr_pts2 = _scale_inv(
            gt_pts1, gt_pts2, pr_pts1, pr_pts2, valid1, valid2, gt_scale)
    loss1 = torch.linalg.vector_norm(pr_pts1 - gt_pts1, dim=-1)
    loss2 = torch.linalg.vector_norm(pr_pts2 - gt_pts2, dim=-1)
    return loss1, valid1, loss2, valid2


def conf_loss(gt1: Dict, gt2: Dict, pred1: Dict, pred2: Dict, alpha: float = 0.2,
              counts: Optional[Sequence[torch.Tensor]] = None,
              **regr_kw) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss: conf * pixel loss - alpha * log(conf), the masked
    mean over the valid pixels of each view, summed over the two views
    (losses.py:191-230). Returns (total, parts). `counts`: the two views'
    valid-pixel counts over the whole batch, when this call sees a shard of
    it (else its own)."""
    loss1, m1, loss2, m2 = regr3d_loss(gt1, gt2, pred1, pred2, **regr_kw)
    n1, n2 = counts if counts is not None else (None, None)
    log_c1 = torch.log(torch.clamp(pred1["conf"], min=1e-8))
    log_c2 = torch.log(torch.clamp(pred2["conf"], min=1e-8))
    cl1 = _masked_mean(loss1 * pred1["conf"] - alpha * log_c1, m1, count=n1)
    cl2 = _masked_mean(loss2 * pred2["conf"] - alpha * log_c2, m2, count=n2)
    return cl1 + cl2, {"conf_loss_1": cl1, "conf_loss_2": cl2,
                       "regr3d_1": _masked_mean(loss1, m1, count=n1),
                       "regr3d_2": _masked_mean(loss2, m2, count=n2)}
