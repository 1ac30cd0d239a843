"""Stereo/flow losses and metrics: the port of the JAX package's
`stereoflow/criterion.py`.

Parity target: extern/dust3r/croco/stereoflow/criterion.py:
  - L1Loss (:20-36), LaplacianLoss (:41-53), LaplacianLossBounded (:56-69,
    CroCo-Flow), LaplacianLossBounded2 (:71-84, CroCo-Stereo);
  - StereoMetrics (:88-111) / FlowMetrics (:113-132) per batch;
  - StereoDatasetMetrics (:140-182) / FlowDatasetMetrics (:184-251), the
    streaming per-dataset aggregates.

Conventions kept from the JAX package: channels-last (B, H, W, C); a pixel
is valid only when every channel of its gt is finite (the reference marks
invalid pixels with +-inf); the gt is replaced by 0 (losses, streaming
metrics) or by 999999 (per-batch metrics) before the difference; the masked
means are sum(x * m) / max(sum(m), 1); per-batch metrics normalize per image
first, then take the batch mean.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _finite_or(gt: torch.Tensor, fill: float) -> torch.Tensor:
    return torch.where(torch.isfinite(gt), gt, torch.full_like(gt, fill))


def _gtnorm(gt: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1): the disparity for stereo (C = 1), the flow's magnitude
    for flow (C = 2) (criterion.py:12-16)."""
    if gt.shape[-1] == 1:
        return gt
    return torch.sqrt(torch.sum(gt ** 2, dim=-1, keepdim=True))


def _valid_mask(gt: torch.Tensor, max_gtnorm: Optional[float]) -> torch.Tensor:
    """(B, H, W) bool: every channel finite, and the norm under max_gtnorm."""
    m = torch.isfinite(gt).all(dim=-1)
    if max_gtnorm is not None:
        m = m & (_gtnorm(_finite_or(gt, 0.0))[..., 0] < max_gtnorm)
    return m


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    return torch.sum(x.float() * m) / torch.clamp(torch.sum(m), min=1.0)


def _l1(pred, gt) -> torch.Tensor:
    return torch.sum(torch.abs(_finite_or(gt, 0.0) - pred), dim=-1)


def l1_loss(pred, gt, max_gtnorm: Optional[float] = None) -> torch.Tensor:
    """Masked L1 over the valid entries (criterion.py:20-36)."""
    mask = _valid_mask(gt, max_gtnorm)
    err = torch.abs(_finite_or(gt, 0.0) - pred)
    return _masked_mean(torch.mean(err, dim=-1), mask)


def laplacian_loss(pred, gt, conf, max_gtnorm: Optional[float] = None) -> torch.Tensor:
    """|gt - pred|.sum(C) / exp(conf) + conf over the valid pixels
    (criterion.py:41-53; CroCo-Stereo on ETH3D)."""
    conf = conf.float()
    return _masked_mean(_l1(pred, gt) / torch.exp(conf) + conf, _valid_mask(gt, max_gtnorm))


def laplacian_loss_bounded(pred, gt, conf, max_gtnorm: float = 10000.0,
                           a: float = 0.25, b: float = 4.0) -> torch.Tensor:
    """CroCo-Flow's: conf squashed into (a, b) by a sigmoid, |err| / conf +
    log(conf) (criterion.py:56-69)."""
    c = (b - a) * torch.sigmoid(conf.float()) + a
    return _masked_mean(_l1(pred, gt) / c + torch.log(c), _valid_mask(gt, max_gtnorm))


def laplacian_loss_bounded2(pred, gt, conf, max_gtnorm: Optional[float] = None,
                            a: float = 3.0, b: float = 3.0) -> torch.Tensor:
    """CroCo-Stereo's (every data set but ETH3D): conf squashed into (-a, a),
    |err| / exp(conf) + conf (criterion.py:71-84)."""
    c = 2.0 * a * (torch.sigmoid(conf.float() / b) - 0.5)
    return _masked_mean(_l1(pred, gt) / torch.exp(c) + c, _valid_mask(gt, max_gtnorm))


LOSSES = {
    "L1Loss": l1_loss,
    "LaplacianLoss": laplacian_loss,
    "LaplacianLossBounded": laplacian_loss_bounded,
    "LaplacianLossBounded2": laplacian_loss_bounded2,
}
WITH_CONF = {
    "L1Loss": False,
    "LaplacianLoss": True,
    "LaplacianLossBounded": True,
    "LaplacianLossBounded2": True,
}


def _per_image(x: torch.Tensor, b: int) -> torch.Tensor:
    return x.reshape(b, -1).sum(dim=1)


def stereo_metrics(pred: torch.Tensor, gt: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-batch stereo metrics (criterion.py:88-111): avgerr, rmse and
    bad@{0.5,1,2,3} in %."""
    b = pred.shape[0]
    mask = torch.isfinite(gt)
    gtc = _finite_or(gt, 999999.0)
    m = mask.reshape(b, -1).float()
    npx = m.sum(dim=1)
    l1 = (torch.abs(gtc - pred) * mask).reshape(b, -1)
    l2 = (torch.square(gtc - pred) * mask).reshape(b, -1)
    out = {"avgerr": torch.mean(l1.sum(dim=1) / npx),
           "rmse": torch.mean(torch.sqrt(l2.sum(dim=1) / npx))}
    for ths in (0.5, 1.0, 2.0, 3.0):
        bad = ((l1 > ths) & (m > 0)).float()
        out[f"bad@{ths:.1f}"] = torch.mean(bad.sum(dim=1) / npx) * 100.0
    return out


def flow_metrics(pred: torch.Tensor, gt: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-batch flow metrics (criterion.py:113-132): L1err, EPE and
    bad@{1,3,5} (of the EPE) in %."""
    b = pred.shape[0]
    mask = torch.isfinite(gt[..., 0])
    gtc = _finite_or(gt, 999999.0)
    m = mask.reshape(b, -1).float()
    npx = m.sum(dim=1)
    l1 = (torch.sum(torch.abs(gtc - pred), dim=-1) * mask).reshape(b, -1)
    l2 = (torch.sqrt(torch.sum(torch.square(gtc - pred), dim=-1)) * mask).reshape(b, -1)
    out = {"L1err": torch.mean(l1.sum(dim=1) / npx), "EPE": torch.mean(l2.sum(dim=1) / npx)}
    for ths in (1.0, 3.0, 5.0):
        bad = ((l2 > ths) & (m > 0)).float()
        out[f"bad@{ths:.1f}"] = torch.mean(bad.sum(dim=1) / npx) * 100.0
    return out


def _running(mean: float, n: int, batch_mean: float, n_batch: int) -> float:
    new_n = n + n_batch
    return n / new_n * mean + batch_mean * n_batch / new_n


class StereoDatasetMetrics:
    """Streaming per-data-set aggregates (criterion.py:140-182): the running
    mean L1 error over every valid pixel and bad-pixel counters. Host state,
    tensor math on the batch's device."""

    bad_ths = (0.5, 1.0, 2.0, 3.0)

    def __init__(self):
        self.reset()

    def reset(self):
        self.agg_n = 0
        self.agg_l1 = 0.0
        self.agg_nbad = [0 for _ in self.bad_ths]

    def add_batch(self, pred: torch.Tensor, gt: torch.Tensor) -> None:
        assert pred.shape[-1] == 1 and gt.shape[-1] == 1
        valid = torch.isfinite(gt[..., 0])
        l1 = _l1(pred, gt)
        n = int(valid.sum())
        if n == 0:
            return
        self.agg_l1 = _running(self.agg_l1, self.agg_n, float(_masked_mean(l1, valid)), n)
        self.agg_n += n
        for i, th in enumerate(self.bad_ths):
            self.agg_nbad[i] += int(((l1 > th) & valid).sum())

    def get_results(self) -> Dict[str, float]:
        out = {"L1err": self.agg_l1}
        for i, th in enumerate(self.bad_ths):
            out[f"bad@{th:.1f}"] = self.agg_nbad[i] / max(self.agg_n, 1) * 100.0
        return out


class FlowDatasetMetrics:
    """Streaming flow aggregates (criterion.py:184-251): the running L1 and
    EPE means, bad-pixel counters, and the EPE per gt-speed bin."""

    bad_ths = (0.5, 1.0, 3.0, 5.0)
    speed_ths = ((0.0, 10.0), (10.0, 40.0), (40.0, float("inf")))

    def __init__(self):
        self.reset()

    def reset(self):
        self.agg_n = 0
        self.agg_l1 = 0.0
        self.agg_l2 = 0.0
        self.agg_nbad = [0 for _ in self.bad_ths]
        self.agg_epe_speed = [0.0 for _ in self.speed_ths]
        self.agg_n_speed = [0 for _ in self.speed_ths]

    def add_batch(self, pred: torch.Tensor, gt: torch.Tensor) -> None:
        assert pred.shape[-1] == 2 and gt.shape[-1] == 2
        valid = torch.isfinite(gt[..., 0])
        gtc = _finite_or(gt, 0.0)
        l1 = torch.sum(torch.abs(gtc - pred), dim=-1)
        l2 = torch.sqrt(torch.sum(torch.square(gtc - pred), dim=-1))
        speed = torch.sqrt(torch.sum(torch.square(gtc), dim=-1))
        n = int(valid.sum())
        if n == 0:
            return
        self.agg_l1 = _running(self.agg_l1, self.agg_n, float(_masked_mean(l1, valid)), n)
        self.agg_l2 = _running(self.agg_l2, self.agg_n, float(_masked_mean(l2, valid)), n)
        self.agg_n += n
        for i, th in enumerate(self.bad_ths):
            self.agg_nbad[i] += int(((l2 > th) & valid).sum())
        for i, (t1, t2) in enumerate(self.speed_ths):
            vv = valid & (speed >= t1) & (speed < t2)
            n_sp = int(vv.sum())
            if n_sp == 0:
                continue
            self.agg_epe_speed[i] = _running(self.agg_epe_speed[i], self.agg_n_speed[i],
                                             float(_masked_mean(l2, vv)), n_sp)
            self.agg_n_speed[i] += n_sp

    def get_results(self) -> Dict[str, float]:
        out = {"L1err": self.agg_l1, "EPE": self.agg_l2}
        for i, th in enumerate(self.bad_ths):
            out[f"bad@{th:.1f}"] = self.agg_nbad[i] / max(self.agg_n, 1) * 100.0
        for i, (t1, t2) in enumerate(self.speed_ths):
            key = f"s{int(t1):d}" + (f"-{int(t2):d}" if t2 < float("inf") else "+")
            out[key] = self.agg_epe_speed[i]
        return out
