"""Quality metrics of the eval protocol (PSNR / SSIM / LPIPS): the port's
own copy of the JAX package's `utils/metrics.py`.

The reference computes these outside its repo (README.md:171-177;
`single_view_eval` only writes videos). PSNR and SSIM (Wang et al. 2004,
the 11x11 Gaussian of sigma 1.5, K1 = 0.01, K2 = 0.03) are torch functions
of channels-last tensors on any device. LPIPS is the AlexNet-backbone
formulation as `nn.Module`s (`AlexFeatures`, `LPIPS`); its backbone and
linear heads load from a user-supplied .pth (no weights ship with the
repo): without them `lpips_available()` is False and `video_metrics`
reports `lpips` as None.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """PSNR over the last three axes (H, W, C); a, b in [0, data_range]."""
    mse = ((a.float() - b.float()) ** 2).mean(dim=(-3, -2, -1))
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp(min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return g[:, None] * g[None, :]


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """SSIM (11x11 Gaussian window, K1 = 0.01, K2 = 0.03), the mean over the
    image; inputs (..., H, W, C) in [0, data_range]."""
    a, b = a.float(), b.float()
    kern = _gaussian_kernel(device=a.device)[None, None]  # (1, 1, 11, 11)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2

    def filt(x):  # a depthwise VALID filter of each channel
        lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
        y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2).reshape(-1, 1, h, w)
        y = F.conv2d(y, kern)
        oh, ow = y.shape[-2:]
        return y.reshape(-1, c, oh, ow).permute(0, 2, 3, 1).reshape(*lead, oh, ow, c)

    mu_a, mu_b = filt(a), filt(b)
    # (co)variances on inputs re-centred on their means: Var(x) = E[(x-c)^2]
    # - (E[x]-c)^2 for any constant c, and with c near the mean both terms
    # stay small, so float32 does not cancel them away on smooth images
    ca = a.mean(dim=(-3, -2, -1), keepdim=True)
    cb = b.mean(dim=(-3, -2, -1), keepdim=True)
    am, bm = a - ca, b - cb
    da, db = mu_a - ca, mu_b - cb
    sa = filt(am * am) - da ** 2
    sb = filt(bm * bm) - db ** 2
    sab = filt(am * bm) - da * db
    s = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)) / ((mu_a ** 2 + mu_b ** 2 + c1) * (sa + sb + c2))
    return s.mean(dim=(-3, -2, -1))


# ---------------------------------------------------------------------------
# LPIPS (AlexNet backbone; weights supplied by the user)
# ---------------------------------------------------------------------------

ALEX_LAYOUT = ((3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
               (384, 256, 3, 1, 1), (256, 256, 3, 1, 1))  # (in, out, kernel, stride, pad)
POOL_AFTER = (0, 1)  # a 3x3 / 2 max-pool after the first two convs' features
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# torchvision alexnet.features conv indices; the lpips package keeps them
# inside its slice modules (lpips/pretrained_networks.py): slice1.0,
# slice2.3, slice3.6, slice4.8, slice5.10
ALEX_CONV_IDX = (0, 3, 6, 8, 10)


def _resolve_lpips_arrays(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Any of three layouts -> {conv{i}.weight/bias, lin{i}.weight}:
      (a) a full lpips.LPIPS(net='alex') state dict:
          net.slice{k}.{n}.weight, lin{i}.model.1.weight, scaling_layer.*
      (b) the official lin-only file (lpips/weights/v0.1/alex.pth):
          lin{i}.model.1.weight, the backbone merged in from (c)
      (c) torchvision alexnet: features.{n}.weight
    Raises KeyError naming what is missing; no fallback."""
    out: Dict[str, np.ndarray] = {}
    for i, n in enumerate(ALEX_CONV_IDX):
        cands = [f"net.slice{i + 1}.{n}.weight", f"features.{n}.weight",
                 f"net.features.{n}.weight"]
        key = next((c for c in cands if c in sd), None)
        if key is None:
            raise KeyError(
                f"LPIPS: no AlexNet conv{i} weight under any of {cands}; "
                "supply a full lpips.LPIPS state dict or merge torchvision "
                "alexnet features into the file")
        out[f"conv{i}.weight"] = sd[key]
        out[f"conv{i}.bias"] = sd[key.replace("weight", "bias")]
    for i in range(5):
        cands = [f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"]
        key = next((c for c in cands if c in sd), None)
        if key is None:
            raise KeyError(f"LPIPS: missing linear head under any of {cands}")
        out[f"lin{i}.weight"] = sd[key]
    return out


class AlexFeatures(nn.Module):
    """AlexNet's five conv + ReLU stages; returns each stage's features."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv2d(i, o, k, stride=s, padding=p)
                                   for i, o, k, s, p in ALEX_LAYOUT)

    def forward(self, x: torch.Tensor):
        feats = []
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            feats.append(x)
            if i in POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return feats


class LPIPS(nn.Module):
    """LPIPS distance: AlexNet features of both images, unit-normalised over
    channels, squared differences weighted by the linear heads (1x1 convs
    without bias), averaged over pixels and summed over the stages."""

    def __init__(self):
        super().__init__()
        self.net = AlexFeatures()
        self.lins = nn.ModuleList(nn.Conv2d(o, 1, 1, bias=False) for _, o, *_ in ALEX_LAYOUT)
        self.register_buffer("shift", torch.tensor(SHIFT)[:, None, None], persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE)[:, None, None], persistent=False)

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray]) -> "LPIPS":
        """From `_resolve_lpips_arrays`' {conv{i}.weight/bias, lin{i}.weight}."""
        model = cls()
        state = {}
        for i in range(5):
            state[f"net.convs.{i}.weight"] = arrays[f"conv{i}.weight"]
            state[f"net.convs.{i}.bias"] = arrays[f"conv{i}.bias"]
            state[f"lins.{i}.weight"] = arrays[f"lin{i}.weight"]
        model.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                               for k, v in state.items()}, strict=True)
        return model.eval().requires_grad_(False)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b (..., H, W, 3) in [-1, 1] -> the distance per image (...)."""
        lead = a.shape[:-3]

        def feats(x):
            x = x.float().reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)
            return self.net((x - self.shift) / self.scale)

        total = 0.0
        for fa, fb, lin in zip(feats(a), feats(b), self.lins):
            na = fa / fa.norm(dim=1, keepdim=True).clamp(min=1e-10)
            nb = fb / fb.norm(dim=1, keepdim=True).clamp(min=1e-10)
            total = total + lin((na - nb) ** 2).mean(dim=(1, 2, 3))
        return total.reshape(lead)


_LPIPS: Optional[LPIPS] = None


def load_lpips_weights(path: str) -> None:
    """AlexNet convs and LPIPS heads from a torch .pth (a full
    lpips.LPIPS(net='alex') state dict, or the official lin-only file merged
    with torchvision's alexnet weights). An unknown layout raises."""
    global _LPIPS
    sd = torch.load(path, map_location="cpu", weights_only=True)
    arrays = {k: v.detach().float().numpy() for k, v in sd.items()}
    _LPIPS = LPIPS.from_arrays(_resolve_lpips_arrays(arrays))


def lpips_available() -> bool:
    return _LPIPS is not None


@torch.no_grad()
def lpips(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LPIPS distance of a, b (..., H, W, 3) in [-1, 1], on their device.
    Needs load_lpips_weights() first."""
    if _LPIPS is None:
        raise RuntimeError("LPIPS weights not loaded; call load_lpips_weights(path)")
    return _LPIPS.to(a.device)(a, b)


def video_metrics(pred: np.ndarray, gt: np.ndarray, device=None) -> Dict[str, Optional[float]]:
    """Per-video means; pred and gt (T, H, W, 3) in [0, 1], computed on
    `device` (the card unless the caller asks for the CPU). `lpips` is
    always in the result: a float with the weights loaded, None without
    them, so that an eval run never measures less than it says."""
    from viewcrafter_tpu_torch.models.lvdm import resolve_device

    dev = resolve_device(device)
    p = torch.as_tensor(np.asarray(pred, np.float32), device=dev)
    g = torch.as_tensor(np.asarray(gt, np.float32), device=dev)
    return {"psnr": psnr(p, g).mean().item(), "ssim": ssim(p, g).mean().item(),
            "lpips": lpips(p * 2 - 1, g * 2 - 1).mean().item() if lpips_available() else None}
