"""Focal estimation from a pointmap — Weiszfeld iterative reweighted LS.

The port's own copy of the JAX package's module of the same name (numpy
only, float64), so that the port imports nothing of it.

Parity: extern/dust3r/dust3r/post_process.py:12-60 ('weiszfeld' mode, 10
iterations, focal clipped to [0.5, 3.5] x focal_base with the 60-degree base).
"""

from __future__ import annotations

import numpy as np


def estimate_focal(pts3d: np.ndarray, pp: np.ndarray | None = None,
                   min_focal: float = 0.5, max_focal: float = 3.5) -> float:
    """pts3d: (H, W, 3) camera-frame pointmap -> scalar focal (pixels)."""
    h, w, _ = pts3d.shape
    if pp is None:
        pp = np.array([w / 2, h / 2])
    # integer pixel grid, centered on the principal point
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    pixels = np.stack([uu.ravel() - pp[0], vv.ravel() - pp[1]], -1)  # (HW, 2)
    pts = np.asarray(pts3d, np.float64).reshape(-1, 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        xy_over_z = pts[:, :2] / pts[:, 2:3]
    xy_over_z = np.nan_to_num(xy_over_z, posinf=0, neginf=0)

    dot_xy_px = (xy_over_z * pixels).sum(-1)
    dot_xy_xy = (xy_over_z**2).sum(-1)
    focal = dot_xy_px.mean() / dot_xy_xy.mean()
    for _ in range(10):
        dis = np.linalg.norm(pixels - focal * xy_over_z, axis=-1)
        wgt = 1.0 / np.clip(dis, 1e-8, None)
        focal = (wgt * dot_xy_px).mean() / (wgt * dot_xy_xy).mean()

    focal_base = max(h, w) / (2 * np.tan(np.deg2rad(60) / 2))
    return float(np.clip(focal, min_focal * focal_base, max_focal * focal_base))
