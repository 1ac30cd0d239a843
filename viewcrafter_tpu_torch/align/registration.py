"""Weighted similarity (sim3) point registration — Umeyama via SVD.

The port's own copy of the JAX package's module of the same name (numpy
only, float64), so that the port imports nothing of it.

Replaces roma.rigid_points_registration (used at init_im_poses.py:216-219,
305-313): find (s, R, T) minimizing sum_i w_i ||y_i - (s R x_i + T)||^2.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def rigid_points_registration(
    x: np.ndarray, y: np.ndarray, weights: np.ndarray | None = None, compute_scaling: bool = True
) -> Tuple[float, np.ndarray, np.ndarray]:
    """x, y: (N, 3); weights: (N,). Returns (s, R, T) with y ~= s R x + T."""
    x = np.asarray(x, np.float64).reshape(-1, 3)
    y = np.asarray(y, np.float64).reshape(-1, 3)
    if weights is None:
        weights = np.ones(len(x))
    w = np.asarray(weights, np.float64).ravel()
    w = w / w.sum()

    mu_x = (w[:, None] * x).sum(0)
    mu_y = (w[:, None] * y).sum(0)
    xc = x - mu_x
    yc = y - mu_y
    cov = (w[:, None] * yc).T @ xc  # 3x3, y-then-x
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_x = (w * (xc**2).sum(-1)).sum()
    s = float(np.trace(np.diag(D) @ S) / var_x) if compute_scaling else 1.0
    T = mu_y - s * R @ mu_x
    return s, R, T


def srt_to_mat(s: float, R: np.ndarray, T: np.ndarray) -> np.ndarray:
    """(s, R, T) -> 4x4 with scaled rotation (init_im_poses.py:220-225);
    translation is NOT scaled."""
    m = np.eye(4)
    m[:3, :3] = R * s
    m[:3, 3] = np.ravel(T)
    return m


def align_multiple_poses(src: np.ndarray, dst: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """Global sim3 aligning pose sets via centers + z-axis probes
    (init_im_poses.py:295-313)."""
    centers = src[:, :3, 3]
    d = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    eps = np.median(d[d > 0]) / 100 if (d > 0).any() else 0.01

    def probes(poses):
        return np.concatenate([poses[:, :3, 3], poses[:, :3, 3] + eps * poses[:, :3, 2]])

    return rigid_points_registration(probes(src), probes(dst))
