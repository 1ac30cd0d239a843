"""Self-contained PnP-RANSAC (no OpenCV): DLT minimal solves + vectorized
hypothesis scoring + DLT refinement on inliers.

The port's own copy of the JAX package's module of the same name (numpy
only, float64), so that the port imports nothing of it.

Replaces cv2.solvePnPRansac(SQPNP, reprojectionError=5, iterationsCount=10)
used by the MST init fallback (init_im_poses.py:244-284). The call sites only
need a coarse pose for images the spanning tree missed (subsequently refined
by 300 Adam iterations), so DLT accuracy is ample.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _dlt_pose(pts3d: np.ndarray, pts2d_norm: np.ndarray) -> Optional[np.ndarray]:
    """DLT for [R|t] given 3D points and K-normalized 2D points (N>=6).
    Returns 3x4 [R|t] (world->cam) or None on degenerate input."""
    n = len(pts3d)
    A = np.zeros((2 * n, 12))
    X = np.concatenate([pts3d, np.ones((n, 1))], -1)
    A[0::2, 0:4] = X
    A[0::2, 8:12] = -pts2d_norm[:, 0:1] * X
    A[1::2, 4:8] = X
    A[1::2, 8:12] = -pts2d_norm[:, 1:2] * X
    try:
        _, _, Vt = np.linalg.svd(A)
    except np.linalg.LinAlgError:
        return None
    P = Vt[-1].reshape(3, 4)
    # fix scale/sign so that points are in front of the camera
    depths = X @ P[2]
    if np.median(depths) < 0:
        P = -P
    M = P[:, :3]
    # orthogonalize rotation via SVD, recover isotropic scale
    U, D, Vt2 = np.linalg.svd(M)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt2) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt2
    scale = D.mean()
    if scale <= 0:
        return None
    t = P[:, 3] / scale
    return np.concatenate([R, t[:, None]], axis=1)


def _refine_pose_gn(
    pts3d: np.ndarray, pts2d_norm: np.ndarray, R: np.ndarray, t: np.ndarray,
    iters: int = 15,
) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Newton on the normalized reprojection error (pose-only, 6-DoF,
    left-multiplied so(3) updates). DLT is degenerate for (near-)planar
    clouds — the common case for dust3r pointmaps of a single surface — and
    cv2's SQPnP (the reference solver, init_im_poses.py:254) handles that
    case exactly; a few GN steps from the DLT init restore that accuracy."""
    R = R.copy()
    t = t.copy()
    for _ in range(iters):
        cam = pts3d @ R.T + t
        z = cam[:, 2]
        ok = z > 1e-9
        if ok.sum() < 3:
            break
        cam = cam[ok]
        z = z[ok]
        r = cam[:, :2] / z[:, None] - pts2d_norm[ok]  # (M, 2)
        # d(x/z,y/z)/dcam then dcam/d(omega,t) = [-[cam]_x | I]
        x, y = cam[:, 0], cam[:, 1]
        invz = 1.0 / z
        # J has shape (M, 2, 6)
        J = np.zeros((len(cam), 2, 6))
        dproj = np.zeros((len(cam), 2, 3))
        dproj[:, 0, 0] = invz
        dproj[:, 0, 2] = -x * invz * invz
        dproj[:, 1, 1] = invz
        dproj[:, 1, 2] = -y * invz * invz
        skew = np.zeros((len(cam), 3, 3))
        skew[:, 0, 1] = -cam[:, 2]
        skew[:, 0, 2] = cam[:, 1]
        skew[:, 1, 0] = cam[:, 2]
        skew[:, 1, 2] = -cam[:, 0]
        skew[:, 2, 0] = -cam[:, 1]
        skew[:, 2, 1] = cam[:, 0]
        J[:, :, :3] = -dproj @ skew  # dcam/domega = d(omega x cam)/domega = -[cam]_x
        J[:, :, 3:] = dproj
        Jf = J.reshape(-1, 6)
        rf = r.reshape(-1)
        JtJ = Jf.T @ Jf + 1e-9 * np.eye(6)
        try:
            delta = np.linalg.solve(JtJ, -Jf.T @ rf)
        except np.linalg.LinAlgError:
            break
        w_vec, dt = delta[:3], delta[3:]
        th = np.linalg.norm(w_vec)
        if th < 1e-15:
            t = t + dt
            break
        k = w_vec / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        dR = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)
        R = dR @ R
        t = dR @ t + dt
        if th < 1e-12 and np.linalg.norm(dt) < 1e-12:
            break
    return R, t


def solve_pnp_ransac(
    pts3d: np.ndarray,
    pts2d: np.ndarray,
    K: np.ndarray,
    n_iters: int = 10,
    reproj_thresh: float = 5.0,
    min_sample: int = 6,
    rng: np.random.Generator | None = None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """pts3d (N,3) world, pts2d (N,2) pixels, K (3,3).
    Returns (R, t) world->cam, or None."""
    n = len(pts3d)
    if n < min_sample:
        return None
    rng = rng or np.random.default_rng(0)
    Kinv = np.linalg.inv(K)
    ones = np.ones((n, 1))
    norm2d = (Kinv @ np.concatenate([pts2d, ones], -1).T).T[:, :2]

    def reproj_inliers(Rt):
        cam = pts3d @ Rt[:, :3].T + Rt[:, 3]
        z = cam[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            proj = cam[:, :2] / cam[:, 2:3]
        uv = (K[:2, :2] @ proj.T).T + K[:2, 2]
        err = np.linalg.norm(uv - pts2d, axis=-1)
        return (z > 0) & np.isfinite(err) & (err < reproj_thresh)

    best_inl, best_Rt = None, None
    for _ in range(max(n_iters, 1)):
        idx = rng.choice(n, size=min(min_sample, n), replace=False)
        Rt = _dlt_pose(pts3d[idx], norm2d[idx])
        if Rt is None:
            continue
        inl = reproj_inliers(Rt)
        if best_inl is None or inl.sum() > best_inl.sum():
            best_inl, best_Rt = inl, Rt
    if best_Rt is None or best_inl.sum() < min_sample:
        return None
    # refine on all inliers
    refined = _dlt_pose(pts3d[best_inl], norm2d[best_inl])
    if refined is not None and reproj_inliers(refined).sum() >= best_inl.sum():
        best_Rt = refined
    # Gauss-Newton polish (DLT is degenerate on near-planar clouds)
    R, t = _refine_pose_gn(pts3d[best_inl], norm2d[best_inl], best_Rt[:, :3], best_Rt[:, 3])
    polished = np.concatenate([R, t[:, None]], axis=1)
    if reproj_inliers(polished).sum() >= best_inl.sum():
        best_Rt = polished
    return best_Rt[:, :3], best_Rt[:, 3]


def fast_pnp(
    pts3d: np.ndarray,
    focal: Optional[float],
    mask: np.ndarray,
    pp: Optional[np.ndarray] = None,
    n_iters: int = 10,
) -> Optional[Tuple[float, np.ndarray]]:
    """Reference fast_pnp semantics (init_im_poses.py:244-284): subsampled
    masked pixels, focal sweep when unknown, returns (focal, cam2world)."""
    h, w, _ = pts3d.shape
    if mask.sum() < 4:
        return None
    if pp is None:
        pp = np.array([w / 2, h / 2])
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    pixels = np.stack([uu, vv], -1)
    msk = np.asarray(mask, bool)
    p3 = pts3d[msk]
    p2 = pixels[msk]

    focals = [focal] if focal is not None else np.geomspace(max(w, h) / 2, max(w, h) * 3, 21)
    best = (0, None, None)
    for f in focals:
        K = np.array([[f, 0, pp[0]], [0, f, pp[1]], [0, 0, 1.0]])
        res = solve_pnp_ransac(p3, p2, K, n_iters=n_iters)
        if res is None:
            continue
        R, t = res
        cam = p3 @ R.T + t
        uv = (cam[:, :2] / cam[:, 2:3]) * f + pp
        score = int(((np.linalg.norm(uv - p2, axis=-1) < 5) & (cam[:, 2] > 0)).sum())
        if score > best[0]:
            best = (score, f, (R, t))
    if best[2] is None:
        return None
    _, f, (R, t) = best
    c2w = np.eye(4)
    c2w[:3, :3] = R.T
    c2w[:3, 3] = -R.T @ t
    return float(f), c2w
