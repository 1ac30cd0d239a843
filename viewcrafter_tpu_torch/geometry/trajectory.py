"""Camera trajectory synthesis (host-side numpy/scipy; 25 poses, not perf-critical).

The port's own copy of the JAX package's `geometry/trajectory.py` (same
functions, same float64 arithmetic), so that the port imports nothing of it.

Parity targets in utils/pvd_utils.py:
  - sphere2pose (:90-119): translate along the anchor camera's z by r (and
    x/y pans), then rotate about world x by theta and world y by phi;
  - rotate_theta (:56-88): Rodrigues rotation about a tilted axis;
  - generate_traj_specified (:263-290): linear ramps 0->d_theta/d_phi/d_r/d_x/d_y;
  - generate_traj_txt (:292-343): spline ('smooth' UnivariateSpline k=3 when
    >3 knots, else linear) interpolation of user keyframe sequences
    (txt_interpolation :558-568);
  - interpolate_poses_spline / interp_traj (:154-232): B-spline through
    (position, lookat, up) triplets for sparse-view interpolation;
  - focus_point_fn / interpolate_poses (:374-435): slerp path around the
    common focus point;
  - generate_candidate_poses (:121-152): NBV candidate set.

All functions return OpenCV-RDF c2w matrices (N, 4, 4), float64.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
from scipy import interpolate as sp_interp
from scipy.spatial.transform import Rotation, Slerp


def _rot_x(theta_deg: float) -> np.ndarray:
    t = np.deg2rad(theta_deg)
    c, s = np.cos(t), np.sin(t)
    m = np.eye(4, dtype=np.float64)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def _rot_y(phi_deg: float) -> np.ndarray:
    p = np.deg2rad(phi_deg)
    c, s = np.cos(p), np.sin(p)
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def sphere2pose(c2w_anchor: np.ndarray, theta: float, phi: float, r: float | None,
                x: float | None = None, y: float | None = None) -> np.ndarray:
    """Move the anchor camera on a sphere around the scene center
    (utils/pvd_utils.py:90-119). c2w_anchor: (4,4) RDF c2w."""
    c2w = np.array(c2w_anchor, dtype=np.float64, copy=True)
    if r is not None:
        c2w[2, 3] += r
    if x is not None and y is not None:
        c2w[1, 3] += y
        c2w[0, 3] += x
    return (_rot_y(phi) @ (_rot_x(theta) @ c2w)).astype(np.float32)


def rotate_theta(c2ws: np.ndarray, theta: float, phi: float, r: float) -> np.ndarray:
    """Rodrigues rotation by phi about the axis (0, cos(theta), sin(theta)),
    centered at depth r (utils/pvd_utils.py:56-88). c2ws: (N,4,4)."""
    out = np.array(c2ws, dtype=np.float64, copy=True)
    out[:, 2, 3] += r
    th, ph = np.deg2rad(theta), np.deg2rad(phi)
    v = np.array([0.0, np.cos(th), np.sin(th)])
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    R = np.eye(3) + np.sin(ph) * vx + (1 - np.cos(ph)) * (vx @ vx)
    Rh = np.eye(4)
    Rh[:3, :3] = R
    out = Rh[None] @ out
    out[:, 2, 3] -= r
    return out.astype(np.float32)


def txt_interpolation(values: Sequence[float], n: int, mode: str = "smooth") -> np.ndarray:
    """Resample keyframe values to n samples (utils/pvd_utils.py:558-568)."""
    values = np.asarray(values, dtype=np.float64)
    x = np.linspace(0, 1, len(values))
    if mode == "smooth":
        f = sp_interp.UnivariateSpline(x, values, k=3)
    elif mode == "linear":
        f = sp_interp.interp1d(x, values)
    else:
        raise KeyError(f"invalid interpolation mode {mode!r}")
    return np.asarray(f(np.linspace(0, 1, n)))


def generate_traj_specified(c2w_anchor: np.ndarray, d_theta: float, d_phi: float,
                            d_r: float, d_x: float, d_y: float, frames: int) -> np.ndarray:
    """Linear ramp from the anchor to the target spherical offset
    (utils/pvd_utils.py:263-290). d_r scales the anchor's z-translation."""
    thetas = np.linspace(0, d_theta, frames)
    phis = np.linspace(0, d_phi, frames)
    rs = np.linspace(0, d_r * c2w_anchor[2, 3], frames)
    xs = np.linspace(0, d_x, frames)
    ys = np.linspace(0, d_y, frames)
    return np.stack(
        [sphere2pose(c2w_anchor, t, p, r, x, y) for t, p, r, x, y in zip(thetas, phis, rs, xs, ys)]
    )


def generate_traj_txt(c2w_anchor: np.ndarray, phi: Sequence[float], theta: Sequence[float],
                      r: Sequence[float], frames: int) -> np.ndarray:
    """Trajectory from user keyframe txt (3 lines: phi / theta / r sequences)
    (utils/pvd_utils.py:292-343): smooth spline when >3 knots with pinned
    endpoints, else linear; r is relative to the anchor camera depth."""

    def interp(vals):
        vals = np.asarray(vals, dtype=np.float64)
        if len(vals) > 3:
            out = txt_interpolation(vals, frames, "smooth")
            out[0], out[-1] = vals[0], vals[-1]
        else:
            out = txt_interpolation(vals, frames, "linear")
        return out

    phis, thetas = interp(phi), interp(theta)
    rs = interp(r) * c2w_anchor[2, 3]
    return np.stack([sphere2pose(c2w_anchor, t, p, rr) for t, p, rr in zip(thetas, phis, rs)])


# ---------------------------------------------------------------------------
# B-spline interpolation between keyframe poses (sparse-view interp mode)
# ---------------------------------------------------------------------------


def _normalize(v):
    return v / np.linalg.norm(v)


def _viewmatrix(lookdir, up, position):
    vec2 = _normalize(lookdir)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def interpolate_poses_spline(poses: np.ndarray, n_interp: int, spline_degree: int = 5,
                             smoothness: float = 0.03, rot_weight: float = 0.1) -> np.ndarray:
    """Smooth B-spline path through (position, lookat, up) keyframe triplets
    (utils/pvd_utils.py:154-215). poses: (n, 3or4, 4) c2w; returns
    (n_interp*(n-1), 4, 4)."""
    pos = poses[:, :3, 3]
    lookat = pos - rot_weight * poses[:, :3, 2]
    up = pos + rot_weight * poses[:, :3, 1]
    points = np.stack([pos, lookat, up], axis=1)  # (n, 3, 3)

    sh = points.shape
    pts = points.reshape(sh[0], -1)
    k = min(spline_degree, sh[0] - 1)
    tck, _ = sp_interp.splprep(pts.T, k=k, s=smoothness)
    u = np.linspace(0, 1, n_interp * (sh[0] - 1), endpoint=False)
    new_points = np.array(sp_interp.splev(u, tck)).T.reshape(-1, sh[1], sh[2])

    mats = np.array([_viewmatrix(p - l, u_ - p, p) for p, l, u_ in new_points])
    out = np.tile(np.eye(4, dtype=np.float32), (len(mats), 1, 1))
    out[:, :3, :] = mats
    return out


def interp_traj(c2ws: np.ndarray, n_inserts: int = 25) -> np.ndarray:
    """Chain pairwise spline segments through all keyframes, dropping each
    segment's duplicate endpoint (utils/pvd_utils.py:217-232)."""
    segs: List[np.ndarray] = []
    for i in range(len(c2ws) - 1):
        seg = interpolate_poses_spline(np.stack([c2ws[i], c2ws[i + 1]])[:, :3, :], n_inserts)
        segs.append(seg[:-1])
    segs.append(c2ws[-1:])
    return np.concatenate(segs, axis=0).astype(np.float32)


def interpolate_sequence(values: np.ndarray, n_inserts: int) -> np.ndarray:
    """Linear interpolation of per-keyframe scalars/vectors (focals, principal
    points) to match interp_traj's frame count (utils/pvd_utils.py: interpolate_sequence)."""
    values = np.asarray(values, dtype=np.float64)
    n = len(values)
    out: List[np.ndarray] = []
    for i in range(n - 1):
        a, b = values[i], values[i + 1]
        ts = np.linspace(0, 1, n_inserts + 2)[:-1]  # include start, drop end
        out.extend([(1 - t) * a + t * b for t in ts])
    out.append(values[-1])
    return np.asarray(out, dtype=np.float32)


def focus_point_fn(c2ws: np.ndarray) -> np.ndarray:
    """Closest point to all camera focal axes (utils/pvd_utils.py:374-381)."""
    directions = c2ws[:, :3, 2:3]
    origins = c2ws[:, :3, 3:4]
    m = np.eye(3)[None] - directions * directions.transpose(0, 2, 1)
    mt_m = m.transpose(0, 2, 1) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def interpolate_poses(start_pose: np.ndarray, end_pose: np.ndarray, focus_point: np.ndarray,
                      n_inserts: int = 15) -> np.ndarray:
    """Slerp rotations + arc positions at interpolated distance from the focus
    point (utils/pvd_utils.py:402-435)."""
    d0 = np.linalg.norm(start_pose[:3, 3] - focus_point)
    d1 = np.linalg.norm(end_pose[:3, 3] - focus_point)
    rots = Rotation.from_matrix(np.stack([start_pose[:3, :3], end_pose[:3, :3]]))
    slerp = Slerp([0, 1], rots)
    out = []
    for t in np.linspace(0.0, 1.0, n_inserts + 2):
        trans = (1 - t) * start_pose[:3, 3] + t * end_pose[:3, 3]
        dist = (1 - t) * d0 + t * d1
        direction = _normalize(trans - focus_point)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = slerp(t).as_matrix()
        pose[:3, 3] = focus_point + direction * dist
        out.append(pose)
    return np.stack(out)


def generate_camera_path(c2ws: np.ndarray, n_inserts: int = 15) -> np.ndarray:
    """Focus-point slerp path through all keyframes (utils/pvd_utils.py:383-400)."""
    segs: List[np.ndarray] = []
    for i in range(len(c2ws) - 1):
        fp = focus_point_fn(np.stack([c2ws[i], c2ws[i + 1]]))
        seg = interpolate_poses(c2ws[i], c2ws[i + 1], fp, n_inserts)
        segs.append(seg[:-1])
    segs.append(c2ws[-1:])
    return np.concatenate(segs, axis=0)


def generate_candidate_poses(c2w_anchor: np.ndarray, theta: float, phi: float,
                             num_candidates: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """NBV candidate poses (utils/pvd_utils.py:121-152)."""
    if num_candidates == 2:
        thetas, phis = np.array([0.0, -theta]), np.array([phi, phi])
    elif num_candidates == 3:
        thetas, phis = np.array([0.0, -theta, theta / 2.0]), np.array([phi, phi, phi])
    else:
        raise ValueError("NBV mode supports 2 or 3 candidates per iteration")
    c2ws = np.stack([sphere2pose(c2w_anchor, t, p, None) for t, p in zip(thetas, phis)])
    return c2ws, thetas, phis
