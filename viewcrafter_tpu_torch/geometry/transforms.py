"""Pose / point transforms on torch tensors, float32 as in the JAX package.

The port of the JAX package's `geometry/transforms.py` (there `jnp` with x64
off, so float32; the callers pass float64 numpy poses through `as_f32`).

Parity targets:
  - geotrf batched homogeneous transforms:
    extern/dust3r/dust3r/utils/geometry.py:40-101
  - world re-anchoring to the k-th camera / object center:
    utils/pvd_utils.py:506-556
  - depth <-> pts3d unprojection: extern/dust3r/dust3r/utils/geometry.py:114-217

Coordinate convention: OpenCV/COLMAP RDF (x right, y down, z forward),
DUSt3R's native frame; the rasterizer consumes RDF pinhole cameras directly.
"""

from __future__ import annotations

import numpy as np
import torch


def as_f32(x, device=None) -> torch.Tensor:
    """A float32 tensor of `x` (numpy of any float type, or a tensor)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def geotrf(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 (or batched ...x4x4) homogeneous transform(s) to 3D points.

    T: (..., 4, 4); pts: (..., N, 3) or (N, 3) broadcastable against T's batch.
    """
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def inv_se3(T: torch.Tensor) -> torch.Tensor:
    """Inverse of (batched) rigid transform(s) without a general solve."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=T.dtype, device=T.device)
    bottom = bottom.expand(T[..., :1, :].shape)
    top = torch.cat([Rt, ti[..., None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def world_to_kth(poses: torch.Tensor, k: int) -> torch.Tensor:
    """Re-anchor world frame to camera k (utils/pvd_utils.py:506-511)."""
    return inv_se3(poses[k])[None] @ poses


def world_point_to_kth(poses: torch.Tensor, points: torch.Tensor, k: int):
    """Re-anchor poses AND per-view pointmaps to camera k
    (utils/pvd_utils.py:513-525). points: (N, H, W, 3)."""
    inv_k = inv_se3(poses[k])
    new_poses = inv_k[None] @ poses
    n, h, w, _ = points.shape
    new_pts = geotrf(inv_k, points.reshape(n, h * w, 3)).reshape(n, h, w, 3)
    return new_poses, new_pts


def object_anchor_pose(r: float, elevation_deg: float, device=None) -> torch.Tensor:
    """Pose of the object-centric frame: origin at [0,0,r] in the anchor camera
    frame, tilted by (180 - elevation) about x (utils/pvd_utils.py:528-547).
    The angle's cosine and sine are taken in float32, as in the JAX package."""
    e = torch.deg2rad(torch.tensor(180.0 - elevation_deg, dtype=torch.float32, device=device))
    c, s = torch.cos(e), torch.sin(e)
    T = torch.eye(4, dtype=torch.float32, device=device)
    T[1, 1], T[1, 2], T[2, 1], T[2, 2] = c, s, -s, c
    T[2, 3] = r
    return T


def world_point_to_obj(poses: torch.Tensor, points: torch.Tensor, k: int, r: float,
                       elevation_deg: float):
    """Re-anchor world to the object center at depth r in front of camera k,
    with an elevation tilt (utils/pvd_utils.py:528-556)."""
    poses, points = world_point_to_kth(poses, points, k)
    inv_obj = inv_se3(object_anchor_pose(r, elevation_deg, device=poses.device))
    new_poses = inv_obj[None] @ poses
    n, h, w, _ = points.shape
    new_pts = geotrf(inv_obj, points.reshape(n, h * w, 3)).reshape(n, h, w, 3)
    return new_poses, new_pts


def depthmap_to_pts3d(depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Unproject depth (..., H, W) with pinhole K (..., 3, 3) to camera-frame
    points (..., H, W, 3) (cf. dust3r/utils/geometry.py:114-147)."""
    h, w = depth.shape[-2:]
    u = torch.arange(w, dtype=torch.float32, device=depth.device)
    v = torch.arange(h, dtype=torch.float32, device=depth.device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    fx = intrinsics[..., 0, 0][..., None, None]
    fy = intrinsics[..., 1, 1][..., None, None]
    cx = intrinsics[..., 0, 2][..., None, None]
    cy = intrinsics[..., 1, 2][..., None, None]
    x = depth * (uu - cx) / fx
    y = depth * (vv - cy) / fy
    return torch.stack([x, y, depth], dim=-1)


def make_intrinsics(focal, pp) -> np.ndarray:
    """focal: (N,) or (N,2); pp: (N,2) -> (N,3,3) pinhole K matrices (host
    numpy, float32)."""
    focal = np.asarray(focal, np.float32)
    pp = np.asarray(pp, np.float32)
    n = pp.shape[0]
    if focal.ndim == 1:
        focal = np.stack([focal, focal], axis=-1)
    K = np.zeros((n, 3, 3), np.float32)
    K[:, 0, 0] = focal[:, 0]
    K[:, 1, 1] = focal[:, 1]
    K[:, 0, 2] = pp[:, 0]
    K[:, 1, 2] = pp[:, 1]
    K[:, 2, 2] = 1.0
    return K

