"""Quaternion / rotation helpers (xyzw convention, matching roma's
RigidUnitQuat used by the reference at base_opt.py:146-151).

The port of the JAX package's `align/rotations.py`: the device-side
functions on torch tensors (differentiable, for the aligner's loss), the
host-side ones on numpy, as there.
"""

from __future__ import annotations

import numpy as np
import torch


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalizes and converts quaternions (..., 4) [x,y,z,w] to
    rotation matrices (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (4,) [x,y,z,w] (host-side, Shepperd's method)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def signed_log1p(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def signed_expm1(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.expm1(torch.abs(x))


def pose_vec_to_mat(vec: torch.Tensor, scale: torch.Tensor | None = None) -> torch.Tensor:
    """7-vector [quat(4), signed_log1p-translation(3)] (+ optional log-scale)
    -> 4x4 cam-to-world, with the scale multiplying rotation AND translation
    (base_opt.py:146-151,187-191)."""
    R = quat_to_rot(vec[..., :4])
    T = signed_expm1(vec[..., 4:7])
    top = torch.cat([R, T[..., None]], dim=-1)
    if scale is not None:
        top = top * torch.exp(scale)[..., None, None]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
    return torch.cat([top, bottom.expand(top[..., :1, :].shape)], dim=-2)


def mat_to_pose_vec(mat: np.ndarray) -> np.ndarray:
    """4x4 rigid -> 7-vector [quat(xyzw), signed_log1p(T)] (host-side)."""
    q = rot_to_quat(np.asarray(mat)[:3, :3])
    t = np.asarray(mat)[:3, 3]
    t = np.sign(t) * np.log1p(np.abs(t))
    return np.concatenate([q, t]).astype(np.float32)
