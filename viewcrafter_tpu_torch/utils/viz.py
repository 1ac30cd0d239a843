"""Scene visualization export: colored point clouds + camera frustum meshes.

File-based analog of the reference's trimesh SceneViz
(extern/dust3r/dust3r/viz.py:118-155 add_pointcloud/add_camera/show and
:192-258 add_scene_cam): trimesh isn't bundled here and this framework is
headless, so `save_ply` writes one combined mesh-PLY (point vertices +
camera-cone triangles) that any viewer (MeshLab, Blender, Open3D) opens.

Cameras are drawn as the same screen-width pyramid the reference builds:
apex at the camera center, base one focal-length ahead, scaled by cam_size.

The port's own copy of the JAX package's `utils/viz.py` (numpy only).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def auto_cam_size(c2ws) -> float:
    """10% of the max inter-camera distance (viz.py:114-115)."""
    t = np.asarray(c2ws)[:, :3, 3]
    if len(t) < 2:
        return 0.03
    d = np.linalg.norm(t[:, None] - t[None, :], axis=-1)
    return max(1e-3, 0.1 * float(d.max()))


class SceneViz:
    """Accumulate geometry; save as a single PLY.

    API parity: add_pointcloud(pts, color, mask), add_camera(pose_c2w,
    focal, color, imsize, cam_size), add_cameras(...), save_ply(path)
    (reference .show() opens a window — headless here).
    """

    def __init__(self):
        self._verts: list = []
        self._colors: list = []
        self._faces: list = []

    # -- point clouds -------------------------------------------------------

    def add_pointcloud(self, pts3d, color=(128, 128, 128), mask=None) -> "SceneViz":
        pts = np.asarray(pts3d, np.float32).reshape(-1, 3)
        col = np.asarray(color)
        if col.ndim <= 1:
            col = np.broadcast_to(col.reshape(1, 3), pts.shape)
        else:
            col = col.reshape(-1, 3)
        if mask is not None:
            m = np.asarray(mask, bool).reshape(-1)
            pts, col = pts[m], col[m]
        self._verts.append(pts)
        self._colors.append(_uint8(col))
        return self

    # -- cameras ------------------------------------------------------------

    def add_camera(self, pose_c2w, focal: Optional[float] = None,
                   color=(30, 144, 255), imsize=(1024, 576),
                   cam_size: float = 0.03) -> "SceneViz":
        pose = np.asarray(pose_c2w, np.float32)
        w, h = imsize
        f = float(focal) if focal is not None else 1.1 * max(w, h)
        # pyramid in camera frame (RDF): apex at origin, base at z = depth
        depth = cam_size * f / max(w, h) * 2.0
        hw = cam_size * w / max(w, h)
        hh = cam_size * h / max(w, h)
        local = np.array([
            [0.0, 0.0, 0.0],
            [-hw, -hh, depth],
            [+hw, -hh, depth],
            [+hw, +hh, depth],
            [-hw, +hh, depth],
        ], np.float32)
        world = local @ pose[:3, :3].T + pose[:3, 3]
        base = sum(len(v) for v in self._verts)
        faces = np.array([
            [0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1],  # sides
            [1, 2, 3], [1, 3, 4],  # base
        ]) + base
        self._verts.append(world)
        self._colors.append(np.broadcast_to(_uint8(np.asarray(color)), (5, 3)).copy())
        self._faces.append(faces)
        return self

    def add_cameras(self, poses, focals=None, imsizes=None, colors=None,
                    cam_size: Optional[float] = None) -> "SceneViz":
        poses = np.asarray(poses)
        cs = cam_size if cam_size is not None else auto_cam_size(poses)

        def get(arr, i):
            return None if arr is None else arr[i]

        for i, pose in enumerate(poses):
            self.add_camera(
                pose, focal=get(focals, i),
                color=get(colors, i) if colors is not None else (30, 144, 255),
                imsize=tuple(get(imsizes, i)) if imsizes is not None else (1024, 576),
                cam_size=cs,
            )
        return self

    # -- output -------------------------------------------------------------

    def save_ply(self, path: str) -> str:
        verts = np.concatenate(self._verts) if self._verts else np.zeros((0, 3), np.float32)
        cols = np.concatenate(self._colors) if self._colors else np.zeros((0, 3), np.uint8)
        faces = np.concatenate(self._faces) if self._faces else np.zeros((0, 3), np.int64)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fp:
            fp.write("ply\nformat ascii 1.0\n")
            fp.write(f"element vertex {len(verts)}\n")
            fp.write("property float x\nproperty float y\nproperty float z\n")
            fp.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
            fp.write(f"element face {len(faces)}\n")
            fp.write("property list uchar int vertex_indices\n")
            fp.write("end_header\n")
            for p, c in zip(verts, cols):
                fp.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
            for f in faces:
                fp.write(f"3 {f[0]} {f[1]} {f[2]}\n")
        return path


def _uint8(c) -> np.ndarray:
    c = np.asarray(c)
    if c.dtype.kind == "f":
        c = np.clip(c, 0, 1) * 255
    return c.astype(np.uint8)


def save_scene_ply(path: str, pts3d, colors, c2ws, focals=None,
                   imsizes=None, mask=None) -> str:
    """One-call export: point cloud + camera trajectory frustums."""
    viz = SceneViz()
    viz.add_pointcloud(pts3d, colors, mask=mask)
    viz.add_cameras(c2ws, focals=focals, imsizes=imsizes)
    return viz.save_ply(path)
