"""Co3D_v2 two-view dataset for DUSt3R training: the port's copy of the JAX
package's `data/co3d.py`, unprojecting through the port's
`geometry/transforms.py` on the CPU (float32, as jnp computes it there).

Parity target: extern/dust3r/dust3r/datasets/co3d.py (+ the relevant parts of
base/base_stereo_view_dataset.py): preprocessed-Co3D directory layout
(`<root>/<category>/<instance>/{images,depths,masks}/frame%06d.*` with a
per-frame .npz of camera_pose / camera_intrinsics / maximum_depth and a
`selected_seqs_<split>.json` index), pair sampling at |i-j| in {5,10,..,30}
over the 100-frame turntable, background masking through the depth, and
principal-point-centered crop/resize with intrinsics adjustment.

Differences from the reference (a host pipeline):
  - PIL instead of cv2 (cv2 isn't a dependency here); 16-bit depth PNGs read
    as uint16 arrays;
  - returns loss-ready view dicts (img in [-1,1], world-frame pts3d computed
    eagerly from depth+intrinsics+pose, valid_mask) matching
    models/dust3r_losses.py's gt schema — the reference defers pts3d to
    BaseStereoViewDataset.__getitem__;
  - per-index determinism: the frame jitter derives from (seed, idx), so a
    resumed epoch re-reads identical pairs.
"""

from __future__ import annotations

import itertools
import json
import os
import os.path as osp
from typing import Dict, List, Sequence, Tuple

import numpy as np

import torch

from viewcrafter_tpu_torch.geometry.transforms import as_f32, depthmap_to_pts3d, geotrf


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def _load_depth16(path: str) -> np.ndarray:
    from PIL import Image

    d = np.asarray(Image.open(path))
    return d.astype(np.float32)


def _load_mask(path: str) -> np.ndarray:
    from PIL import Image

    m = np.asarray(Image.open(path)).astype(np.float32)
    return (m / 255.0) > 0.1


def crop_resize_with_intrinsics(
    img: np.ndarray, depth: np.ndarray, K: np.ndarray, resolution: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Crop the largest principal-point-centered window with the target
    aspect, then resize; K is adjusted to stay metrically consistent
    (base_stereo_view_dataset.py:137-181 semantics, without the training-time
    random aug_crop)."""
    from PIL import Image

    th, tw = resolution
    h, w = depth.shape
    cx, cy = float(K[0, 2]), float(K[1, 2])
    # largest centered crop with target aspect
    half_w = min(cx, w - cx)
    half_h = min(cy, h - cy)
    if half_w / half_h > tw / th:
        half_w = half_h * tw / th
    else:
        half_h = half_w * th / tw
    l, t = int(round(cx - half_w)), int(round(cy - half_h))
    r, b = int(round(cx + half_w)), int(round(cy + half_h))
    l, t = max(0, l), max(0, t)
    r, b = min(w, r), min(h, b)
    img_c = img[t:b, l:r]
    depth_c = depth[t:b, l:r]
    K2 = K.copy()
    K2[0, 2] -= l
    K2[1, 2] -= t

    ch, cw = depth_c.shape
    img_r = np.asarray(Image.fromarray(img_c).resize((tw, th), Image.BICUBIC))
    # NEAREST for depth: bilinear blends depth discontinuities into phantom
    # surfaces (the reference uses nearest for depth too, cropping.py)
    depth_r = np.asarray(
        Image.fromarray(depth_c).resize((tw, th), Image.NEAREST)
    )
    sx, sy = tw / cw, th / ch
    K3 = K2.copy()
    K3[0] *= sx
    K3[1] *= sy
    return img_r, depth_r.astype(np.float32), K3.astype(np.float32)


@torch.no_grad()
def world_points(depth: np.ndarray, K: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """World-frame points (H, W, 3) float32 of a depth map (H, W) seen by a
    pinhole K (3, 3) with camera-to-world `pose` (4, 4): unprojected in the
    camera frame, then moved by the pose, on the CPU."""
    pts_cam = depthmap_to_pts3d(as_f32(depth), as_f32(K))
    return geotrf(as_f32(pose)[None], pts_cam.reshape(1, -1, 3))[0].reshape(pts_cam.shape).numpy()


class Co3dPairDataset:
    """Index = scene x (i, j) frame-pair combination; item = (view1, view2)
    dicts ready for models/dust3r_losses.py."""

    def __init__(
        self,
        root: str,
        split: str = "train",
        resolution: Tuple[int, int] = (224, 224),
        mask_bg: bool = True,
        num_frames: int = 100,
        max_step: int = 30,
        angle_step: int = 5,
        jitter: int = 4,
        seed: int = 0,
    ):
        self.root = root
        self.resolution = resolution
        self.mask_bg = mask_bg
        self.jitter = jitter
        self.seed = seed
        with open(osp.join(root, f"selected_seqs_{split}.json")) as f:
            raw = json.load(f)
        self.scenes: Dict[Tuple[str, str], List[int]] = {
            (cat, inst): frames
            for cat, instances in raw.items()
            for inst, frames in instances.items()
            if frames
        }
        self.scene_list = sorted(self.scenes.keys())
        # ~3.6 deg per turntable frame: pairs 5..30 frames apart (co3d.py:44-47)
        self.combinations = [
            (i, j)
            for i, j in itertools.combinations(range(num_frames), 2)
            if 0 < abs(i - j) <= max_step and abs(i - j) % angle_step == 0
        ]

    def __len__(self) -> int:
        return len(self.scene_list) * len(self.combinations)

    def _frame_paths(self, cat: str, inst: str, view_idx: int):
        base = osp.join(self.root, cat, inst)
        return (
            osp.join(base, "images", f"frame{view_idx:06d}.jpg"),
            osp.join(base, "depths", f"frame{view_idx:06d}.jpg.geometric.png"),
            osp.join(base, "masks", f"frame{view_idx:06d}.png"),
            osp.join(base, "images", f"frame{view_idx:06d}.npz"),
        )

    def _load_view(self, cat: str, inst: str, pool: Sequence[int], im_idx: int) -> Dict:
        view_idx = pool[max(0, min(im_idx, len(pool) - 1))]
        impath, dpath, mpath, metapath = self._frame_paths(cat, inst, view_idx)
        meta = np.load(metapath)
        pose = meta["camera_pose"].astype(np.float32)  # c2w
        K = meta["camera_intrinsics"].astype(np.float32)
        img = _load_image(impath)
        depth = _load_depth16(dpath) / 65535.0 * float(np.nan_to_num(meta["maximum_depth"]))
        if self.mask_bg and osp.exists(mpath):
            depth = depth * _load_mask(mpath)
        img, depth, K = crop_resize_with_intrinsics(img, depth, K, self.resolution)

        pts_world = world_points(depth, K, pose)
        return {
            "img": (img.astype(np.float32) / 127.5 - 1.0),
            "pts3d": pts_world.astype(np.float32),
            "valid_mask": (depth > 0.0) & np.isfinite(pts_world).all(-1),
            "camera_pose": pose,
            "camera_intrinsics": K,
            "label": f"{cat}/{inst}",
            "instance": f"frame{view_idx:06d}",
        }

    def __getitem__(self, idx: int) -> Tuple[Dict, Dict]:
        scene_idx, comb_idx = divmod(idx, len(self.combinations))
        cat, inst = self.scene_list[scene_idx]
        pool = self.scenes[(cat, inst)]
        i, j = self.combinations[comb_idx]
        rng = np.random.default_rng((self.seed, idx))
        if self.jitter:
            i = int(np.clip(i + rng.integers(-self.jitter, self.jitter + 1), 0, len(pool) - 1))
            j = int(np.clip(j + rng.integers(-self.jitter, self.jitter + 1), 0, len(pool) - 1))
        return self._load_view(cat, inst, pool, i), self._load_view(cat, inst, pool, j)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
