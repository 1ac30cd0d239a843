"""Synthetic multiview pair generator for CroCo pretraining and DUSt3R
fine-tuning: the port's copy of the JAX package's `data/synth_multiview.py`,
rendering through the port's rasterizer (`ops/rasterize.py`) on a torch
device.

The analog of the reference's habitat-sim data generator
(extern/dust3r/croco/datasets/habitat_sim/multiview_habitat_sim_generator.py:121-350),
which renders co-visible RGB-D view sets of indoor scenes with habitat-sim
(a GPU C++ simulator, absent here) to feed CroCo's cross-view completion
pretraining. This module gives the same capability (covisibility-filtered
multiview RGB-D sets with exact intrinsics and poses) from procedural
point-cloud scenes, so the pretraining path runs end to end with no
simulator and no scene assets.

Semantics mirrored from the reference generator:
  - viewpoint sampling: random yaw plus pan/tilt/roll noise (pan 3 deg,
    tilt 10 deg, roll 5 deg), camera height ~ U(1.2, 1.8)
    (multiview_habitat_sim_generator.py:144-150, 227-236);
  - secondary viewpoints: a random walk in the ground plane (5 steps of
    variance 2.0), then a look-at toward the mean observed point plus the
    same orientation noise (:237-254);
  - validity: the share of defined depth >= minimum_valid_fraction (0.7);
    covisibility = the smaller of the two symmetric point-cloud overlap
    shares at a distance threshold (0.05 m), kept if >=
    minimum_covisibility (:256-266);
  - per view: an rgb image, a depthmap, an OpenCV/RDF camera_pose (camera to
    world) and pinhole camera_intrinsics from hfov (:17-25, 69-82).

Differences by design: scenes are procedural colored point clouds (a
heightfield floor, walls, random boxes and ellipsoids) instead of scanned
meshes; rendering is the port's PyTorch3D-semantics point rasterizer.

Reproducibility: `_scene` and `__getitem__` seed numpy from Python's
`hash` of a tuple holding a string, as the JAX package does. That hash is
salted per process (PYTHONHASHSEED), so both packages draw the same scenes
within one process, and other scenes in another.

The generator renders on `device`: the card unless the caller asks for the
CPU (`device="cpu"`), as every entry point of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

import torch

from viewcrafter_tpu_torch.data.co3d import world_points
from viewcrafter_tpu_torch.models.lvdm import resolve_device
from viewcrafter_tpu_torch.ops.rasterize import rasterize_points


def camera_intrinsics_from_hfov(height: int, width: int, hfov_deg: float) -> np.ndarray:
    """Pinhole K with square pixels; hfov spans the image WIDTH
    (habitat convention, multiview_habitat_sim_generator.py:17-20)."""
    f = width / 2.0 / np.tan(np.deg2rad(hfov_deg) / 2.0)
    return np.array(
        [[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0.0, 0.0, 1.0]],
        dtype=np.float64,
    )


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def look_at_rdf(eye: np.ndarray, center: np.ndarray, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """c2w rotation looking from eye toward center, OpenCV/RDF axes
    (+Z forward, +Y down, +X right). `up` is the world up direction
    expressed in RDF world coords (world -Y is up here)."""
    fwd = np.asarray(center, np.float64) - np.asarray(eye, np.float64)
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    upv = -np.asarray(up, np.float64)  # world "down" for the +Y-down frame
    right = np.cross(upv, fwd)
    n = np.linalg.norm(right)
    if n < 1e-8:  # looking straight up/down: pick an arbitrary right
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / n
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=1)  # columns = camera axes in world


def orientation_noise(rng: np.random.Generator,
                      pan_range=(-3, 3), tilt_range=(-10, 10), roll_range=(-5, 5)) -> np.ndarray:
    """Small pan(yaw)/tilt(pitch)/roll rotation, degrees — reference ranges
    (multiview_habitat_sim_generator.py:111-115, 144-147)."""
    pan = np.deg2rad(rng.uniform(*pan_range))
    tilt = np.deg2rad(rng.uniform(*tilt_range))
    roll = np.deg2rad(rng.uniform(*roll_range))
    return _rot_y(pan) @ _rot_x(tilt) @ _rot_z(roll)


def pointcloud_overlap(pc1: np.ndarray, pc2: np.ndarray, threshold: float) -> Tuple[int, int]:
    """Symmetric nearest-neighbour overlap counts: #points of pc1 within
    `threshold` of pc2 and vice versa (compute_pointcloud_overlaps_scikit,
    multiview_habitat_sim_generator.py:50-66)."""
    if len(pc1) == 0 or len(pc2) == 0:
        return 0, 0
    from scipy.spatial import cKDTree

    t2 = cKDTree(pc2)
    d1, _ = t2.query(pc1, k=1, distance_upper_bound=threshold)
    t1 = cKDTree(pc1)
    d2, _ = t1.query(pc2, k=1, distance_upper_bound=threshold)
    return int(np.isfinite(d1).sum()), int(np.isfinite(d2).sum())


@dataclasses.dataclass
class SceneConfig:
    """Procedural scene: heightfield floor + random solid primitives inside
    an extent_x × extent_z room (meters; world +Y points DOWN, floor at y=0)."""

    extent: Tuple[float, float] = (8.0, 8.0)
    floor_points: int = 60_000
    n_primitives: int = 12
    primitive_points: int = 6_000
    primitive_size: Tuple[float, float] = (0.3, 1.2)
    wall_height: float = 3.0
    wall_points: int = 40_000


def build_scene(rng: np.random.Generator, cfg: SceneConfig = SceneConfig()) -> Tuple[np.ndarray, np.ndarray]:
    """Random colored point-cloud room -> (points (N,3) float32, colors (N,3) in [0,1]).

    World frame is RDF-compatible: +Y down, floor plane y=0, cameras at
    y = -height. Colors are low-frequency value noise so crops carry texture
    signal for cross-view completion."""
    ex, ez = cfg.extent
    pts = []
    # floor heightfield (gentle bumps)
    f = rng.uniform([-ex / 2, 0, -ez / 2], [ex / 2, 0, ez / 2], size=(cfg.floor_points, 3))
    f[:, 1] = -0.15 * (np.sin(1.7 * f[:, 0]) * np.cos(1.3 * f[:, 2]) + rng.normal(0, 0.05, len(f)))
    pts.append(f)
    # four walls
    w = rng.uniform(0, 1, size=(cfg.wall_points, 3))
    side = rng.integers(0, 4, cfg.wall_points)
    wx = np.where(side == 0, -ex / 2, np.where(side == 1, ex / 2, (w[:, 0] - 0.5) * ex))
    wz = np.where(side == 2, -ez / 2, np.where(side == 3, ez / 2, (w[:, 2] - 0.5) * ez))
    wy = -w[:, 1] * cfg.wall_height
    pts.append(np.stack([wx, wy, wz], axis=1))
    # solid primitives resting on the floor
    for _ in range(cfg.n_primitives):
        size = rng.uniform(*cfg.primitive_size)
        ctr = np.array([rng.uniform(-ex / 2 + 1, ex / 2 - 1), -size / 2, rng.uniform(-ez / 2 + 1, ez / 2 - 1)])
        u = rng.normal(size=(cfg.primitive_points, 3))
        if rng.uniform() < 0.5:  # box surface
            u = np.clip(u, -1, 1)
            face = rng.integers(0, 3, cfg.primitive_points)
            sign = rng.choice([-1.0, 1.0], cfg.primitive_points)
            u[np.arange(cfg.primitive_points), face] = sign
        else:  # ellipsoid surface
            u = u / (np.linalg.norm(u, axis=1, keepdims=True) + 1e-9)
        scale = rng.uniform(0.5, 1.0, size=3) * size / 2
        pts.append(ctr + u * scale)
    points = np.concatenate(pts, axis=0).astype(np.float32)
    # low-frequency procedural color (3 phase-shifted value-noise channels)
    phases = rng.uniform(0, 2 * np.pi, size=(3, 3))
    freqs = rng.uniform(0.8, 2.5, size=(3, 3))
    colors = 0.5 + 0.5 * np.sin(points @ freqs.T + phases[:, 0])
    colors = np.clip(colors, 0.0, 1.0).astype(np.float32)
    return points, colors


class SyntheticMultiviewGenerator:
    """Drop-in analog of MultiviewHabitatSimGenerator: index in, a
    covisibility-filtered multiview RGB-D observation set out.

    Each item: list of `views_count` dicts with keys
      img (H,W,3) uint8, depthmap (H,W) float32 (0 = undefined),
      camera_pose (4,4) c2w RDF, camera_intrinsics (3,3),
    plus pairwise `covisibility` of views 1.. vs view 0 — the exact fields
    the reference writes to disk per view (generate_multiview_images.py via
    _append_camera_parameters, multiview_habitat_sim_generator.py:69-82).
    """

    def __init__(
        self,
        resolution: Tuple[int, int] = (240, 320),
        views_count: int = 2,
        hfov: float = 60.0,
        size: int = 10_000,
        minimum_covisibility: float = 0.5,
        minimum_valid_fraction: float = 0.7,
        distance_threshold: float = 0.05,
        max_attempts_count: int = 100,
        scene_cfg: SceneConfig = SceneConfig(),
        scenes_pool: int = 16,
        seed: int = 0,
        z_order: str = "packed",
        splat_px: float = 3.5,
        device=None,
    ):
        self.resolution = tuple(resolution)
        self.views_count = int(views_count)
        assert self.views_count >= 1
        self.hfov = float(hfov)
        self.size = int(size)
        self.minimum_covisibility = float(minimum_covisibility)
        self.minimum_valid_fraction = float(minimum_valid_fraction)
        self.distance_threshold = float(distance_threshold)
        self.max_attempts_count = int(max_attempts_count)
        self.scene_cfg = scene_cfg
        self.scenes_pool = int(scenes_pool)
        self.seed = int(seed)
        self.z_order = z_order
        self.splat_px = float(splat_px)
        self.height_range = (1.2, 1.8)
        self.random_steps_count = 5
        self.random_step_variance = 2.0
        self.K = camera_intrinsics_from_hfov(*self.resolution, hfov_deg=self.hfov)
        self.device = resolve_device(device)
        self._scene_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._device_points: Dict[int, torch.Tensor] = {}

    def __len__(self) -> int:
        return self.size

    # -- scene / camera sampling ------------------------------------------
    def _scene(self, scene_id: int) -> Tuple[np.ndarray, np.ndarray]:
        scene_id = scene_id % self.scenes_pool
        if scene_id not in self._scene_cache:
            rng = np.random.default_rng(hash(("scene", self.seed, scene_id)) % (2**32))
            self._scene_cache[scene_id] = build_scene(rng, self.scene_cfg)
        return self._scene_cache[scene_id]

    def sample_random_viewpoint(self, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        ex, ez = self.scene_cfg.extent
        nav = np.array([rng.uniform(-ex / 2 + 0.5, ex / 2 - 0.5), 0.0,
                        rng.uniform(-ez / 2 + 0.5, ez / 2 - 0.5)])
        pos = nav + np.array([0.0, -rng.uniform(*self.height_range), 0.0])  # -Y is up
        yaw = _rot_y(rng.uniform(0, 2 * np.pi))
        rot = yaw @ orientation_noise(rng)
        return pos, rot

    def sample_other_random_viewpoint(
        self, rng: np.random.Generator, observed_point: np.ndarray, nav_point: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        ex, ez = self.scene_cfg.extent
        nav = nav_point.copy()
        for _ in range(self.random_steps_count):
            step = self.random_step_variance * rng.normal(size=3) * np.array([1.0, 0.0, 1.0])
            cand = nav + step
            # "snap": stay inside the room (the navmesh analog)
            cand[0] = np.clip(cand[0], -ex / 2 + 0.5, ex / 2 - 0.5)
            cand[2] = np.clip(cand[2], -ez / 2 + 0.5, ez / 2 - 0.5)
            nav = cand
        pos = nav + np.array([0.0, -rng.uniform(*self.height_range), 0.0])
        rot = look_at_rdf(pos, observed_point) @ orientation_noise(rng)
        return pos, rot

    # -- rendering ----------------------------------------------------------
    def render_viewpoint(self, scene_id: int, position: np.ndarray, rotation: np.ndarray) -> Dict:
        """Rasterize the scene from a camera -> rgb / depth / valid mask.

        Depth is the alpha-composited splat z divided by the composited
        coverage: for near-opaque front splats the front surface's depth
        (the habitat depth sensor's analog)."""
        points, colors = self._scene(scene_id)
        key = scene_id % self.scenes_pool
        if key not in self._device_points:
            self._device_points[key] = torch.from_numpy(points).to(self.device)
        h, w = self.resolution
        c2w = np.eye(4)
        c2w[:3, :3] = rotation
        c2w[:3, 3] = position
        w2c = np.linalg.inv(c2w)
        z_cam = (points @ w2c[:3, :3].T + w2c[:3, 3])[:, 2:3]
        feats = np.concatenate([colors, z_cam, np.ones_like(z_cam)], axis=1).astype(np.float32)
        # splat radius in pixels (default ~3.5 px) — point-cloud scenes need
        # finite-area splats for watertight-ish coverage at any resolution
        radius_ndc = 2.0 * self.splat_px / min(h, w)
        dev = self.device
        with torch.no_grad():
            img = rasterize_points(
                self._device_points[key], torch.from_numpy(feats).to(dev),
                torch.as_tensor(w2c, dtype=torch.float32, device=dev),
                torch.as_tensor(self.K, dtype=torch.float32, device=dev), h, w,
                radius_ndc=radius_ndc, points_per_pixel=8, z_order=self.z_order)
        img = img.cpu().numpy()
        alpha = img[..., 4]
        valid = alpha > 0.3
        rgb = np.clip(np.divide(img[..., :3], alpha[..., None], where=alpha[..., None] > 1e-6, out=np.zeros_like(img[..., :3])), 0, 1)
        depth = np.where(valid, np.divide(img[..., 3], alpha, where=alpha > 1e-6, out=np.zeros_like(alpha)), 0.0)
        return {
            "img": (rgb * 255).astype(np.uint8),
            "depthmap": depth.astype(np.float32),
            "valid": valid,
            "camera_pose": c2w.astype(np.float32),
            "camera_intrinsics": self.K.astype(np.float32),
        }

    def _unproject(self, obs: Dict) -> np.ndarray:
        h, w = self.resolution
        yy, xx = np.mgrid[0:h, 0:w]
        m = obs["valid"]
        z = obs["depthmap"][m]
        x = (xx[m] + 0.5 - self.K[0, 2]) * z / self.K[0, 0]
        y = (yy[m] + 0.5 - self.K[1, 2]) * z / self.K[1, 1]
        cam = np.stack([x, y, z], axis=1)
        c2w = obs["camera_pose"]
        return cam @ c2w[:3, :3].T + c2w[:3, 3]

    def is_other_pointcloud_overlapping(self, ref_pc: np.ndarray, other_pc: np.ndarray):
        """reference :256-266 — validity + min symmetric overlap fraction."""
        pixels = self.resolution[0] * self.resolution[1]
        valid_fraction = len(other_pc) / pixels
        i1, i2 = pointcloud_overlap(ref_pc, other_pc, self.distance_threshold)
        covis = min(i1 / pixels, i2 / pixels)
        ok = valid_fraction >= self.minimum_valid_fraction and covis >= self.minimum_covisibility
        return ok, valid_fraction, covis

    # -- item ---------------------------------------------------------------
    def __getitem__(self, idx: int) -> List[Dict]:
        rng = np.random.default_rng(hash(("item", self.seed, idx)) % (2**32))
        scene_id = int(rng.integers(0, self.scenes_pool))
        for _ in range(self.max_attempts_count):
            pos, rot = self.sample_random_viewpoint(rng)
            ref = self.render_viewpoint(scene_id, pos, rot)
            if ref["valid"].mean() < self.minimum_valid_fraction:
                continue
            ref_pc = self._unproject(ref)
            observed = ref_pc.mean(axis=0)
            nav = np.array([pos[0], 0.0, pos[2]])
            views = [ref]
            covis = [float(ref["valid"].mean())]
            attempts = 0
            while len(views) < self.views_count and attempts < self.max_attempts_count:
                attempts += 1
                opos, orot = self.sample_other_random_viewpoint(rng, observed, nav)
                obs = self.render_viewpoint(scene_id, opos, orot)
                pc = self._unproject(obs)
                ok, _, cv = self.is_other_pointcloud_overlapping(ref_pc, pc)
                if ok:
                    obs["covisibility"] = cv
                    views.append(obs)
                    covis.append(cv)
            if len(views) == self.views_count:
                return views
        raise RuntimeError("could not sample a covisible view set; lower minimum_covisibility")

    def as_croco_pairs(self, idx: int):
        """(view1, view2) dicts shaped for pretrain.collate_views / the CroCo
        cross-view completion batch: float images in [-1, 1], pts3d-free."""
        views = self[idx]
        out = []
        for v in views:
            out.append({
                "img": v["img"].astype(np.float32) / 127.5 - 1.0,
                "depthmap": v["depthmap"],
                "camera_pose": v["camera_pose"],
                "camera_intrinsics": v["camera_intrinsics"],
            })
        return tuple(out)

    def as_dust3r_pairs(self, idx: int):
        """(view1, view2) dicts in the Co3dPairDataset layout (data/co3d.py),
        for pretrain.collate_views and the DUSt3R losses: img in [-1, 1],
        world pts3d unprojected from the depth, valid_mask where the depth is
        defined and the point finite, camera_pose, camera_intrinsics."""
        out = []
        for v in self[idx]:
            pts = world_points(v["depthmap"], v["camera_intrinsics"], v["camera_pose"])
            out.append({
                "img": v["img"].astype(np.float32) / 127.5 - 1.0,
                "pts3d": pts,
                "valid_mask": (v["depthmap"] > 0.0) & np.isfinite(pts).all(-1),
                "camera_pose": v["camera_pose"],
                "camera_intrinsics": v["camera_intrinsics"],
            })
        return tuple(out)
