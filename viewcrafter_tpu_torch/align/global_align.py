"""Global point-cloud alignment: turn pairwise DUSt3R pointmaps into one
consistent scene (poses + depths + focals).

The port of the JAX package's `align/global_align.py`. Parity targets (the
reference's):
  - parameterization & loss: dust3r/cloud_opt/optimizer.py:29-201 (per-image
    log-depthmaps, quat+signed-log-translation poses, focal_break*log focals,
    pp offsets /10; per-edge sim3 pw_poses with scaled rotation; conf-weighted
    L1 between unprojected world points and rigidly-moved pair predictions,
    normalized by total areas);
  - pairwise scale normalization: base_opt.py:174-191;
  - MST initialization: init_im_poses.py:67-217 (host numpy; PnP-RANSAC
    draws from numpy's default_rng(0), so both packages draw the same
    samples);
  - optimization loop: base_opt.py:346-375 (Adam(0.9, 0.9), eps 1e-8, lr
    0.01 -> 1e-6, 'linear' or 'cosine');
  - clean_pointcloud occlusion-consistency filter: base_opt.py:230-266.

The loss and its gradient run on the aligner's device through autograd; the
loop is a Python loop of `niter` steps whose Adam update is written out (the
JAX package's optax `scale_by_adam(b1=0.9, b2=0.9)` with eps_root 0, then
minus lr_at(i) at the 0-based step i). All images share one (H, W).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import minimum_spanning_tree as sp_mst

from viewcrafter_tpu_torch.align.focal import estimate_focal
from viewcrafter_tpu_torch.align.pnp import fast_pnp
from viewcrafter_tpu_torch.align.registration import rigid_points_registration, srt_to_mat
from viewcrafter_tpu_torch.align.rotations import mat_to_pose_vec, pose_vec_to_mat
from viewcrafter_tpu_torch.config import AlignConfig
from viewcrafter_tpu_torch.geometry.transforms import geotrf, inv_se3
from viewcrafter_tpu_torch.models.lvdm import resolve_device

PARAM_NAMES = ("pw_poses", "im_poses", "im_depth", "im_focals", "im_pp")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.9, 1e-8  # base_opt.py's Adam(betas=(0.9, 0.9))


@dataclasses.dataclass
class SceneGraph:
    """Stacked pairwise predictions (host numpy).

    edges: (E, 2) directed (i, j); pred_i/pred_j: (E, H, W, 3), pred_i image
    i's pointmap in frame i, pred_j image j's pointmap in frame i;
    conf_i/conf_j: (E, H, W); imgs: (N, H, W, 3) in [0, 1].
    """

    edges: np.ndarray
    pred_i: np.ndarray
    pred_j: np.ndarray
    conf_i: np.ndarray
    conf_j: np.ndarray
    imgs: np.ndarray

    @property
    def n_imgs(self) -> int:
        return int(self.edges.max()) + 1

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    @property
    def imshape(self) -> Tuple[int, int]:
        return self.pred_i.shape[1:3]

    def im_conf(self) -> np.ndarray:
        """Per-image conf = elementwise max over all predictions of that image
        (base_opt.py _compute_img_conf)."""
        h, w = self.imshape
        conf = np.zeros((self.n_imgs, h, w), np.float32)
        for e, (i, j) in enumerate(self.edges):
            conf[i] = np.maximum(conf[i], self.conf_i[e])
            conf[j] = np.maximum(conf[j], self.conf_j[e])
        return conf


@dataclasses.dataclass
class AlignedScene:
    """Optimized scene state (host numpy)."""

    poses: np.ndarray  # (N, 4, 4) cam2world
    focals: np.ndarray  # (N,)
    principal_points: np.ndarray  # (N, 2)
    depths: np.ndarray  # (N, H, W)
    pts3d: np.ndarray  # (N, H, W, 3) world frame
    im_conf: np.ndarray  # (N, H, W)
    imgs: np.ndarray  # (N, H, W, 3)
    min_conf_thr: float

    def masks(self) -> np.ndarray:
        return self.im_conf > self.min_conf_thr

    def get_pts3d_clipped(self, clip_thred: Optional[float] = None) -> np.ndarray:
        """pts3d recomputed with depth clipping (optimizer.py:161-168)."""
        if clip_thred is None:
            return self.pts3d
        depths = np.minimum(self.depths, self.depths.max() * clip_thred)
        return _pts3d_from_depth_np(depths, self.focals, self.principal_points, self.poses)


def _pts3d_from_depth_np(depths, focals, pps, poses):
    n, h, w = depths.shape
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    pts = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        x = depths[i] * (uu - pps[i, 0]) / focals[i]
        y = depths[i] * (vv - pps[i, 1]) / focals[i]
        cam = np.stack([x, y, depths[i]], -1)
        pts[i] = cam @ poses[i, :3, :3].T + poses[i, :3, 3]
    return pts


class GlobalAligner:
    """PointCloudOptimizer equivalent on one device. Usage:

        aligner = GlobalAligner(scene_graph, AlignConfig())
        params = aligner.init_mst()
        params, losses = aligner.optimize(params)
        scene = aligner.get_scene(params)

    device=None is the card, and without one it raises
    (`models.lvdm.resolve_device`); pass device="cpu" for the CPU.
    """

    def __init__(self, graph: SceneGraph, cfg: AlignConfig = AlignConfig(),
                 base_scale: float = 0.5, device=None):
        self.graph = graph
        self.cfg = cfg
        self.base_scale = base_scale
        self.device = resolve_device(device)
        h, w = graph.imshape
        self.h, self.w = h, w
        a = h * w
        e = graph.n_edges

        def dev(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=self.device)

        uu, vv = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        self._grid = dev(np.stack([uu, vv], -1).reshape(-1, 2))
        self._ei = dev(graph.edges[:, 0].astype(np.int64))
        self._ej = dev(graph.edges[:, 1].astype(np.int64))
        self._pred_i = dev(graph.pred_i.reshape(e, a, 3).astype(np.float32))
        self._pred_j = dev(graph.pred_j.reshape(e, a, 3).astype(np.float32))
        # conf weights = log(conf) ('log' conf_trf, base_opt.py:61)
        self._weight_i = dev(np.log(graph.conf_i.reshape(e, a)).astype(np.float32))
        self._weight_j = dev(np.log(graph.conf_j.reshape(e, a)).astype(np.float32))
        self._total_area = e * a
        self._im_conf = graph.im_conf()
        self._edge_lut = {(int(i), int(j)): k for k, (i, j) in enumerate(graph.edges)}

    # ------------------------------------------------------------------
    # initialization (host)
    # ------------------------------------------------------------------

    def init_mst(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Minimum-spanning-tree initialization (init_im_poses.py:122-217), on
        the host in numpy. `seed` is the JAX package's argument and seeds
        nothing there either: PnP-RANSAC, for an image the tree misses, draws
        from its own np.random.default_rng(0) in both packages."""
        g = self.graph
        n = g.n_imgs

        # edge scores: mean(conf_i) * mean(conf_j)
        scores = {}
        for e, (i, j) in enumerate(g.edges):
            scores[(int(i), int(j))] = float(g.conf_i[e].mean() * g.conf_j[e].mean())
        rows = [i for i, j in scores]
        cols = [j for i, j in scores]
        vals = [-scores[(i, j)] for i, j in scores]
        msp = sp_mst(csr_matrix((vals, (rows, cols)), shape=(n, n))).tocoo()
        todo = sorted(zip(-msp.data, msp.row, msp.col))  # ascending score

        pts3d: List[Optional[np.ndarray]] = [None] * n
        im_poses: List[Optional[np.ndarray]] = [None] * n
        im_focals: List[Optional[float]] = [None] * n

        score, i, j = todo.pop()
        e = self._edge_lut[(int(i), int(j))]
        pts3d[i] = g.pred_i[e].copy()
        pts3d[j] = g.pred_j[e].copy()
        done = {int(i), int(j)}
        im_poses[i] = np.eye(4)
        im_focals[i] = estimate_focal(g.pred_i[e])

        while todo:
            score, i, j = todo.pop()
            e = self._edge_lut[(int(i), int(j))]
            if im_focals[i] is None:
                im_focals[i] = estimate_focal(g.pred_i[e])
            if i in done:
                src, dst, new = g.pred_i[e], pts3d[i], (g.pred_j[e], j)
                conf = g.conf_i[e]
            elif j in done:
                src, dst, new = g.pred_j[e], pts3d[j], (g.pred_i[e], i)
                conf = g.conf_j[e]
            else:
                todo.insert(0, (score, i, j))
                continue
            s, R, T = rigid_points_registration(src.reshape(-1, 3), dst.reshape(-1, 3),
                                                conf.ravel())
            trf = srt_to_mat(s, R, T)
            pts3d[new[1]] = (new[0].reshape(-1, 3) @ trf[:3, :3].T + trf[:3, 3]
                             ).astype(np.float32).reshape(self.h, self.w, 3)
            done.add(int(new[1]))
            if im_poses[i] is None:
                im_poses[i] = srt_to_mat(1, R, T)

        # fill missing focals from best edges
        for (i, j), _ in sorted(scores.items(), key=lambda kv: -kv[1]):
            if im_focals[i] is None:
                im_focals[i] = estimate_focal(g.pred_i[self._edge_lut[(i, j)]])
        # fill missing poses with PnP, else identity (init_im_poses.py:192-200)
        for i in range(n):
            if im_poses[i] is None:
                msk = self._im_conf[i] > self.cfg.min_conf_thr
                res = fast_pnp(pts3d[i], im_focals[i], msk)
                if res is not None:
                    im_focals[i], im_poses[i] = res
            if im_poses[i] is None:
                im_poses[i] = np.eye(4)

        return self._params_from_init(pts3d, im_poses, im_focals)

    def _params_from_init(self, pts3d, im_poses, im_focals) -> Dict[str, torch.Tensor]:
        """init_from_pts3d (init_im_poses.py:80-119)."""
        g = self.graph
        n = g.n_imgs
        im_poses = np.stack([np.asarray(p, np.float64) for p in im_poses])

        # pairwise sim3 poses from registration of predictions onto world pts
        pw = np.zeros((g.n_edges, 8), np.float32)
        for e, (i, j) in enumerate(g.edges):
            s, R, T = rigid_points_registration(
                g.pred_i[e].reshape(-1, 3), pts3d[i].reshape(-1, 3), g.conf_i[e].ravel())
            pw[e, :7] = mat_to_pose_vec(srt_to_mat(1, R, T))
            pw[e, 7] = np.log(max(s, 1e-8))

        # scale normalization so exp(mean log s) == base_scale
        s_factor = float(np.exp(np.log(self.base_scale) - pw[:, 7].mean()))
        im_poses[:, :3, 3] *= s_factor
        pts3d = [p * s_factor for p in pts3d]

        depth = np.zeros((n, self.h * self.w), np.float32)
        poses_vec = np.zeros((n, 7), np.float32)
        focals = np.zeros((n,), np.float32)
        for i in range(n):
            w2c = np.linalg.inv(im_poses[i])
            cam_pts = np.asarray(pts3d[i]).reshape(-1, 3) @ w2c[:3, :3].T + w2c[:3, 3]
            depth[i] = np.log(np.clip(cam_pts[:, 2], 1e-8, None))
            poses_vec[i] = mat_to_pose_vec(im_poses[i])
            focals[i] = self.cfg.focal_break * np.log(max(im_focals[i], 1e-8))
        arrays = {"pw_poses": pw, "im_poses": poses_vec, "im_depth": depth,
                  "im_focals": focals, "im_pp": np.zeros((n, 2), np.float32)}
        return {k: torch.as_tensor(v, device=self.device) for k, v in arrays.items()}

    # ------------------------------------------------------------------
    # device-side loss and loop
    # ------------------------------------------------------------------

    def _unproject(self, params):
        """Depth params -> world points (N, A, 3) (optimizer.py:172-186,204-211)."""
        focals = torch.exp(params["im_focals"] / self.cfg.focal_break)
        pp = torch.tensor([self.w / 2, self.h / 2], device=self.device) + 10.0 * params["im_pp"]
        depth = torch.exp(params["im_depth"])  # (N, A)
        rel = torch.cat([depth[..., None] * (self._grid[None] - pp[:, None]) / focals[:, None, None],
                         depth[..., None]], dim=-1)
        c2w = pose_vec_to_mat(params["im_poses"])
        return geotrf(c2w[:, None], rel[:, None])[:, 0], focals, pp

    def _pw_mats(self, params):
        log_s = params["pw_poses"][:, 7]
        # normalize so that exp(mean) == base_scale (base_opt.py:174-185)
        log_s = log_s + (math.log(self.base_scale) - torch.mean(log_s))
        return pose_vec_to_mat(params["pw_poses"][:, :7], scale=log_s)

    def loss_fn(self, params) -> torch.Tensor:
        proj, _, _ = self._unproject(params)  # (N, A, 3)
        pw = self._pw_mats(params)  # (E, 4, 4)
        aligned_i = geotrf(pw[:, None], self._pred_i[:, None])[:, 0]
        aligned_j = geotrf(pw[:, None], self._pred_j[:, None])[:, 0]

        # eps-safe norm: d||x||/dx is NaN at x = 0, and an accurate init makes
        # many residuals exactly zero (the anchor view's pts3d is pred_i)
        def dist(a, b):
            d = a - b
            return torch.sqrt(torch.sum(d * d, dim=-1) + 1e-16)

        li = torch.sum(dist(proj[self._ei], aligned_i) * self._weight_i)
        lj = torch.sum(dist(proj[self._ej], aligned_j) * self._weight_j)
        return (li + lj) / self._total_area

    def optimize(self, params, niter: Optional[int] = None, schedule: Optional[str] = None,
                 lr: Optional[float] = None, lr_min: float = 1e-6):
        """`niter` Adam steps on the loss. Step i (0-based) moves every
        parameter by -lr_at(i) * m_hat / (sqrt(v_hat) + ADAM_EPS), with
        m_hat = m / (1 - ADAM_B1^(i+1)), v_hat = v / (1 - ADAM_B2^(i+1)) and lr_at going
        from lr to lr_min linearly (or by a cosine) in i / niter. Returns
        (params, losses (niter,)), the loss of each step taken before its
        update."""
        niter = niter if niter is not None else self.cfg.niter
        schedule = schedule or self.cfg.schedule
        lr = lr if lr is not None else self.cfg.lr

        def lr_at(i):
            t = i / niter
            if schedule == "cosine":
                return lr_min + (lr - lr_min) * (1 + math.cos(t * math.pi)) / 2
            return lr + (lr_min - lr) * t

        params = {k: params[k].detach().clone().float().requires_grad_(True) for k in PARAM_NAMES}
        leaves = [params[k] for k in PARAM_NAMES]
        mu = [torch.zeros_like(p) for p in leaves]
        nu = [torch.zeros_like(p) for p in leaves]
        losses = []
        for i in range(niter):
            loss = self.loss_fn(params)
            grads = torch.autograd.grad(loss, leaves)
            losses.append(loss.detach())
            c1, c2 = 1.0 - ADAM_B1 ** (i + 1), 1.0 - ADAM_B2 ** (i + 1)
            step = lr_at(i)
            with torch.no_grad():
                for p, g, m, v in zip(leaves, grads, mu, nu):
                    m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
                    v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
                    p.sub_(step * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS))
        out = {k: p.detach() for k, p in params.items()}
        return out, (torch.stack(losses) if losses else torch.zeros(0, device=self.device))

    # ------------------------------------------------------------------
    # results
    # ------------------------------------------------------------------

    @torch.no_grad()
    def get_scene(self, params, clip_thred: Optional[float] = None) -> AlignedScene:
        proj, focals, pp = self._unproject(params)
        n = self.graph.n_imgs

        def host(t):
            return t.detach().cpu().numpy()

        scene = AlignedScene(
            poses=host(pose_vec_to_mat(params["im_poses"])),
            focals=host(focals),
            principal_points=host(pp),
            depths=host(torch.exp(params["im_depth"])).reshape(n, self.h, self.w),
            pts3d=host(proj).reshape(n, self.h, self.w, 3),
            im_conf=self._im_conf.copy(),
            imgs=self.graph.imgs,
            min_conf_thr=self.cfg.min_conf_thr,
        )
        if clip_thred is not None:
            scene.pts3d = scene.get_pts3d_clipped(clip_thred)
        return scene

    @torch.no_grad()
    def clean_pointcloud(self, scene: AlignedScene, tol: float = 0.001,
                         max_bad_conf: float = 0.0) -> AlignedScene:
        """Cross-view occlusion-consistency confidence downgrade
        (base_opt.py:230-266), each image against every other on the
        aligner's device."""
        n, h, w = self.graph.n_imgs, self.h, self.w

        def dev(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        w2c = inv_se3(dev(scene.poses))
        focals, pps = dev(scene.focals), dev(scene.principal_points)
        depths, confs = dev(scene.depths), dev(scene.im_conf)
        pts = dev(scene.pts3d.reshape(n, h * w, 3))
        new_conf = []
        for i in range(n):
            bad_any = torch.zeros(h * w, dtype=torch.bool, device=self.device)
            for j in range(n):
                if j == i:
                    continue
                cam = geotrf(w2c[j], pts[i])
                z = cam[:, 2]
                u = torch.round(focals[j] * cam[:, 0] / z + pps[j, 0])
                v = torch.round(focals[j] * cam[:, 1] / z + pps[j, 1])
                inside = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
                uc = torch.nan_to_num(u).clamp(0, w - 1).long()
                vc = torch.nan_to_num(v).clamp(0, h - 1).long()
                bad = (inside & (z < (1 - tol) * depths[j][vc, uc])
                       & (confs[i].reshape(-1) < confs[j][vc, uc]))
                bad_any |= bad
            conf_i = confs[i]
            new_conf.append(torch.where(bad_any.reshape(h, w),
                                        torch.clamp(conf_i, max=max_bad_conf), conf_i))
        return dataclasses.replace(scene, im_conf=torch.stack(new_conf).cpu().numpy())
