"""Scene-graph pair construction + the closed-form two-view PairViewer.

The port's own copy of the JAX package's `align/pairs.py` (numpy only), on
the port's `global_align`. Parity targets:
  - make_pairs strategies complete / swin-k / oneref-k / pairs + symmetrize:
    extern/dust3r/dust3r/image_pairs.py:12-48
  - PairViewer (focal via Weiszfeld, relative pose via PnP, higher-confidence
    anchor wins): extern/dust3r/dust3r/cloud_opt/pair_viewer.py:18-125.
    Present but unselected in the reference pipeline (viewcrafter.py:51
    forces the gradient optimizer).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from viewcrafter_tpu_torch.align.focal import estimate_focal
from viewcrafter_tpu_torch.align.global_align import AlignedScene, SceneGraph
from viewcrafter_tpu_torch.align.pnp import solve_pnp_ransac


def make_pairs(n_images: int, scene_graph: str = "complete", symmetrize: bool = True) -> List[Tuple[int, int]]:
    """Directed (i, j) index pairs for a given scene-graph strategy."""
    pairs: List[Tuple[int, int]] = []
    if scene_graph == "complete":
        for i in range(n_images):
            for j in range(i):
                pairs.append((i, j))
    elif scene_graph.startswith("swin"):
        winsize = int(scene_graph.split("-")[1]) if "-" in scene_graph else 3
        for i in range(n_images):
            for j in range(winsize):
                pairs.append((i, (i + j) % n_images))
    elif scene_graph.startswith("oneref"):
        refid = int(scene_graph.split("-")[1]) if "-" in scene_graph else 0
        for j in range(n_images):
            if j != refid:
                pairs.append((refid, j))
    elif scene_graph == "pairs":
        assert n_images % 2 == 0
        for i in range(0, n_images, 2):
            pairs.append((i, i + 1))
    else:
        raise ValueError(f"unknown scene graph {scene_graph!r}")
    if symmetrize:
        pairs = pairs + [(j, i) for i, j in pairs]
    # dedupe, keep order
    seen = set()
    out = []
    for p in pairs:
        if p not in seen and p[0] != p[1]:
            seen.add(p)
            out.append(p)
    return out


def pair_viewer(graph: SceneGraph, min_conf_thr: float = 3.0) -> AlignedScene:
    """Closed-form 2-view 'alignment' (no optimization)."""
    assert graph.n_imgs == 2 and graph.n_edges == 2, "PairViewer needs a symmetric 2-view graph"
    h, w = graph.imshape

    def edge(i, j):
        for e, (a, b) in enumerate(graph.edges):
            if (a, b) == (i, j):
                return e
        raise KeyError((i, j))

    focals, pps, rel_poses, confs = [], [], [], []
    im_conf = graph.im_conf()
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    pixels = np.stack([uu, vv], -1)
    for i in range(2):
        e_fwd = edge(i, 1 - i)
        confs.append(float(graph.conf_i[e_fwd].mean() * graph.conf_j[e_fwd].mean()))
        pp = np.array([w / 2, h / 2])
        focal = estimate_focal(graph.pred_i[e_fwd], pp)
        focals.append(focal)
        pps.append(pp)
        # pose of camera i within the OTHER camera's frame: PnP on pred_j of
        # the reverse edge (points of image i expressed in frame 1-i)
        pts = graph.pred_j[edge(1 - i, i)]
        msk = im_conf[i] > min_conf_thr
        K = np.array([[focal, 0, pp[0]], [0, focal, pp[1]], [0, 0, 1.0]])
        pose = np.eye(4)
        if msk.sum() >= 6:
            res = solve_pnp_ransac(pts[msk], pixels[msk], K, n_iters=100)
            if res is not None:
                R, t = res
                pose = np.eye(4)
                pose[:3, :3] = R.T
                pose[:3, 3] = -R.T @ t
        rel_poses.append(pose.astype(np.float32))

    if confs[0] > confs[1]:
        anchor = 0
        poses = np.stack([np.eye(4, dtype=np.float32), rel_poses[1]])
        e = edge(0, 1)
        pts3d = np.stack([graph.pred_i[e], graph.pred_j[e]])
        w2c1 = np.linalg.inv(rel_poses[1])
        depth1 = (graph.pred_j[e].reshape(-1, 3) @ w2c1[:3, :3].T + w2c1[:3, 3])[:, 2]
        depths = np.stack([graph.pred_i[e][..., 2], depth1.reshape(h, w)])
    else:
        anchor = 1
        poses = np.stack([rel_poses[0], np.eye(4, dtype=np.float32)])
        e = edge(1, 0)
        pts3d = np.stack([graph.pred_j[e], graph.pred_i[e]])
        w2c0 = np.linalg.inv(rel_poses[0])
        depth0 = (graph.pred_j[e].reshape(-1, 3) @ w2c0[:3, :3].T + w2c0[:3, 3])[:, 2]
        depths = np.stack([depth0.reshape(h, w), graph.pred_i[e][..., 2]])

    return AlignedScene(
        poses=poses,
        focals=np.asarray(focals, np.float32),
        principal_points=np.stack(pps).astype(np.float32),
        depths=depths.astype(np.float32),
        pts3d=pts3d.astype(np.float32),
        im_conf=im_conf,
        imgs=graph.imgs,
        min_conf_thr=min_conf_thr,
    )
