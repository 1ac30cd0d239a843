"""The port's geometry front against the JAX package: the transforms, the
trajectory copy, the rasterizer (also against the independent torch oracle
`tests/oracles/pytorch3d_points.py`), the global aligner and
`clean_pointcloud`.

Tolerances:
  - transforms: 1e-6 relative (float32 on both sides); the numpy copies
    (trajectory, the MST init's host math) give the same bits.
  - rasterizer against JAX: the same covered pixels and colors within 1e-5
    (the same float32 projection, sorts with the same tie-break); against
    the float64 oracle: the same covered pixels and colors within 2e-3, the
    bound of the JAX package's own oracle test (float32 against float64).
    Scenes hold exact z ties: duplicated points of other colors, and a plane
    of points at one depth under a camera that rotates about z only.
  - aligner, from one SceneGraph of the JAX DUSt3R's pointmaps at 2 and 3
    images: the MST init within 1e-5 relative, the loss of each of 5 Adam
    steps and the final poses, depths and focals within 1e-4 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracles.pytorch3d_points import rasterize_composite_torch
from viewcrafter_tpu.align import global_align as jga
from viewcrafter_tpu.align.pairs import make_pairs as jax_make_pairs
from viewcrafter_tpu.config import AlignConfig as JaxAlignConfig
from viewcrafter_tpu.config import get_dust3r_config as jax_dust3r_config
from viewcrafter_tpu.geometry import trajectory as jtraj
from viewcrafter_tpu.geometry import transforms as jtf
from viewcrafter_tpu.models.dust3r import Dust3rModel as JaxDust3r
from viewcrafter_tpu.ops import rasterize as jras
from viewcrafter_tpu_torch.align import global_align as tga
from viewcrafter_tpu_torch.align.pairs import make_pairs
from viewcrafter_tpu_torch.config import AlignConfig
from viewcrafter_tpu_torch.geometry import trajectory as ttraj
from viewcrafter_tpu_torch.geometry import transforms as ttf
from viewcrafter_tpu_torch.ops import rasterize as tras


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _poses(n, seed):
    """(n, 4, 4) float32 rigid cam-to-world poses."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q.T
    R = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                  2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                  2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = R.reshape(n, 3, 3)
    T[:, :3, 3] = rng.standard_normal((n, 3))
    return T.astype(np.float32)


# -- transforms and the trajectory copy --------------------------------------


def test_transforms_match_jax():
    rng = np.random.default_rng(0)
    poses = _poses(3, 1)
    pts = (rng.standard_normal((3, 4, 5, 3)) + [0, 0, 4]).astype(np.float32)
    P, J = torch.from_numpy(poses), jnp.asarray(poses)
    assert _rel(ttf.geotrf(P, torch.from_numpy(pts.reshape(3, 20, 3))).numpy(),
                jtf.geotrf(J, jnp.asarray(pts.reshape(3, 20, 3)))) <= 1e-6
    assert _rel(ttf.inv_se3(P).numpy(), jtf.inv_se3(J)) <= 1e-6
    assert _rel(ttf.world_to_kth(P, 1).numpy(), jtf.world_to_kth(J, 1)) <= 1e-6
    for got, ref in zip(ttf.world_point_to_kth(P, torch.from_numpy(pts), 2),
                        jtf.world_point_to_kth(J, jnp.asarray(pts), 2)):
        assert _rel(got.numpy(), ref) <= 1e-6
    assert _rel(ttf.object_anchor_pose(1.7, 5.0).numpy(), jtf.object_anchor_pose(1.7, 5.0)) <= 1e-6
    for got, ref in zip(ttf.world_point_to_obj(P, torch.from_numpy(pts), -1, 2.3, 12.0),
                        jtf.world_point_to_obj(J, jnp.asarray(pts), -1, 2.3, 12.0)):
        assert _rel(got.numpy(), ref) <= 1e-6
    K = np.asarray(jtf.make_intrinsics(np.array([50.0, 60.0]), np.array([[16, 8], [15, 9.5]])))
    assert np.array_equal(ttf.make_intrinsics(np.array([50.0, 60.0]),
                                              np.array([[16, 8], [15, 9.5]])), K)
    depth = rng.uniform(1, 3, (2, 4, 5)).astype(np.float32)
    assert _rel(ttf.depthmap_to_pts3d(torch.from_numpy(depth), torch.from_numpy(K)).numpy(),
                jtf.depthmap_to_pts3d(jnp.asarray(depth), jnp.asarray(K))) <= 1e-6


def test_trajectory_copy_gives_the_same_poses():
    anchor = _poses(1, 2)[0].astype(np.float64)
    cases = [
        ("generate_traj_specified", (anchor, 10.0, 30.0, -0.2, 0.1, 0.05, 25)),
        ("generate_traj_txt", (anchor, [0, 15, 30, 20], [0, 2, 4, 1], [0, 0, -0.1, 0], 25)),
        ("generate_traj_txt", (anchor, [0, 15], [0, 2], [0, 0.1], 9)),
        ("interp_traj", (_poses(3, 3).astype(np.float64), 25)),
        ("generate_candidate_poses", (anchor, 10.0, 30.0, 3)),
    ]
    for name, args in cases:
        ref, got = getattr(jtraj, name)(*args), getattr(ttraj, name)(*args)
        for a, b in zip(ref if isinstance(ref, tuple) else (ref,),
                        got if isinstance(got, tuple) else (got,)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), name


# -- the rasterizer ------------------------------------------------------------


def _scene(n, seed, ties: bool):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    if ties:
        # exact z ties: every 4th point duplicated with another color, and a
        # plane of points at depth 3 exactly
        dup = pts[::4].copy()
        plane = np.stack(np.meshgrid(np.linspace(-0.6, 0.6, 40), np.linspace(-0.4, 0.4, 30)),
                         -1).reshape(-1, 2)
        plane = np.concatenate([plane, np.full((len(plane), 1), 3.0)], -1).astype(np.float32)
        pts = np.concatenate([pts, dup, plane])
        cols = np.concatenate([cols, rng.uniform(size=(len(dup) + len(plane), 3)).astype(
            np.float32)])
    return pts, cols


def _cameras(v, seed):
    """(v, 4, 4) world-to-camera poses rotating about z only (so that points
    of one depth keep exactly one camera depth) and (v, 3, 3) intrinsics."""
    rng = np.random.default_rng(seed)
    w2c = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    for i, a in enumerate(rng.uniform(-0.3, 0.3, v)):
        w2c[i, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        w2c[i, :2, 3] = rng.uniform(-0.1, 0.1, 2)
    K = np.tile(np.array([[80.0, 0, 50.5], [0, 80.0, 35.25], [0, 0, 1]], np.float32), (v, 1, 1))
    return w2c, K


H, W = 72, 96


def _check(got, ref, tol):
    assert got.shape == ref.shape
    assert np.array_equal(np.any(got > 0, -1), np.any(ref > 0, -1))
    assert np.abs(got - ref).max() <= tol, np.abs(got - ref).max()


@pytest.mark.parametrize("z_order", ["exact", "packed"])
def test_render_trajectory_matches_jax(z_order):
    pts, cols = _scene(12000, 3, ties=True)
    w2c, K = _cameras(3, 4)
    ref = np.asarray(jras.render_trajectory(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(w2c),
                                            jnp.asarray(K), H, W, z_order=z_order))
    got = tras.render_trajectory(torch.from_numpy(pts), torch.from_numpy(cols),
                                 torch.from_numpy(w2c), torch.from_numpy(K), H, W,
                                 z_order=z_order).numpy()
    assert (got > 0).any(-1).mean() > 0.3
    _check(got, ref, 1e-5)


@pytest.mark.parametrize("z_order", ["exact", "packed"])
def test_chunked_merge_matches_jax(z_order):
    """Chunks of 1500 points: the per-chunk K-buffers and their merge (and
    with "packed", the per-chunk z quantization) as in the JAX package."""
    pts, cols = _scene(5000, 5, ties=True)
    w2c, K = _cameras(1, 6)
    ref = np.asarray(jras.rasterize_points_chunked(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(w2c[0]), jnp.asarray(K[0]), H, W,
        chunk=1500, z_order=z_order))
    got = tras.rasterize_points_chunked(torch.from_numpy(pts), torch.from_numpy(cols),
                                        torch.from_numpy(w2c[0]), torch.from_numpy(K[0]), H, W,
                                        chunk=1500, z_order=z_order).numpy()
    _check(got, ref, 1e-5)


@pytest.mark.parametrize("chunk", [65536, 1500])
def test_rasterizer_matches_oracle(chunk):
    pts, cols = _scene(6000, 7, ties=True)
    w2c, K = _cameras(1, 8)
    ref = rasterize_composite_torch(torch.from_numpy(pts), torch.from_numpy(cols),
                                    torch.from_numpy(w2c[0]), torch.from_numpy(K[0]), H, W,
                                    radius_ndc=0.01, points_per_pixel=10).numpy()
    got = tras.rasterize_points_chunked(torch.from_numpy(pts), torch.from_numpy(cols),
                                        torch.from_numpy(w2c[0]), torch.from_numpy(K[0]), H, W,
                                        chunk=chunk, z_order="exact").numpy()
    _check(got, ref.astype(np.float32), 2e-3)


# -- the aligner ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _graph(n: int):
    """A SceneGraph of the JAX tiny DUSt3R's pointmaps over n images (the
    complete symmetric pair graph)."""
    cfg = jax_dust3r_config("dust3r_tiny")
    rng = np.random.default_rng(10 + n)
    base = rng.uniform(-1, 1, (32, 64, 3)).astype(np.float32)
    imgs = np.stack([np.roll(base, 3 * i, axis=1) for i in range(n)])
    model = JaxDust3r(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), imgs[:1], imgs[:1])
    pairs = jax_make_pairs(n)
    assert pairs == make_pairs(n)
    ii, jj = zip(*pairs)
    out = jax.jit(model.apply)(params, jnp.asarray(imgs[list(ii)]), jnp.asarray(imgs[list(jj)]))
    return dict(edges=np.asarray(pairs), pred_i=np.asarray(out["pts3d1"]),
                pred_j=np.asarray(out["pts3d2_in_view1"]), conf_i=np.asarray(out["conf1"]),
                conf_j=np.asarray(out["conf2"]), imgs=(imgs + 1) / 2)


@functools.lru_cache(maxsize=None)
def _aligned(n: int):
    g = _graph(n)
    ja = jga.GlobalAligner(jga.SceneGraph(**g), JaxAlignConfig(niter=5))
    ta = tga.GlobalAligner(tga.SceneGraph(**g), AlignConfig(niter=5), device="cpu")
    jinit, tinit = ja.init_mst(), ta.init_mst()
    jp, jl = ja.optimize(jinit)
    tp_, tl = ta.optimize(tinit)
    return (ja, jinit, jp, np.asarray(jl)), (ta, tinit, tp_, tl.numpy())


@pytest.mark.parametrize("n", [2, 3])
def test_aligner_matches_jax(n):
    (ja, jinit, jp, jl), (ta, tinit, tp_, tl) = _aligned(n)
    for k in jinit:
        assert _rel(tinit[k].numpy(), jinit[k]) <= 1e-5, k
    assert tl.shape == jl.shape == (5,)
    assert _rel(tl, jl) <= 1e-4
    js, ts = ja.get_scene(jp, clip_thred=1.0), ta.get_scene(tp_, clip_thred=1.0)
    for name in ("poses", "depths", "focals", "principal_points", "pts3d"):
        assert _rel(getattr(ts, name), getattr(js, name)) <= 1e-4, name


def test_clean_pointcloud_matches_jax():
    (ja, _, jp, _), (ta, _, tp_, _) = _aligned(3)
    scene = ja.get_scene(jp)
    ref = ja.clean_pointcloud(scene).im_conf
    got = ta.clean_pointcloud(scene).im_conf
    assert np.array_equal(got, ref)
    assert not np.array_equal(ref, scene.im_conf)  # some confidence was downgraded
