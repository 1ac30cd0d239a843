"""Point-cloud rasterizer: splat + per-pixel K-nearest z-buffer + alpha
compositing, as plain torch ops on the tensors' device.

The port of the JAX package's `ops/rasterize.py` (XLA there, no Pallas
kernel), which replaces the reference's PyTorch3D path
(PointsRasterizationSettings(radius=0.01, points_per_pixel=10, bin_size=0) +
PointsRenderer/AlphaCompositor, utils/pvd_utils.py:345-361,
viewcrafter.py:61-84) with the same semantics:
  - every point with screen-space (square-NDC) distance < radius of a pixel
    center contributes to that pixel;
  - per pixel, the K nearest-by-z contributors are kept, depth-ordered, ties
    going to the lower candidate id (point-major, then window position);
  - weights w = 1 - dist^2/radius^2 are alpha-composited front to back:
    out = sum_k w_k * prod_{j<k}(1 - w_j) * color_k.

Each point is expanded to the tight int(2r)+1 square of pixels its splat can
reach (9 candidates at the pipeline's r = 1.44 px); stable sorts order the
candidates pixel-major and near-to-far; the K first of each pixel fill the
K-buffer. Points stream in chunks whose K-buffers merge exactly (carry
first, a stable sort by z), so the chunking, and with z_order="packed" the
per-chunk z quantization, are the JAX package's.

Cameras are OpenCV-RDF pinholes (pixel-unit focal and principal point).
"""

from __future__ import annotations

import torch

from viewcrafter_tpu_torch.geometry.transforms import geotrf

ZQ_BITS = 13  # the packed key's z quantization


def _footprint_width(radius_px: float) -> int:
    """Pixels per axis a splat can touch: a pixel center c = px + 0.5 is hit
    iff |c - u| < r, i.e. px in the open interval (u-r-0.5, u+r-0.5) of
    length 2r, at most floor(2r)+1 integers."""
    return int(2.0 * radius_px) + 1


def _project_candidates(points, w2c, intrinsics, height, width, radius_px, znear):
    """Per point, the candidate pixels of its window. Returns (valid, py, px,
    z, dist2), valid / py / px / dist2 (N, W^2) and z (N,)."""
    cam = geotrf(w2c, points[None])[0]
    z = cam[:, 2]
    safe_z = torch.where(z.abs() < znear, torch.full_like(z, znear), z)
    u = intrinsics[0, 0] * cam[:, 0] / safe_z + intrinsics[0, 2]
    v = intrinsics[1, 1] * cam[:, 1] / safe_z + intrinsics[1, 2]
    visible = z > znear
    w_fp = _footprint_width(radius_px)
    offs = torch.arange(w_fp, device=points.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    # the first pixel whose center can be in range; a boundary pixel included
    # spuriously is filtered again by dist < r
    base_u = torch.ceil(u - radius_px - 0.5).to(torch.int32)
    base_v = torch.ceil(v - radius_px - 0.5).to(torch.int32)
    px = base_u[:, None] + ox.reshape(-1)[None, :]
    py = base_v[:, None] + oy.reshape(-1)[None, :]
    du = (px.float() + 0.5) - u[:, None]
    dv = (py.float() + 0.5) - v[:, None]
    dist2 = du * du + dv * dv
    in_bounds = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    valid = in_bounds & (dist2 < radius_px * radius_px) & visible[:, None]
    return valid, py, px, z, dist2


def _candidates_to_kbuffer(valid, py, px, z, dist2, colors, radius_px, height, width, k,
                           z_order: str):
    """Candidate splats -> per-pixel K-nearest buffers (z, weight, color),
    (HW, K), (HW, K), (HW, K, C), z-sorted, with inf / 0 in empty slots.

    z_order "exact": stable sorts by z, then by pixel (PyTorch3D's order,
    ties to the lower candidate id). "packed": one stable sort of
    pixel * 2^13 + z quantized linearly to 13 bits over the candidates'
    [zmin, zmax] (the JAX package's cheaper approximation: two same-pixel
    candidates within one bucket keep candidate order). "auto": packed when
    the key fits in int32, as in the JAX package."""
    n, f2 = valid.shape
    c = colors.shape[1]
    hw = height * width
    dev = valid.device
    pix_id = torch.where(valid, py * width + px, torch.full_like(py, hw)).reshape(-1).long()
    cand_z = torch.where(valid, z[:, None], torch.full_like(dist2, float("inf"))).reshape(-1)
    weight = torch.clamp(1.0 - dist2 / (radius_px * radius_px), 0.0, 1.0).reshape(-1)
    point_idx = torch.arange(n, device=dev)[:, None].expand(n, f2).reshape(-1)
    if z_order == "auto":
        z_order = "packed" if (hw + 1) << ZQ_BITS < 2 ** 31 else "exact"
    if z_order == "packed":
        finite = torch.isfinite(cand_z)
        zmin = torch.where(finite, cand_z, float("inf")).min()
        zmax = torch.where(finite, cand_z, float("-inf")).max()
        scale = (2.0 ** ZQ_BITS - 2.0) / torch.clamp(zmax - zmin, min=1e-20)
        zq = torch.clamp((cand_z - zmin) * scale, 0.0, 2.0 ** ZQ_BITS - 2.0)
        zq = torch.where(finite, zq.to(torch.int64), torch.full_like(pix_id, 2 ** ZQ_BITS - 1))
        order = torch.sort((pix_id << ZQ_BITS) | zq, stable=True).indices
    elif z_order == "exact":
        order_z = torch.sort(cand_z, stable=True).indices
        order = order_z[torch.sort(pix_id[order_z], stable=True).indices]
    else:
        raise ValueError(f"unknown z_order {z_order!r}")
    pix_final = pix_id[order]
    # rank within the pixel: the position past the pixel's first candidate
    pos = torch.arange(pix_final.numel(), device=dev)
    rank = pos - torch.searchsorted(pix_final, pix_final, right=False)
    keep = (rank < k) & (pix_final < hw)
    slot = (pix_final * k + rank)[keep]
    sel = order[keep]
    z_buf = torch.full((hw * k,), float("inf"), device=dev)
    w_buf = torch.zeros((hw * k,), device=dev)
    c_buf = torch.zeros((hw * k, c), device=dev)
    z_buf[slot] = cand_z[sel]
    w_buf[slot] = weight[sel]
    c_buf[slot] = colors[point_idx[sel]].float()
    return z_buf.reshape(hw, k), w_buf.reshape(hw, k), c_buf.reshape(hw, k, c)


def _composite(w_k, c_k, height, width):
    """Front-to-back over-compositing with exclusive transmittance."""
    trans = torch.cumprod(1.0 - w_k, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    img = torch.sum(w_k[..., None] * trans[..., None] * c_k, dim=1)
    return img.reshape(height, width, c_k.shape[-1])


def rasterize_points(points, colors, w2c, intrinsics, height: int, width: int,
                     radius_ndc: float = 0.01, points_per_pixel: int = 10, znear: float = 1e-4,
                     z_order: str = "exact"):
    """Render one view of the whole cloud at once -> (H, W, C), holes 0.
    points (N, 3) world RDF; colors (N, C); w2c (4, 4); intrinsics (3, 3) in
    pixels."""
    # PyTorch3D square NDC: the shorter image side spans [-1, 1]
    radius_px = radius_ndc * min(height, width) / 2.0
    valid, py, px, z, dist2 = _project_candidates(points, w2c, intrinsics, height, width,
                                                  radius_px, znear)
    _, w_k, c_k = _candidates_to_kbuffer(valid, py, px, z, dist2, colors, radius_px, height,
                                         width, points_per_pixel, z_order)
    return _composite(w_k, c_k, height, width)


def rasterize_points_chunked(points, colors, w2c, intrinsics, height: int, width: int,
                             radius_ndc: float = 0.01, points_per_pixel: int = 10,
                             znear: float = 1e-4, chunk: int = 65536, z_order: str = "exact"):
    """`rasterize_points` with the points streamed in chunks of `chunk`,
    whose per-pixel K-buffers merge exactly: a pixel's K nearest lie in the
    union of its per-chunk K nearest, and a stable z sort with the carry
    first keeps the tie-break (an earlier chunk holds the lower ids)."""
    n, c = colors.shape
    k = points_per_pixel
    hw = height * width
    radius_px = radius_ndc * min(height, width) / 2.0
    if n <= chunk:
        return rasterize_points(points, colors, w2c, intrinsics, height, width, radius_ndc,
                                points_per_pixel, znear, z_order)
    dev = points.device
    z_c = torch.full((hw, k), float("inf"), device=dev)
    w_c = torch.zeros((hw, k), device=dev)
    col_c = torch.zeros((hw, k, c), device=dev)
    for s in range(0, n, chunk):
        valid, py, px, z, dist2 = _project_candidates(points[s:s + chunk], w2c, intrinsics,
                                                      height, width, radius_px, znear)
        z_n, w_n, col_n = _candidates_to_kbuffer(valid, py, px, z, dist2, colors[s:s + chunk],
                                                 radius_px, height, width, k, z_order)
        z_cat = torch.cat([z_c, z_n], dim=-1)  # carry first: the tie-break
        order = torch.sort(z_cat, dim=-1, stable=True).indices[:, :k]
        z_c = torch.gather(z_cat, 1, order)
        w_c = torch.gather(torch.cat([w_c, w_n], dim=-1), 1, order)
        col_c = torch.gather(torch.cat([col_c, col_n], dim=-2), 1,
                             order[..., None].expand(hw, k, c))
    return _composite(w_c, col_c, height, width)


def render_trajectory(points, colors, w2cs, intrinsics, height: int, width: int,
                      radius_ndc: float = 0.01, points_per_pixel: int = 10,
                      chunk: int = 65536, z_order: str = "auto") -> torch.Tensor:
    """Render V views one after the other -> (V, H, W, C), on the points'
    device. w2cs (V, 4, 4); intrinsics (V, 3, 3) or (3, 3). The JAX package
    pads the cloud to a bucket of 65536 points for its compile cache; the
    padding is masked out there, so the port renders the same without it."""
    if intrinsics.ndim == 2:
        intrinsics = intrinsics.expand(w2cs.shape[0], 3, 3)
    return torch.stack([
        rasterize_points_chunked(points, colors, w2cs[i], intrinsics[i], height, width,
                                 radius_ndc=radius_ndc, points_per_pixel=points_per_pixel,
                                 chunk=chunk, z_order=z_order)
        for i in range(w2cs.shape[0])])
