"""Gaussian-sharded rendering: depth-slab decomposition across ranks.

Port of `egogaussian_tpu/parallel/shard_render.py`. The N Gaussians are
split into depth slabs (disjoint camera-space depth ranges), one per rank
of the mesh axis. Front-to-back alpha compositing factorizes exactly
across depth-disjoint groups:

  img   = img_0 + T_0 * (img_1 + T_1 * (img_2 + ...)) + (prod_k T_k) * bg
  alpha = 1 - prod_k T_k
  depth = depth_0 + T_0 * depth_1 + ...

where (img_k, depth_k, T_k) are slab k's premultiplied color, depth and
per-pixel transmittance. Each rank renders its slab through the port's own
`render` (backend "cuda": the tile-grid kernel pair; "tiled": the chunked
windowed pair) and the merge is D multiply-adds over the image.

  * make_sharded_render: parameters replicated; every rank sees all N
    Gaussians and renders the slab of global depth ranks
    [kN/D, (k+1)N/D) of the visible ones, which keeps the per-pixel depth
    order exact.
  * make_memory_sharded_render: parameters sharded; each rank owns N/D
    arbitrary Gaussians. Per frame the depth range is max-reduced, an
    integer depth histogram is summed over the ranks (exact), its
    D-quantiles bound D disjoint depth bands, and one all_to_all re-slabs
    the Gaussians so that rank k holds band k. A band that overflows its
    per-destination capacity ceil(C/D * capacity_factor) drops Gaussians;
    the drops are summed over the ranks and returned beside the image,
    never silent.

Every rank gathers all slabs' partials (one all_gather) and merges them in
slab order itself, so each returns the same image.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from egogaussian_tpu_torch.parallel.mesh import (
    Mesh,
    gather_blocks,
    host_staged,
    max_blocks,
    sum_blocks,
)
from egogaussian_tpu_torch.render.api import render
from egogaussian_tpu_torch.render.oracle import RenderOutput
from egogaussian_tpu_torch.render.project import project_gaussians


def _slab_log_t(alpha: torch.Tensor) -> torch.Tensor:
    """log of a slab's transmittance 1 - alpha, clipped to [1e-12, 1] so
    that the chain stays finite."""
    return torch.log(torch.clamp(1.0 - alpha[0], 1e-12, 1.0))


def _merge_slabs(imgs, depths, log_ts):
    """Ordered front-to-back merge of per-slab partials (slab 0 nearest).
    imgs [D, C, H, W], depths [D, 1, H, W], log_ts [D, H, W]."""
    log_prefix = torch.cumsum(log_ts, dim=0) - log_ts  # exclusive
    t_prefix = torch.exp(log_prefix)[:, None]
    out_img = torch.sum(imgs * t_prefix, dim=0)
    out_depth = torch.sum(depths * t_prefix, dim=0)
    t_total = torch.exp(torch.sum(log_ts, dim=0))
    return out_img, (1.0 - t_total)[None], out_depth


def _gather_merge(mesh: Mesh, axis: str, img, depth, log_t, extra):
    """Every slab's (img, depth, log T) gathered in slab order and merged;
    `extra` (a float32 vector) rides the same all_gather and comes back as
    its [D, n] blocks."""
    c, h, w = img.shape
    blocks = gather_blocks(mesh, torch.cat([img.reshape(-1), depth.reshape(-1),
                                            log_t.reshape(-1), extra]), axis)
    n_img, n_px = c * h * w, h * w
    imgs = blocks[:, :n_img].reshape(-1, c, h, w)
    depths = blocks[:, n_img:n_img + n_px].reshape(-1, 1, h, w)
    log_ts = blocks[:, n_img + n_px:n_img + 2 * n_px].reshape(-1, h, w)
    return _merge_slabs(imgs, depths, log_ts), blocks[:, n_img + 2 * n_px:]


def _with_bg(img, alpha, bg):
    if bg is None:
        return img
    return img + (1.0 - alpha) * torch.as_tensor(bg, dtype=img.dtype,
                                                 device=img.device)[:, None, None]


def _project(camera, means3d, cov3d, valid_mask):
    return project_gaussians(means3d, cov3d, camera.viewmat, camera.fx, camera.fy,
                             camera.cx, camera.cy, camera.width, camera.height,
                             valid_mask=valid_mask)


def depth_slab(proj, slab: int, n_slabs: int) -> torch.Tensor:
    """[N] bool: the visible Gaussians of depth slab `slab` of `n_slabs`,
    those whose global depth rank among the visible ones lies in
    [slab * n_vis / n_slabs, (slab + 1) * n_vis / n_slabs) (stable order:
    equal depths keep their row order)."""
    visible = proj.radii > 0
    n_vis = torch.sum(visible)
    order = torch.argsort(torch.where(visible, proj.depths, torch.inf), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    return visible & (rank >= slab * n_vis // n_slabs) & (rank < (slab + 1) * n_vis // n_slabs)


def make_sharded_render(mesh: Mesh, camera, axis: str = "data", backend: str = "tiled",
                        tile_config=None):
    """Depth-slab sharded renderer over `axis` of `mesh`.

    Returned fn(means3d, cov3d, colors, opacities, valid_mask, bg=None) ->
    RenderOutput, with every input replicated; the rank with coordinate k
    renders slab k and all ranks merge the gathered partials. `bg` ([C])
    adds the (prod_k T_k) * bg term (default black). dropped_pairs: the
    most binning pairs any slab's render dropped."""
    n_slabs, slab = mesh.shape[axis], mesh.coords[axis]

    def render_sharded(means3d, cov3d, colors, opacities, valid_mask, bg=None):
        n = means3d.shape[0]
        in_slab = depth_slab(_project(camera, means3d, cov3d, valid_mask), slab, n_slabs)
        res = render(camera, means3d, cov3d, opacities,
                     bg=torch.zeros((colors.shape[-1],), dtype=means3d.dtype,
                                    device=means3d.device),
                     colors_precomp=colors, valid_mask=in_slab,
                     backend=backend, tile_config=tile_config)
        (img, alpha, depth), drops = _gather_merge(
            mesh, axis, res.image, res.depth, _slab_log_t(res.alpha),
            res.dropped_pairs.to(torch.float32).reshape(1))
        return RenderOutput(image=_with_bg(img, alpha, bg), alpha=alpha, depth=depth,
                            radii=torch.zeros((n,), dtype=torch.int32, device=means3d.device),
                            dropped_pairs=max_blocks(drops)[0].to(torch.int64))

    return render_sharded


def make_memory_sharded_render(mesh: Mesh, camera, axis: str = "data",
                               backend: str = "tiled", tile_config=None,
                               capacity_factor: float = 2.0, depth_bins: int = 256):
    """Memory-sharded renderer: each rank passes its own shard of the
    Gaussians (rank k of `axis` owns rows [kC, (k+1)C) of the model:
    shard_batch), so a rank's parameter footprint is N/D.

    Per frame each rank projects its shard, agrees with the others on D
    disjoint depth bands (max-reduced depth range, summed integer
    histogram, its D-quantiles), sends each owned visible Gaussian to its
    band's rank through one all_to_all with per-destination capacity
    ceil(C/D * capacity_factor), renders the band it receives and merges
    the gathered partials as the replicated variant does.

    Returned fn(means3d, cov3d, colors, opacities, valid_mask, bg=None)
    -> (RenderOutput, dropped): `dropped` is the number of Gaussians that
    overflowed a band's capacity, summed over the ranks (int64 scalar).
    RenderOutput.dropped_pairs is the most binning pairs any slab's render
    dropped, as in make_sharded_render (JAX's puts `dropped` there and
    lets the slabs' pair drops go)."""
    n_slabs = mesh.shape[axis]

    def render_msharded(means3d, cov3d, colors, opacities, valid_mask, bg=None):
        dev = means3d.device
        c = means3d.shape[0]
        d_col = colors.shape[-1]
        cap = max(1, math.ceil(c / n_slabs * capacity_factor))
        proj = _project(camera, means3d, cov3d, valid_mask)
        visible = proj.radii > 0

        # ---- depth bands: the range max-reduced, the histogram summed
        big = torch.tensor(1e10, device=dev)
        ends = torch.stack([torch.amax(torch.where(visible, -proj.depths, -big)),
                            torch.amax(torch.where(visible, proj.depths, -big))])
        ends = max_blocks(gather_blocks(mesh, ends, axis))
        mn, mx = -ends[0], ends[1]
        span = torch.clamp(mx - mn, min=1e-6)
        depths = torch.where(visible, proj.depths, mn)
        bin_of = torch.clamp(((depths - mn) / span * depth_bins).to(torch.int64),
                             0, depth_bins - 1)
        hist = torch.bincount(bin_of[visible], minlength=depth_bins)
        hist = sum_blocks(gather_blocks(mesh, hist, axis))
        cum = torch.cumsum(hist, dim=0)
        targets = (torch.arange(1, n_slabs, device=dev) * cum[-1] + n_slabs - 1) // n_slabs
        bound_bins = torch.searchsorted(cum, targets, side="left")
        dest = torch.searchsorted(bound_bins, bin_of, side="right")
        dest = torch.where(visible, dest, torch.full_like(dest, n_slabs))  # n_slabs: none

        # ---- pack each Gaussian and place it in its band's send block
        packed = torch.cat([means3d, cov3d, colors, opacities[:, None],
                            visible.to(means3d.dtype)[:, None]], dim=1)
        f = packed.shape[1]
        order = torch.argsort(dest, stable=True)
        dest_s = dest[order]
        first = torch.searchsorted(dest_s, torch.arange(n_slabs + 1, device=dev))
        rank_s = torch.arange(c, device=dev) - first[dest_s]
        sent = (dest_s < n_slabs) & (rank_s < cap)
        # row n_slabs * cap takes what is not sent and is cut off after
        slot_s = torch.where(sent, dest_s * cap + rank_s, torch.full_like(dest_s, n_slabs * cap))
        send = torch.zeros((n_slabs * cap + 1, f), dtype=packed.dtype, device=dev)
        send[slot_s] = packed[order]
        dropped = torch.sum((dest_s < n_slabs) & (rank_s >= cap)).to(torch.float32)

        # ---- the re-slab: block k of `send` goes to rank k of the axis;
        # block j of `recv` is what rank j sent here
        send_buf = host_staged(mesh, send[:-1].contiguous())
        recv_buf = torch.empty_like(send_buf)
        dist.all_to_all_single(recv_buf, send_buf, group=mesh.groups[axis])
        recv = recv_buf.to(dev)
        res = render(camera, recv[:, 0:3], recv[:, 3:9], recv[:, 9 + d_col],
                     bg=torch.zeros((d_col,), dtype=means3d.dtype, device=dev),
                     colors_precomp=recv[:, 9:9 + d_col], valid_mask=recv[:, 10 + d_col] > 0.5,
                     backend=backend, tile_config=tile_config)
        (img, alpha, depth), extra = _gather_merge(
            mesh, axis, res.image, res.depth, _slab_log_t(res.alpha),
            torch.stack([dropped, res.dropped_pairs.to(torch.float32)]))
        dropped = sum_blocks(extra[:, 0]).to(torch.int64)
        out = RenderOutput(image=_with_bg(img, alpha, bg), alpha=alpha, depth=depth,
                           radii=torch.zeros((c,), dtype=torch.int32, device=dev),
                           dropped_pairs=max_blocks(extra[:, 1]).to(torch.int64))
        return out, dropped

    return render_msharded
