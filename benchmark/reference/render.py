"""Plain PyTorch 3D Gaussian splatting: projection and tiled compositing.

The benchmark's reference renderer. It follows the published 3DGS
rasterizer (Kerbl et al. 2023) and imports nothing of the program:

  * EWA projection: t = R x + t_w; J the perspective Jacobian with the
    tangent-plane clamp at 1.3 tan(fov / 2); cov2d = J R Sigma R^T J^T +
    0.3 I; conic = cov2d^-1; radius = ceil(3 sqrt(lambda_max)); culled when
    z <= 0.2, det <= 0 or the 3-sigma box misses the image.
  * A Gaussian reaches every pixel of the ts x ts tiles its 3-sigma box
    touches, in depth order (ties by index).
  * alpha = min(0.99, o exp(-0.5 d^T conic d)), zeroed below 1/255;
    w_i = alpha_i prod_{j<i} (1 - alpha_j); rgb = sum w c + T_final bg;
    alpha_out = sum w.

Written in matrix form with `torch.matmul` and `einsum` where the program
writes channel-wise, so the two agree to float32 rounding and share no
code. The compositor walks blocks of tiles and recomputes each block in
the backward, so a 1600x900 frame of 500,000 Gaussians fits in memory.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_SATURATED = 1e-4  # 3DGS stops a pixel once its transmittance falls below
SH_C0 = 0.28209479177387814
BLOCK_ELEMS = 1 << 24  # pair-pixel entries of one block of tiles


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternions [N, 4] (normalized here) -> rotations [N, 3, 3]."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))


def covariance(log_scales: torch.Tensor, quats: torch.Tensor,
               extra_rot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sigma = R S S^T R^T [N, 3, 3]; with extra_rot [3, 3] (or [N, 3, 3]),
    the rotated covariance E Sigma E^T."""
    L = quat_to_rotmat(quats) * torch.exp(log_scales)[:, None, :]
    cov = L @ L.transpose(-1, -2)
    if extra_rot is not None:
        cov = extra_rot @ cov @ extra_rot.transpose(-1, -2)
    return cov


def sh0_colors(features_dc: torch.Tensor) -> torch.Tensor:
    """Degree-0 SH [N, 1, 3] -> RGB clamped at 0. At exactly 0 the gradient
    is split in half (`torch.maximum`'s tie), as the JAX package and the
    port take it; 3DGS's CUDA rasterizer passes it whole there."""
    rgb = features_dc[:, 0, :] * SH_C0 + 0.5
    return torch.maximum(rgb, torch.zeros_like(rgb))


class Camera(NamedTuple):
    viewmat: torch.Tensor  # [4, 4] world to camera
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


class Projected(NamedTuple):
    means2d: torch.Tensor  # [N, 2]
    conic: torch.Tensor  # [N, 3] (a, b, c) of [[a, b], [b, c]]
    depth: torch.Tensor  # [N]
    radius: torch.Tensor  # [N] float, 0 = culled


def project(xyz: torch.Tensor, cov3d: torch.Tensor, cam: Camera,
            alive: Optional[torch.Tensor] = None) -> Projected:
    R = cam.viewmat[:3, :3]
    t_cam = xyz @ R.T + cam.viewmat[:3, 3]
    x, y, z = t_cam.unbind(-1)
    front = z > 0.2
    zs = torch.where(front, z, torch.ones_like(z))
    lim_x = 1.3 * 0.5 * cam.width / cam.fx
    lim_y = 1.3 * 0.5 * cam.height / cam.fy
    u_t = torch.clamp(x / zs, -lim_x, lim_x)
    v_t = torch.clamp(y / zs, -lim_y, lim_y)
    zero = torch.zeros_like(zs)
    J = torch.stack([
        torch.stack([cam.fx / zs, zero, -cam.fx * u_t / zs], dim=-1),
        torch.stack([zero, cam.fy / zs, -cam.fy * v_t / zs], dim=-1),
    ], dim=-2)  # [N, 2, 3]
    M = J @ R
    cov2 = M @ cov3d @ M.transpose(-1, -2)
    a = cov2[:, 0, 0] + 0.3
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + 0.3
    det = a * c - b * b
    det_ok = det > 0
    det_s = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c / det_s, -b / det_s, a / det_s], dim=-1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    r = torch.ceil(3.0 * torch.sqrt(lam)).detach()
    u = cam.fx * x / zs + cam.cx
    v = cam.fy * y / zs + cam.cy
    on = (u + r > 0) & (u - r < cam.width) & (v + r > 0) & (v - r < cam.height)
    keep = front & det_ok & on
    if alive is not None:
        keep = keep & alive
    radius = torch.where(keep, r, torch.zeros_like(r))
    return Projected(torch.stack([u, v], dim=-1), conic, z, radius)


class Bins(NamedTuple):
    """Pairs (Gaussian, tile) sorted by tile, then depth."""
    g_sorted: torch.Tensor  # [P] Gaussian index
    starts: torch.Tensor  # [T]
    counts: torch.Tensor  # [T]
    n_tx: int
    n_ty: int
    ts: int
    blocks: List[Tuple[int, int, int]]  # (first tile, end tile, widest count)


def bin_tiles(proj: Projected, width: int, height: int, ts: int,
              block_elems: int = BLOCK_ELEMS) -> Bins:
    with torch.no_grad():
        dev = proj.depth.device
        n = proj.depth.shape[0]
        n_tx, n_ty = -(-width // ts), -(-height // ts)
        valid = proj.radius > 0
        order = torch.argsort(torch.where(valid, proj.depth, torch.full_like(proj.depth, math.inf)),
                              stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(n, device=dev)
        mx, my = proj.means2d[:, 0], proj.means2d[:, 1]
        r = proj.radius

        def tile(v, hi):
            return torch.clamp(torch.floor(v / ts), 0, hi).to(torch.int64)

        x0, x1 = tile(mx - r, n_tx - 1), tile(mx + r, n_tx - 1)
        y0, y1 = tile(my - r, n_ty - 1), tile(my + r, n_ty - 1)
        tw = x1 - x0 + 1
        cnt = torch.where(valid, tw * (y1 - y0 + 1), torch.zeros_like(tw))
        gid = torch.repeat_interleave(torch.arange(n, device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        local = torch.arange(gid.shape[0], device=dev) - first[gid]
        tid = (y0[gid] + local // tw[gid]) * n_tx + x0[gid] + local % tw[gid]
        key, perm = torch.sort(tid * n + rank[gid])
        g_sorted = gid[perm]
        counts = torch.bincount(key // n, minlength=n_tx * n_ty)
        starts = torch.cumsum(counts, 0) - counts
    blocks, lo, widest = [], 0, 1
    pix = ts * ts
    for t, c in enumerate(counts.tolist()):
        w = max(widest, c, 1)
        if t > lo and (t - lo + 1) * w * pix > block_elems:
            blocks.append((lo, t, widest))
            lo, w = t, max(c, 1)
        widest = w
    blocks.append((lo, n_tx * n_ty, widest))
    return Bins(g_sorted, starts, counts, n_tx, n_ty, ts, blocks)


def _block_pixels(bins: Bins, lo: int, hi: int, width: int, height: int, device):
    t = torch.arange(lo, hi, device=device)
    p = torch.arange(bins.ts * bins.ts, device=device)
    x = (t % bins.n_tx)[:, None] * bins.ts + p % bins.ts
    y = (t // bins.n_tx)[:, None] * bins.ts + p // bins.ts
    inside = (x < width) & (y < height)
    flat = torch.where(inside, y * width + x, torch.zeros_like(x))
    return x.float() + 0.5, y.float() + 0.5, flat, inside


def _block_pairs(bins: Bins, lo: int, hi: int, widest: int):
    k = torch.arange(widest, device=bins.starts.device)
    idx = bins.starts[lo:hi, None] + k
    live = k < bins.counts[lo:hi, None]
    last = max(bins.g_sorted.shape[0] - 1, 0)
    if bins.g_sorted.shape[0] == 0:
        return torch.zeros_like(idx), live
    return bins.g_sorted[torch.clamp(idx, max=last)], live


def _block_alpha(means2d, conic, opacity, g, live, px, py):
    """alpha [B, K, P] of each tile's pairs at its pixels."""
    dx = px[:, None, :] - means2d[g, 0][..., None]
    dy = py[:, None, :] - means2d[g, 1][..., None]
    a, b, c = (conic[g, i][..., None] for i in range(3))
    power = torch.clamp(-0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy, max=0.0)
    alpha = torch.clamp(opacity[g][..., None] * torch.exp(power), max=ALPHA_MAX)
    keep = (alpha >= ALPHA_EPS) & live[..., None]
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def _block_composite(means2d, conic, opacity, colors, bg, g, live, px, py):
    alpha = _block_alpha(means2d, conic, opacity, g, live, px, py)
    trans = torch.cumprod(1.0 - alpha, dim=1)
    before = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
    w = alpha * before
    img = torch.einsum("bkp,bkd->bdp", w, colors[g]) + trans[:, -1:, :] * bg[None, :, None]
    return img, torch.sum(w, dim=1)


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, means2d, conic, opacity, colors, bg, bins, width, height):
        d = colors.shape[-1]
        img = torch.zeros((d, height * width), dtype=colors.dtype, device=colors.device)
        acc = torch.zeros((height * width,), dtype=colors.dtype, device=colors.device)
        for lo, hi, widest in bins.blocks:
            px, py, flat, inside = _block_pixels(bins, lo, hi, width, height, colors.device)
            g, live = _block_pairs(bins, lo, hi, widest)
            bi, ba = _block_composite(means2d, conic, opacity, colors, bg, g, live, px, py)
            f = flat[inside]
            img[:, f] = bi.permute(1, 0, 2)[:, inside]
            acc[f] = ba[inside]
        ctx.save_for_backward(means2d, conic, opacity, colors, bg)
        ctx.bins, ctx.size = bins, (width, height)
        return img.reshape(d, height, width), acc.reshape(1, height, width)

    @staticmethod
    def backward(ctx, g_img, g_acc):
        means2d, conic, opacity, colors, bg = ctx.saved_tensors
        bins, (width, height) = ctx.bins, ctx.size
        d = colors.shape[-1]
        g_img = g_img.reshape(d, -1)
        g_acc = g_acc.reshape(-1)
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True) for x in (means2d, conic, opacity, colors)]
            for lo, hi, widest in bins.blocks:
                px, py, flat, inside = _block_pixels(bins, lo, hi, width, height, colors.device)
                g, live = _block_pairs(bins, lo, hi, widest)
                bi, ba = _block_composite(*leaves, bg.detach(), g, live, px, py)
                m = inside.to(g_img.dtype)
                gi = g_img[:, flat].permute(1, 0, 2) * m[:, None, :]
                torch.autograd.backward([bi, ba], [gi, g_acc[flat] * m])
        grads = [x.grad if x.grad is not None else torch.zeros_like(x) for x in leaves]
        return (*grads, None, None, None, None)


def composite(proj: Projected, opacity: torch.Tensor, colors: torch.Tensor, bg: torch.Tensor,
              width: int, height: int, ts: int, block_elems: int = BLOCK_ELEMS):
    """(image [D, H, W], alpha [1, H, W], bins)."""
    bins = bin_tiles(proj, width, height, ts, block_elems)
    img, acc = _Composite.apply(proj.means2d, proj.conic, opacity, colors, bg, bins, width,
                                height)
    return img, acc, bins


def covered_evaluations(proj: Projected, opacity: torch.Tensor, bins: Bins, width: int,
                        height: int) -> Tuple[int, int]:
    """(evaluations, pairs) a 3DGS compositor has to make: pair-pixels with
    alpha >= 1/255 at a pixel whose transmittance in front has not fallen
    below 1e-4, and the (Gaussian, tile) pairs holding at least one."""
    total, pairs = 0, 0
    with torch.no_grad():
        for lo, hi, widest in bins.blocks:
            px, py, _, inside = _block_pixels(bins, lo, hi, width, height, opacity.device)
            g, live = _block_pairs(bins, lo, hi, widest)
            alpha = _block_alpha(proj.means2d, proj.conic, opacity, g, live, px, py)
            trans = torch.cumprod(1.0 - alpha, dim=1)
            before = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
            hit = (alpha > 0) & (before >= T_SATURATED) & inside[:, None, :]
            total += int(hit.sum())
            pairs += int(hit.any(dim=2).sum())
    return total, pairs


def render(xyz, cov3d, opacity, colors, cam: Camera, bg, ts: int, alive=None,
           block_elems: int = BLOCK_ELEMS):
    """Project and composite. Returns (image, alpha, projection, bins)."""
    proj = project(xyz, cov3d, cam, alive)
    img, acc, bins = composite(proj, opacity, colors, bg, cam.width, cam.height, ts, block_elems)
    return img, acc, proj, bins
