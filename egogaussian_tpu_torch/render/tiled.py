"""Tile binning and the chunk-padded pair layout of the tile-grid compositor.

Port of the main-path parts of `egogaussian_tpu/render/tiled.py`:

  1. depth-sort Gaussians (stable, so order within a tile == depth order)
  2. exact pair expansion: each Gaussian emits one pair per overlapped tile,
     with the opacity-aware AABB and the exact conic-vs-tile-rectangle cull
     (both output-identical: culled pairs would only ever get alpha < 1/255)
  3. sort pairs by (tile id, depth rank); per-tile ranges by searchsorted
  4. lay each tile's run out padded to 128-pair chunks, transposed per chunk
     ([n_slots, ch16, 128]), and composite with the tile-grid kernel pair
     (render/cuda_raster.py)

Every static capacity that can lose a pair counts it in `dropped`; nothing
is dropped silently. Scatters that JAX writes with mode="drop" use a buffer
with one sentinel slot at the end, which is sliced off.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from egogaussian_tpu_torch.render.oracle import ALPHA_EPS, RenderOutput
from egogaussian_tpu_torch.render.project import ProjectedGaussians

CHUNK = 128  # pairs per chunk of the padded layout (the kernels' unit)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Binning capacities, with the JAX package's TileConfig meanings. Its
    kernel-selecting fields for flavors not ported yet (compositor,
    bwd_exact_total, scatter_layout) come with those flavors. `mxu_accum`
    keeps its meaning (accumulate each chunk as one matmul); on the card
    both settings accumulate with float32 FMAs, because tensor cores in
    TF32 would break the error bounds the kernels are held to."""

    tile_size: int = 16
    max_pairs: Optional[int] = None  # default 16 * N
    max_per_tile: int = 1024
    # chunk-slot capacity of the padded layout; defaults to max_pairs
    max_slots: Optional[int] = None
    mxu_accum: bool = True


def _default_config(n: int, config: Optional[TileConfig], n_tiles: int) -> TileConfig:
    config = config or TileConfig()
    if config.max_pairs is None:
        mp = max(16 * n, 4096)
        # chunk-padding floor: every nonempty tile takes >= one chunk
        mp = max(mp, CHUNK * n_tiles)
        mp = -(-mp // CHUNK) * CHUNK
        config = dataclasses.replace(config, max_pairs=mp)
    elif config.max_pairs % CHUNK != 0:
        config = dataclasses.replace(
            config, max_pairs=-(-config.max_pairs // CHUNK) * CHUNK
        )
    return config


def _next_pow2(x: int) -> int:
    p = 128
    while p < x:
        p *= 2
    return p


def opacity_aabb_radius(radii, opacities, q_margin: float = 1e-3):
    """Opacity-aware reach radius (pixels) + log-opacity threshold: the disk
    that can reach alpha >= ALPHA_EPS has radius sigma*sqrt(2*ln(op/eps)),
    with sigma <= radii/3. Returns (r_aabb [N], thr [N]); splats with
    op < ALPHA_EPS (thr < 0) reach nowhere and are masked by the caller."""
    thr = torch.log(torch.clamp(opacities, min=1e-30) * (1.0 / ALPHA_EPS))
    sigma = radii * (1.0 / 3.0)
    r_aabb = torch.minimum(
        radii, sigma * torch.sqrt(torch.clamp(2.0 * thr + q_margin, min=0.0))
    )
    return r_aabb, thr


def estimate_tile_config(
    means2d,
    radii,
    width: int,
    height: int,
    tile_size: int = 16,
    headroom: float = 1.5,
    opacities=None,
) -> TileConfig:
    """Host-side sizing of the binning capacities from one projection
    (same estimate as the JAX package: 99.5th-percentile tile occupancy
    times headroom, capacities rounded to 16k multiples). Call at phase
    start and at densify intervals; it copies to the host."""
    ts = tile_size
    n_tx = -(-width // ts)
    n_ty = -(-height // ts)
    mu = means2d.detach().cpu().numpy()
    r = radii.detach().cpu().numpy().astype(np.float32)
    ok = r > 0
    if opacities is not None:
        op = opacities.detach().cpu().numpy().astype(np.float32).reshape(-1)
        thr = np.log(np.maximum(op, 1e-30) / ALPHA_EPS)
        ok = ok & (op >= ALPHA_EPS)
        r = np.minimum(r, (r / 3.0) * np.sqrt(np.maximum(2.0 * thr + 1e-3, 0.0)))
    x0 = np.clip(np.floor((mu[:, 0] - r) / ts), 0, n_tx - 1)
    x1 = np.clip(np.floor((mu[:, 0] + r) / ts), 0, n_tx - 1)
    y0 = np.clip(np.floor((mu[:, 1] - r) / ts), 0, n_ty - 1)
    y1 = np.clip(np.floor((mu[:, 1] + r) / ts), 0, n_ty - 1)
    cnt = np.where(ok, (x1 - x0 + 1) * (y1 - y0 + 1), 0).astype(np.int64)
    total = int(cnt.sum())

    # per-tile occupancy via 2D inclusion-exclusion + prefix sums
    delta = np.zeros((n_ty + 1, n_tx + 1), np.int64)
    xs0, xs1 = x0[ok].astype(int), x1[ok].astype(int)
    ys0, ys1 = y0[ok].astype(int), y1[ok].astype(int)
    np.add.at(delta, (ys0, xs0), 1)
    np.add.at(delta, (ys0, xs1 + 1), -1)
    np.add.at(delta, (ys1 + 1, xs0), -1)
    np.add.at(delta, (ys1 + 1, xs1 + 1), 1)
    tile_cnt = delta.cumsum(0).cumsum(1)[:n_ty, :n_tx]
    occ = tile_cnt[tile_cnt > 0]
    p_occ = float(np.percentile(occ, 99.5)) if occ.size else 0.0
    max_per_tile = min(_next_pow2(max(int(p_occ * headroom), 128)), 4096)
    padded_total = int((-(-np.minimum(tile_cnt, max_per_tile) // CHUNK) * CHUNK).sum())
    max_pairs = max(int(total * headroom), 4096)
    max_pairs = -(-max_pairs // 16384) * 16384
    max_slots = max(int(total * headroom) + (padded_total - total), 4096)
    max_slots = -(-max_slots // 16384) * 16384
    return TileConfig(
        tile_size=ts, max_pairs=max_pairs, max_per_tile=max_per_tile,
        max_slots=max_slots,
    )


def _scatter_amax(size: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """zeros(size).at[idx].max(vals, mode="drop"): indices outside
    [0, size) land in a sentinel slot that is sliced off."""
    idx = torch.where((idx >= 0) & (idx < size), idx, torch.full_like(idx, size))
    buf = torch.zeros(size + 1, dtype=vals.dtype, device=vals.device)
    buf.scatter_reduce_(0, idx, vals, reduce="amax", include_self=True)
    return buf[:size]


def bin_pairs(
    proj: ProjectedGaussians, width: int, height: int, config: TileConfig,
    opacities: Optional[torch.Tensor] = None,
):
    """Exact tile binning at the pair level (port of the JAX bin_pairs,
    pair for pair). With `opacities`, pairs that provably contribute nothing
    (alpha < ALPHA_EPS at every pixel of the tile) are culled by the
    opacity-aware AABB and the exact min-Q test, each with a 1e-3 margin.

    Returns:
      order: [N] depth-sort permutation
      g_sorted: [max_pairs] gaussian index (into depth-sorted arrays) of each
        pair, sorted by tile id (depth order preserved within tiles)
      tile_sorted: [max_pairs] tile id (n_tiles for invalid pairs)
      starts: [n_tiles] first pair index of each tile
      tile_cnt: [n_tiles] pairs per tile (clamped to max_per_tile)
      dropped: scalar, pairs lost to static capacities
      (n_tx, n_ty)
    All integer outputs are int64 on the projection's device.
    """
    ts = config.tile_size
    n_tx = -(-width // ts)
    n_ty = -(-height // ts)
    n_tiles = n_tx * n_ty
    n = proj.depths.shape[0]
    dev = proj.means2d.device
    dt = proj.means2d.dtype
    mp = config.max_pairs
    q_margin = 1e-3
    if dt != torch.float32:
        # int columns travel through the pair gather as float32: exact only
        # for f32 and values < 2^24
        raise TypeError(f"bin_pairs needs float32 projections, got {dt}")
    if mp >= (1 << 24):
        raise ValueError(f"max_pairs {mp} too large for int-in-f32 pair fields")

    with torch.no_grad():
        valid = proj.radii > 0
        key = torch.where(valid, proj.depths, torch.full_like(proj.depths, float("inf")))
        order = torch.argsort(key, stable=True)
        per_g = [proj.means2d, proj.radii.to(dt)[:, None]]
        if opacities is not None:
            per_g += [proj.conics, opacities.to(dt)[:, None]]
        mu_r = torch.cat(per_g, dim=1)[order]
        means2d = mu_r[:, 0:2]
        radii = mu_r[:, 2]
        valid_s = radii > 0

        if opacities is not None:
            op_s = mu_r[:, 6]
            r_aabb, thr = opacity_aabb_radius(radii, op_s, q_margin=q_margin)
            valid_s = valid_s & (op_s >= ALPHA_EPS)
        else:
            r_aabb = radii

        def tile_coord(v, hi):
            return torch.clamp(torch.floor(v / ts), 0, hi).to(torch.int64)

        x0 = tile_coord(means2d[:, 0] - r_aabb, n_tx - 1)
        x1 = tile_coord(means2d[:, 0] + r_aabb, n_tx - 1)
        y0 = tile_coord(means2d[:, 1] - r_aabb, n_ty - 1)
        y1 = tile_coord(means2d[:, 1] + r_aabb, n_ty - 1)
        zero = torch.zeros_like(x0)
        tw = torch.where(valid_s, x1 - x0 + 1, zero)
        th = torch.where(valid_s, y1 - y0 + 1, zero)
        counts = tw * th  # pairs emitted per Gaussian

        offsets = torch.cumsum(counts, 0) - counts  # exclusive
        total = (offsets[-1] + counts[-1]) if n > 0 else torch.zeros((), dtype=torch.int64, device=dev)

        # pair slot p -> owning Gaussian g: mark each Gaussian at its start
        # slot, then a running max (searchsorted(offsets, p, 'right') - 1)
        p_idx = torch.arange(mp, dtype=torch.int64, device=dev)
        start_slots = torch.where(counts > 0, offsets, torch.full_like(offsets, mp))
        marks = _scatter_amax(mp, start_slots, torch.arange(1, n + 1, dtype=torch.int64, device=dev))
        g = torch.clamp(torch.cummax(marks, 0).values - 1, 0, max(n - 1, 0))

        if opacities is not None:
            gf = torch.stack(
                [
                    offsets.to(dt), x0.to(dt), y0.to(dt), tw.to(dt),
                    means2d[:, 0], means2d[:, 1],
                    mu_r[:, 3], mu_r[:, 4], mu_r[:, 5],  # conic A, B, C
                    thr,
                ],
                dim=1,
            )
            pf = gf[g]  # [MP, 10]
            pair_fields = pf[:, 0:4].to(torch.int64)
        else:
            pair_fields = torch.stack([offsets, x0, y0, tw], dim=1)[g]
        local = p_idx - pair_fields[:, 0]
        pair_ok = p_idx < total
        tw_g = torch.clamp(pair_fields[:, 3], min=1)
        tx = pair_fields[:, 1] + local % tw_g
        ty = pair_fields[:, 2] + local // tw_g
        tile_id = torch.where(pair_ok, ty * n_tx + tx, torch.full_like(tx, n_tiles))

        if opacities is not None:
            # exact min of Q(d) = 0.5*A*dx^2 + B*dx*dy + 0.5*C*dy^2 over the
            # tile's pixel-center rectangle (0 if the mean is inside, else on
            # one of the 4 edges, each a clamped 1D quadratic)
            mx, my = pf[:, 4], pf[:, 5]
            A, B, C = pf[:, 6], pf[:, 7], pf[:, 8]
            thr_p = pf[:, 9]
            txf = tx.to(dt) * ts
            tyf = ty.to(dt) * ts
            lox, hix = txf + 0.5 - mx, txf + (ts - 0.5) - mx
            loy, hiy = tyf + 0.5 - my, tyf + (ts - 0.5) - my

            def edge_x(X):
                dy = torch.minimum(torch.maximum(-B * X / C, loy), hiy)
                return 0.5 * A * X * X + B * X * dy + 0.5 * C * dy * dy

            def edge_y(Y):
                dx = torch.minimum(torch.maximum(-B * Y / A, lox), hix)
                return 0.5 * C * Y * Y + B * Y * dx + 0.5 * A * dx * dx

            min_q = torch.minimum(
                torch.minimum(edge_x(lox), edge_x(hix)),
                torch.minimum(edge_y(loy), edge_y(hiy)),
            )
            inside = (lox <= 0) & (hix >= 0) & (loy <= 0) & (hiy >= 0)
            min_q = torch.where(inside, torch.zeros_like(min_q), min_q)
            keep = min_q <= thr_p + q_margin
            tile_id = torch.where(keep, tile_id, torch.full_like(tile_id, n_tiles))

        # sort by (tile id, depth rank) with one packed int64 key (unique)
        packed_sorted = torch.sort((tile_id << 32) | g).values
        tile_sorted = packed_sorted >> 32
        g_sorted = packed_sorted & 0xFFFFFFFF

        bounds = torch.searchsorted(
            tile_sorted, torch.arange(n_tiles + 1, dtype=torch.int64, device=dev)
        )
        starts = bounds[:n_tiles]
        raw_cnt = bounds[1:] - starts
        tile_cnt = torch.clamp(raw_cnt, max=config.max_per_tile)
        dropped = torch.clamp(total - mp, min=0) + torch.sum(
            torch.clamp(raw_cnt - config.max_per_tile, min=0)
        )
    return order, g_sorted, tile_sorted, starts, tile_cnt, dropped, (n_tx, n_ty)


def _untile(x: torch.Tensor, n_tx: int, n_ty: int, ts: int, width: int, height: int):
    """[n_tiles, P, C] -> [C, H, W], cropping tile padding."""
    c = x.shape[-1]
    x = x.reshape(n_ty, n_tx, ts, ts, c)
    x = x.permute(0, 2, 1, 3, 4).reshape(n_ty * ts, n_tx * ts, c)
    return x[:height, :width].permute(2, 0, 1)


class TilegridLayout(NamedTuple):
    """Inputs of the tile-grid compositor for one render."""

    meta: torch.Tensor  # [3, T] int32
    vals: torch.Tensor  # [n_slots, ch16, 128] float32 (differentiable)
    empty: torch.Tensor  # [T] bool: tile owns no chunk (empty or overflowed)
    dropped: torch.Tensor  # pairs lost to binning / slot capacity
    n_tx: int
    n_ty: int
    tile_size: int


def tilegrid_layout(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    width: int,
    height: int,
    config: Optional[TileConfig] = None,
) -> TilegridLayout:
    """Bin the pairs and lay each tile's depth-sorted run out padded to whole
    128-pair chunks (port of the tilegrid branch of the JAX
    `composite_pallas`, gather layout: slot q of tile t holds pair
    starts[t] + (q - starts2[t])). Tiles whose padded run does not fit the
    slot capacity own no chunk and their pairs count as dropped. The pair
    gather runs in torch, so its backward (index_add back to the Gaussians)
    is autograd's."""
    from egogaussian_tpu_torch.render.cuda_raster import ch16_of

    n = proj.depths.shape[0]
    d = colors.shape[-1]
    ts = (config or TileConfig()).tile_size
    n_tiles0 = (-(-width // ts)) * (-(-height // ts))
    config = _default_config(n, config, n_tiles0)

    order, g_sorted, _, starts, tile_cnt, dropped, (n_tx, n_ty) = bin_pairs(
        proj, width, height, config, opacities=opacities
    )
    n_tiles = n_tx * n_ty
    sc = config.max_slots or config.max_pairs
    sc = -(-sc // CHUNK) * CHUNK
    n_slots = sc // CHUNK

    with torch.no_grad():
        padded_cnt = ((tile_cnt + CHUNK - 1) // CHUNK) * CHUNK
        starts2 = torch.cumsum(padded_cnt, 0) - padded_cnt  # padded starts
        overflowed = starts2 + padded_cnt > sc
        zero = torch.zeros_like(tile_cnt)
        dropped = dropped + torch.sum(torch.where(overflowed, tile_cnt, zero))
        fit_slots = torch.sum(torch.where(overflowed, zero, padded_cnt)) // CHUNK
        meta = torch.stack([
            torch.where(overflowed, zero, starts2 // CHUNK),
            torch.where(overflowed, zero, tile_cnt),
            fit_slots.expand(n_tiles),
        ]).to(torch.int32).contiguous()

        # per-slot pair index: the owner tile's (start, padded start) by a
        # scatter at the padded start and a running max
        q = torch.arange(sc, dtype=torch.int64, device=tile_cnt.device)
        a_q = torch.cummax(_scatter_amax(sc, starts2, starts), 0).values
        b_q = torch.cummax(_scatter_amax(sc, starts2, starts2), 0).values
        p_q = torch.clamp(a_q + (q - b_q), 0, config.max_pairs - 1)
        # Gaussian of each slot, as an index into the unsorted arrays: one
        # row gather (and one index backward) instead of two
        src = order[g_sorted[p_q]]

    packed = torch.cat(
        [proj.means2d, proj.conics, opacities[:, None], colors, proj.depths[:, None]],
        dim=1,
    )
    ch16 = ch16_of(d)
    rows = torch.nn.functional.pad(packed, (0, ch16 - packed.shape[1]))[src]
    vals = rows.reshape(n_slots, CHUNK, ch16).transpose(1, 2).contiguous()
    return TilegridLayout(meta, vals, (tile_cnt == 0) | overflowed, dropped,
                          n_tx, n_ty, ts)


def composite_cuda(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    bg: torch.Tensor,
    width: int,
    height: int,
    config: Optional[TileConfig] = None,
) -> RenderOutput:
    """Same semantics as the oracle, composited by the tile-grid kernel pair
    over the chunk-padded layout (tilegrid_layout)."""
    from egogaussian_tpu_torch.render.cuda_raster import TileGridCompositor

    lay = tilegrid_layout(proj, colors, opacities, width, height, config)
    ts, n_tx, n_ty = lay.tile_size, lay.n_tx, lay.n_ty
    img_t, alpha_t, depth_t = TileGridCompositor.apply(
        lay.meta, lay.vals, bg[None, :], ts, n_tx)
    # tiles owning no chunk (empty or overflowed) are background / zero
    empty = lay.empty[:, None, None]
    img_t = torch.where(empty, bg[None, None, :].to(img_t.dtype), img_t)
    alpha_t = torch.where(empty, torch.zeros_like(alpha_t), alpha_t)
    depth_t = torch.where(empty, torch.zeros_like(depth_t), depth_t)
    return RenderOutput(
        image=_untile(img_t, n_tx, n_ty, ts, width, height),
        alpha=_untile(alpha_t, n_tx, n_ty, ts, width, height),
        depth=_untile(depth_t, n_tx, n_ty, ts, width, height),
        radii=proj.radii,
        dropped_pairs=lay.dropped,
    )
