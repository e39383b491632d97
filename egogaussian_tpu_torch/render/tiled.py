"""Tile binning, the per-tile gather window and the chunk-padded pair
layouts of the binned compositors.

Port of `egogaussian_tpu/render/tiled.py`:

  1. depth-sort Gaussians (stable, so order within a tile == depth order)
  2. exact pair expansion: each Gaussian emits one pair per overlapped tile,
     with the opacity-aware AABB and the exact conic-vs-tile-rectangle cull
     (both output-identical: culled pairs would only ever get alpha < 1/255)
  3. sort pairs by (tile id, depth rank); per-tile ranges by searchsorted
  4. composite, on one of two layouts:
       the per-tile gather window [T, M] of `bin_gaussians` (backend
         "tiled", `composite_tiled`): the chunked windowed kernel pair
         (render/window_raster.py)
       each tile's run padded to 128-pair chunks (backend "cuda",
         `composite_cuda`), with one of two kernel flavors chosen by
         TileConfig.compositor:
         "tilegrid": per-tile meta, chunks transposed ([n_slots, ch16, 128]),
           the tile-grid kernel pair (render/cuda_raster.py)
         "stream": per-slot meta, pairs row-major ([n_slots*128, 7+D]), the
           stream kernel pair (render/stream_raster.py)

Every static capacity that can lose a pair counts it in `dropped`; nothing
is dropped silently. Each pair slot's Gaussian and each layout slot's tile
are found by a parallel binary search (pair_owner, slot_owner) where JAX
scatters marks and takes a running max; the owners are the same.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from egogaussian_tpu_torch.render.oracle import ALPHA_EPS, RenderOutput
from egogaussian_tpu_torch.render.project import ProjectedGaussians
from egogaussian_tpu_torch.utils.logging import spanned

CHUNK = 128  # pairs per chunk of the padded layout (the kernels' unit)


COMPOSITORS = ("tilegrid", "stream")


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Binning capacities and kernel flavors, with the JAX package's
    TileConfig meanings. `map_batch` is the number of tiles per batch of
    the tiled backend's CPU twins (on the card the kernel takes every tile
    in one launch). `mxu_accum` keeps its meaning (accumulate each chunk as
    one matmul); on the card both settings accumulate with float32 FMAs,
    because tensor cores in TF32 would break the error bounds the kernels
    are held to. The JAX-only `scatter_layout` (an XLA layout choice with
    no kernel of its own) is not ported."""

    tile_size: int = 16
    max_pairs: Optional[int] = None  # default 16 * N
    max_per_tile: int = 1024
    map_batch: int = 64  # tiles per batch of the tiled backend's CPU twins
    # chunk-slot capacity of the padded layout; defaults to max_pairs
    max_slots: Optional[int] = None
    # compositor kernel pair: "tilegrid" (one block per tile) or "stream"
    # (per-slot meta, log-space transmittance)
    compositor: str = "tilegrid"
    # tile-grid backward flavor: False rebuilds each pixel's weighted
    # gradient total from the saved outputs; True recomputes it in a
    # value-only pre-sweep in the gradient sweep's own order
    bwd_exact_total: bool = False
    mxu_accum: bool = True

    def __post_init__(self):
        if self.compositor not in COMPOSITORS:
            raise ValueError(f"compositor {self.compositor!r} not in {COMPOSITORS}")


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


def pair_owner(offsets: torch.Tensor, counts: torch.Tensor, n_slots: int) -> torch.Tensor:
    """[n_slots] owner of each pair slot p: the Gaussian g with
    offsets[g] <= p < offsets[g] + counts[g], by a parallel binary search
    (searchsorted(offsets, p, right=True) - 1; no serial scan, no host
    sync). Gaussians of count 0 share their offset with the next one, and
    right=True picks the last index at an offset, the one that owns it.
    Slots at or past the total get the last Gaussian with count > 0 (0 if
    there is none), which is what the JAX package's scatter-max and
    running max give them; they still enter bin_pairs' sort key. Leading
    axes of offsets / counts ([S, N]) are scenes, each searched on its own."""
    n = offsets.shape[-1]
    lead = offsets.shape[:-1]
    p = torch.arange(n_slots, dtype=offsets.dtype, device=offsets.device)
    p = p.expand(lead + (n_slots,)).contiguous()
    if n == 0:
        return torch.zeros_like(p)
    idx = torch.arange(n, dtype=offsets.dtype, device=offsets.device)
    last = torch.amax(torch.where(counts > 0, idx, torch.zeros_like(idx)), dim=-1, keepdim=True)
    g = torch.searchsorted(offsets.contiguous(), p, right=True) - 1
    return torch.clamp(torch.minimum(g, last), min=0)


class SceneCaps(NamedTuple):
    """The binning of S scenes in one layout: a shared TileConfig whose
    capacities size the buffers (each field's max over the scenes) and
    each scene's own capacities, which decide what the scene drops, so a
    scene drops exactly the pairs it drops when binned alone. `sizes` are
    the scenes' composite sizes (crop windows may differ): the tile grid is
    the largest one, and each scene's pairs are clamped to its own grid."""

    config: TileConfig  # shared: tile size, kernel flavor, buffer sizes
    max_pairs: torch.Tensor  # [S] int64 per-scene max_pairs
    max_per_tile: torch.Tensor  # [S] int64 per-scene max_per_tile
    max_slots: torch.Tensor  # [S] int64 per-scene slot capacity (CHUNK multiple)
    sizes: tuple  # ((width, height), ...) per scene


def _slot_capacity(config: TileConfig) -> int:
    sc = config.max_slots or config.max_pairs
    return -(-sc // CHUNK) * CHUNK


def scene_caps(configs, sizes, device, n: int, default: bool = True) -> SceneCaps:
    """SceneCaps of S scenes binned together: `configs` one TileConfig (or
    None, the default for n Gaussians) per scene, `sizes` one (width,
    height) per scene. The scenes must share the tile size and the kernel
    flavor; the buffers take each capacity field's max over the scenes
    (not the config of the scene with the most pairs). default=False takes
    the configs' capacities as given (bin_pairs' contract)."""
    ts = (configs[0] or TileConfig()).tile_size
    full = []
    for cfg, (w, h) in zip(configs, sizes):
        full.append(_default_config(n, cfg, (-(-w // ts)) * (-(-h // ts))) if default
                    else cfg)
    kinds = {(c.tile_size, c.compositor, c.bwd_exact_total, c.mxu_accum, c.map_batch)
             for c in full}
    if len(kinds) != 1:
        raise ValueError(f"scenes binned together must share the tile size and the "
                         f"kernel flavor, got {sorted(kinds)}")
    shared = dataclasses.replace(
        full[0], max_pairs=max(c.max_pairs for c in full),
        max_per_tile=max(c.max_per_tile for c in full),
        max_slots=max(_slot_capacity(c) for c in full))

    def col(values):
        return torch.tensor(values, dtype=torch.int64, device=device)

    return SceneCaps(shared, col([c.max_pairs for c in full]),
                     col([c.max_per_tile for c in full]),
                     col([_slot_capacity(c) for c in full]),
                     tuple((int(w), int(h)) for w, h in sizes))


def _grid(caps: SceneCaps):
    """(n_tx, n_ty) of the shared grid and [S, 1] per-scene last tile
    column / row."""
    ts = caps.config.tile_size
    dev = caps.max_pairs.device
    ntx = [-(-w // ts) for w, _ in caps.sizes]
    nty = [-(-h // ts) for _, h in caps.sizes]
    hi_x = torch.tensor(ntx, dtype=torch.float32, device=dev)[:, None] - 1
    hi_y = torch.tensor(nty, dtype=torch.float32, device=dev)[:, None] - 1
    return max(ntx), max(nty), hi_x, hi_y


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
    All integer outputs are int64 on the projection's device. The binning
    of one scene of bin_scenes."""
    caps = scene_caps([config], [(width, height)], proj.means2d.device, proj.depths.shape[0],
                      default=False)
    out = bin_scenes(_lead(proj), caps, None if opacities is None else opacities[None])
    return tuple(x[0] for x in out[:6]) + (out[6],)


def _lead(proj: ProjectedGaussians) -> ProjectedGaussians:
    """The projection of one scene with a leading scene axis of 1."""
    return ProjectedGaussians(*(x[None] for x in proj))


@spanned("bin")
def bin_scenes(proj: ProjectedGaussians, caps: SceneCaps,
               opacities: Optional[torch.Tensor] = None):
    """bin_pairs for S scenes at once: proj fields [S, N, ...], opacities
    [S, N]. Each scene is binned against its own grid and capacities
    (caps) inside buffers of the shared sizes; the ops run once on [S, ...]
    tensors. Returns order [S, N], g_sorted [S, MP], tile_sorted [S, MP],
    starts [S, T], tile_cnt [S, T], dropped [S], (n_tx, n_ty), with T
    the shared grid's tiles (tile ids within the scene)."""
    config = caps.config
    ts = config.tile_size
    n_tx, n_ty, hi_x, hi_y = _grid(caps)
    n_tiles = n_tx * n_ty
    s_n, n = proj.depths.shape
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

    def take(x, idx):
        """x [S, N, k] rows idx [S, M] -> [S, M, k]."""
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    with torch.no_grad():
        valid = proj.radii > 0
        key = torch.where(valid, proj.depths, torch.full_like(proj.depths, float("inf")))
        order = torch.argsort(key, dim=-1, stable=True)
        per_g = [proj.means2d, proj.radii.to(dt)[..., None]]
        if opacities is not None:
            per_g += [proj.conics, opacities.to(dt)[..., None]]
        mu_r = take(torch.cat(per_g, dim=-1), order)
        means2d = mu_r[..., 0:2]
        radii = mu_r[..., 2]
        valid_s = radii > 0

        if opacities is not None:
            op_s = mu_r[..., 6]
            r_aabb, thr = opacity_aabb_radius(radii, op_s, q_margin=q_margin)
            valid_s = valid_s & (op_s >= ALPHA_EPS)
        else:
            r_aabb = radii

        def tile_coord(v, hi):
            return torch.clamp(torch.floor(v / ts), torch.zeros_like(hi), hi).to(torch.int64)

        x0 = tile_coord(means2d[..., 0] - r_aabb, hi_x)
        x1 = tile_coord(means2d[..., 0] + r_aabb, hi_x)
        y0 = tile_coord(means2d[..., 1] - r_aabb, hi_y)
        y1 = tile_coord(means2d[..., 1] + r_aabb, hi_y)
        zero = torch.zeros_like(x0)
        tw = torch.where(valid_s, x1 - x0 + 1, zero)
        th = torch.where(valid_s, y1 - y0 + 1, zero)
        counts = tw * th  # pairs emitted per Gaussian

        offsets = torch.cumsum(counts, -1) - counts  # exclusive
        total = (offsets[:, -1] + counts[:, -1] if n > 0
                 else torch.zeros((s_n,), dtype=torch.int64, device=dev))

        # pair slot p -> owning Gaussian g
        p_idx = torch.arange(mp, dtype=torch.int64, device=dev)
        g = pair_owner(offsets, counts, mp)  # [S, MP]

        if opacities is not None:
            gf = torch.stack(
                [
                    offsets.to(dt), x0.to(dt), y0.to(dt), tw.to(dt),
                    means2d[..., 0], means2d[..., 1],
                    mu_r[..., 3], mu_r[..., 4], mu_r[..., 5],  # conic A, B, C
                    thr,
                ],
                dim=-1,
            )
            pf = take(gf, g)  # [S, MP, 10]
            pair_fields = pf[..., 0:4].to(torch.int64)
        else:
            pair_fields = take(torch.stack([offsets, x0, y0, tw], dim=-1), g)
        local = p_idx - pair_fields[..., 0]
        # a scene keeps the pairs its own max_pairs holds
        pair_ok = p_idx < torch.minimum(total, caps.max_pairs)[:, None]
        tw_g = torch.clamp(pair_fields[..., 3], min=1)
        tx = pair_fields[..., 1] + local % tw_g
        ty = pair_fields[..., 2] + local // tw_g
        tile_id = torch.where(pair_ok, ty * n_tx + tx, torch.full_like(tx, n_tiles))

        if opacities is not None:
            # exact min of Q(d) = 0.5*A*dx^2 + B*dx*dy + 0.5*C*dy^2 over the
            # tile's pixel-center rectangle (0 if the mean is inside, else on
            # one of the 4 edges, each a clamped 1D quadratic)
            mx, my = pf[..., 4], pf[..., 5]
            A, B, C = pf[..., 6], pf[..., 7], pf[..., 8]
            thr_p = pf[..., 9]
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
        packed_sorted = torch.sort((tile_id << 32) | g, dim=-1).values
        tile_sorted = packed_sorted >> 32
        g_sorted = packed_sorted & 0xFFFFFFFF

        tiles = torch.arange(n_tiles + 1, dtype=torch.int64, device=dev)
        bounds = torch.searchsorted(tile_sorted, tiles.expand(s_n, -1).contiguous())
        starts = bounds[:, :n_tiles]
        raw_cnt = bounds[:, 1:] - starts
        mpt = caps.max_per_tile[:, None]
        tile_cnt = torch.minimum(raw_cnt, mpt)
        dropped = torch.clamp(total - caps.max_pairs, min=0) + torch.sum(
            torch.clamp(raw_cnt - mpt, min=0), dim=-1)
    return order, g_sorted, tile_sorted, starts, tile_cnt, dropped, (n_tx, n_ty)


def _tile_gather(starts, g_sorted, rows: int, max_pairs: int) -> torch.Tensor:
    """[n_tiles, rows] depth-sorted Gaussian index of each tile's window row:
    pair starts[t] + r, clipped at the last pair slot."""
    r = torch.arange(rows, dtype=torch.int64, device=starts.device)
    return g_sorted[torch.clamp(starts[:, None] + r[None, :], 0, max_pairs - 1)]


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [S, M] at idx [S, ...] per scene -> [S, ...]."""
    return torch.gather(x, 1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


def _window_sources(order, g_sorted, starts, rows: int, caps: SceneCaps) -> torch.Tensor:
    """[S * T * rows] row of the scenes' flattened Gaussian arrays ([S * N])
    in each tile's window: pair starts[s, t] + r of scene s, clipped at the
    scene's own last pair slot (as its single binning clips)."""
    s_n, n = order.shape
    r = torch.arange(rows, dtype=torch.int64, device=starts.device)
    hi = (caps.max_pairs - 1)[:, None, None]
    win = torch.minimum(torch.clamp(starts[..., None] + r, min=0), hi)  # [S, T, rows]
    src = _take_rows(order, _take_rows(g_sorted, win))
    base = torch.arange(s_n, dtype=torch.int64, device=order.device)[:, None, None] * n
    return (src + base).reshape(-1)


def bin_gaussians(
    proj: ProjectedGaussians, width: int, height: int, config: TileConfig,
    opacities: Optional[torch.Tensor] = None,
):
    """Per-tile gather-window view of bin_pairs (port of the JAX
    bin_gaussians, index for index).

    Returns:
      order: [N] depth-sort permutation
      tile_gather: [n_tiles, max_per_tile] indices into depth-sorted arrays
      tile_mask: [n_tiles, max_per_tile] bool validity
      dropped, (n_tx, n_ty)
    """
    order, g_sorted, _, starts, tile_cnt, dropped, dims = bin_pairs(
        proj, width, height, config, opacities=opacities
    )
    with torch.no_grad():
        tile_gather = _tile_gather(starts, g_sorted, config.max_per_tile, config.max_pairs)
        m_idx = torch.arange(config.max_per_tile, device=tile_cnt.device)
        tile_mask = m_idx[None, :] < tile_cnt[:, None]
    return order, tile_gather, tile_mask, dropped, dims


class WindowLayout(NamedTuple):
    """Inputs of the chunked windowed compositor for one render (or, with
    a scene axis, S renders: T = S x the grid's tiles, scene-major)."""

    counts: torch.Tensor  # [T] int32 pairs per tile (clamped to max_per_tile)
    data: torch.Tensor  # [T, M', 7+D] float32 (differentiable), M' % 128 == 0
    dropped: torch.Tensor  # pairs lost: a scalar, or [S] with a scene axis
    n_tx: int
    n_ty: int
    tile_size: int
    map_batch: int


def _flat_rows(proj, colors, opacities, ch: int) -> torch.Tensor:
    """The scenes' packed pair rows, zero-padded to ch fields, [S * N, ch]."""
    rows = _packed_rows(proj, colors, opacities)
    if ch > rows.shape[-1]:
        rows = torch.nn.functional.pad(rows, (0, ch - rows.shape[-1]))
    return rows.reshape(-1, ch)


@spanned("layout")
def window_layout_scenes(proj: ProjectedGaussians, colors: torch.Tensor,
                         opacities: torch.Tensor, caps: SceneCaps) -> WindowLayout:
    """window_layout for S scenes in one layout: proj fields [S, N, ...],
    colors [S, N, D], opacities [S, N]. Tiles scene-major, each scene's
    window rows and counts those of its own binning; the window is
    widened to the largest scene's (rows past a count are masked in the
    kernel). `dropped` is per scene."""
    order, g_sorted, _, starts, tile_cnt, dropped, (n_tx, n_ty) = bin_scenes(
        proj, caps, opacities)
    m_pad = -(-caps.config.max_per_tile // CHUNK) * CHUNK
    with torch.no_grad():
        src = _window_sources(order, g_sorted, starts, m_pad, caps)
    ch = 7 + colors.shape[-1]
    data = _flat_rows(proj, colors, opacities, ch)[src].reshape(-1, m_pad, ch)
    return WindowLayout(tile_cnt.reshape(-1).to(torch.int32), data, dropped, n_tx, n_ty,
                        caps.config.tile_size, caps.config.map_batch)


def window_layout(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    width: int,
    height: int,
    config: Optional[TileConfig] = None,
) -> WindowLayout:
    """The per-tile gather window of the tiled backend: counts = tile_cnt
    and data = packed[order][tile_gather], with the window widened from
    max_per_tile to M', the next multiple of 128 (the chunked kernel's
    unit). Rows at or past a tile's count are masked inside the kernel, so
    the widening changes nothing. The gather runs in torch, so its
    backward (index_add back to the Gaussians) is autograd's. The one-scene
    case of window_layout_scenes."""
    caps = scene_caps([config], [(width, height)], proj.means2d.device, proj.depths.shape[0])
    lay = window_layout_scenes(_lead(proj), colors[None], opacities[None], caps)
    return lay._replace(dropped=lay.dropped[0])


def composite_tiled(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    bg: torch.Tensor,
    width: int,
    height: int,
    config: Optional[TileConfig] = None,
) -> RenderOutput:
    """Tiled front-to-back compositing (the JAX composite_tiled's semantics):
    the gather window of every tile composited by the chunked windowed
    kernel pair. Every tile is written (an empty one is bg)."""
    caps = scene_caps([config], [(width, height)], proj.means2d.device, proj.depths.shape[0])
    out = composite_scenes(_lead(proj), colors[None], opacities[None], bg[None], caps, "tiled")
    return _first_scene(out)


def _untile(x: torch.Tensor, n_tx: int, n_ty: int, ts: int, width: int, height: int):
    """[n_tiles, P, C] -> [C, H, W], cropping tile padding; with a leading
    scene axis ([S * n_tiles, P, C]) -> [S, C, H, W]."""
    c = x.shape[-1]
    s_n = x.shape[0] // (n_tx * n_ty)
    x = x.reshape(s_n, n_ty, n_tx, ts, ts, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(s_n, n_ty * ts, n_tx * ts, c)
    x = x[:, :height, :width].permute(0, 3, 1, 2)
    return x[0] if s_n == 1 else x


class TilegridLayout(NamedTuple):
    """Inputs of the tile-grid compositor for one render (or S renders:
    tiles and slots scene-major)."""

    meta: torch.Tensor  # [3, T] int32
    vals: torch.Tensor  # [n_slots, ch16, 128] float32 (differentiable)
    empty: torch.Tensor  # [T] bool: tile owns no chunk (empty or overflowed)
    dropped: torch.Tensor  # pairs lost to binning / slot capacity (a scalar, or [S])
    n_tx: int
    n_ty: int
    tile_size: int


class StreamLayout(NamedTuple):
    """Inputs of the stream compositor for one render."""

    meta: torch.Tensor  # [4, n_slots] int32
    vals: torch.Tensor  # [n_slots*128, 7+D] float32 (differentiable)
    empty: torch.Tensor  # [T] bool: tile owns no chunk (empty or overflowed)
    dropped: torch.Tensor
    n_tx: int
    n_ty: int
    tile_size: int


class _PaddedRuns(NamedTuple):
    """Per-tile runs padded to whole chunks, shared by both layouts; every
    field has a leading scene axis."""

    caps: SceneCaps
    order: torch.Tensor  # [S, N]
    g_sorted: torch.Tensor  # [S, MP]
    starts: torch.Tensor  # [S, T] first pair of each tile in the sorted pair array
    tile_cnt: torch.Tensor
    padded_cnt: torch.Tensor
    starts2: torch.Tensor  # first slot of each tile in its scene's padded layout
    overflowed: torch.Tensor  # the tile's padded run does not fit the scene's slots
    dropped: torch.Tensor  # [S]
    sc: int  # slot capacity of each scene's part of the layout (a multiple of CHUNK)
    n_tx: int
    n_ty: int


def _padded_runs(proj, opacities, caps: SceneCaps) -> _PaddedRuns:
    order, g_sorted, _, starts, tile_cnt, dropped, (n_tx, n_ty) = bin_scenes(
        proj, caps, opacities)
    sc = caps.config.max_slots
    with torch.no_grad():
        padded_cnt = ((tile_cnt + CHUNK - 1) // CHUNK) * CHUNK
        starts2 = torch.cumsum(padded_cnt, -1) - padded_cnt  # padded starts
        # a tile whose padded run does not fit the scene's slot capacity is
        # never laid out: it renders as empty and its pairs count as dropped
        overflowed = starts2 + padded_cnt > caps.max_slots[:, None]
        dropped = dropped + torch.sum(
            torch.where(overflowed, tile_cnt, torch.zeros_like(tile_cnt)), dim=-1)
    return _PaddedRuns(caps, order, g_sorted, starts, tile_cnt, padded_cnt, starts2,
                       overflowed, dropped, sc, n_tx, n_ty)


def slot_owner(starts2: torch.Tensor, n_slots: int) -> torch.Tensor:
    """[n_slots] tile that owns each slot of the padded layout: the last
    tile t with starts2[t] <= q (searchsorted(starts2, q, right=True) - 1;
    starts2[0] = 0). Empty tiles share their padded start with the next
    tile and so own nothing inside a run; slots past the last run belong to
    the last tile id; a tile whose run overflows the capacity still owns
    the slots up to it. The JAX package's scatter at the padded starts and
    running max give the same owner. Leading axes ([S, T]) are scenes."""
    q = torch.arange(n_slots, dtype=starts2.dtype, device=starts2.device)
    q = q.expand(starts2.shape[:-1] + (n_slots,)).contiguous()
    return torch.searchsorted(starts2.contiguous(), q, right=True) - 1


def _slot_sources(runs: _PaddedRuns, owner: torch.Tensor) -> torch.Tensor:
    """[S * sc] row of the scenes' flattened Gaussian arrays of the pair in
    each slot: slot q of tile t = owner[s, q] holds pair starts[s, t] + (q -
    starts2[s, t]) of scene s, clipped at the scene's last pair slot."""
    q = torch.arange(runs.sc, dtype=torch.int64, device=owner.device)
    p_q = _take_rows(runs.starts, owner) + (q - _take_rows(runs.starts2, owner))
    p_q = torch.minimum(torch.clamp(p_q, min=0), (runs.caps.max_pairs - 1)[:, None])
    src = _take_rows(runs.order, _take_rows(runs.g_sorted, p_q))
    s_n, n = runs.order.shape
    return (src + torch.arange(s_n, device=src.device)[:, None] * n).reshape(-1)


def _packed_rows(proj, colors, opacities) -> torch.Tensor:
    """[..., N, 7+D] pair fields mu_x | mu_y | a | b | c | op | col x D | z."""
    return torch.cat(
        [proj.means2d, proj.conics, opacities[..., None], colors, proj.depths[..., None]],
        dim=-1)


@spanned("layout")
def tilegrid_layout_scenes(proj: ProjectedGaussians, colors: torch.Tensor,
                           opacities: torch.Tensor, caps: SceneCaps) -> TilegridLayout:
    """tilegrid_layout for S scenes in one layout (proj fields [S, N, ...],
    colors [S, N, D], opacities [S, N]): scene s's tiles are tiles [s T,
    (s + 1) T) and its chunk slots [s sc, (s + 1) sc) of the shared slot
    capacity sc; each scene's runs, overflows and drops are those of its
    own binning. meta row 2 holds, per tile, the end of its scene's
    fitting slots (slots past it belong to no tile)."""
    from egogaussian_tpu_torch.render.cuda_raster import ch16_of

    runs = _padded_runs(proj, opacities, caps)
    s_n = runs.tile_cnt.shape[0]
    n_tiles = runs.n_tx * runs.n_ty
    with torch.no_grad():
        zero = torch.zeros_like(runs.tile_cnt)
        fit_slots = torch.sum(torch.where(runs.overflowed, zero, runs.padded_cnt), dim=-1,
                              keepdim=True) // CHUNK
        base = torch.arange(s_n, dtype=torch.int64, device=zero.device)[:, None] * (
            runs.sc // CHUNK)
        meta = torch.stack([
            torch.where(runs.overflowed, base, base + runs.starts2 // CHUNK),
            torch.where(runs.overflowed, zero, runs.tile_cnt),
            (base + fit_slots).expand(s_n, n_tiles),
        ]).reshape(3, -1).to(torch.int32).contiguous()
        src = _slot_sources(runs, slot_owner(runs.starts2, runs.sc))

    ch16 = ch16_of(colors.shape[-1])
    rows = _flat_rows(proj, colors, opacities, ch16)[src]
    vals = rows.reshape(-1, CHUNK, ch16).transpose(1, 2).contiguous()
    empty = ((runs.tile_cnt == 0) | runs.overflowed).reshape(-1)
    return TilegridLayout(meta, vals, empty, runs.dropped, runs.n_tx, runs.n_ty,
                          caps.config.tile_size)


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
    is autograd's. The one-scene case of tilegrid_layout_scenes."""
    caps = scene_caps([config], [(width, height)], proj.means2d.device, proj.depths.shape[0])
    lay = tilegrid_layout_scenes(_lead(proj), colors[None], opacities[None], caps)
    return lay._replace(dropped=lay.dropped[0])


@spanned("layout")
def stream_layout_scenes(proj: ProjectedGaussians, colors: torch.Tensor,
                         opacities: torch.Tensor, caps: SceneCaps) -> StreamLayout:
    """The stream flavor's layout for S scenes in one layout (proj fields
    [S, N, ...], colors [S, N, D], opacities [S, N]; port of the stream
    branch of the JAX `composite_pallas`, vmapped): the same padded runs,
    pairs row-major with no padding rows, and a per-slot meta of four
    rows:
      0 owning tile, 1 rank of the chunk's first pair within its tile,
      2 the tile's pair count, 3 the last occupied slot of its scene.
    Scene s's tiles are tiles [s T, (s + 1) T) and its chunk slots [s n, (s
    + 1) n) of the shared slot capacity n, so row 0 stays nondecreasing
    over the scenes. Slots past a scene's last run belong to its last tile
    with rank >= count (pure padding); each scene's runs, overflows and
    drops are those of its own binning."""
    runs = _padded_runs(proj, opacities, caps)
    s_n = runs.tile_cnt.shape[0]
    n_tiles = runs.n_tx * runs.n_ty
    n_slots = runs.sc // CHUNK
    dev = runs.tile_cnt.device
    with torch.no_grad():
        owner = slot_owner(runs.starts2, runs.sc)
        src = _slot_sources(runs, owner)
        q0 = torch.arange(0, runs.sc, CHUNK, dtype=torch.int64, device=dev)
        t_chunk = owner[:, ::CHUNK]
        rank_off = q0 - _take_rows(runs.starts2, t_chunk)
        last_used = torch.minimum(
            torch.clamp(torch.sum(runs.padded_cnt, dim=-1) // CHUNK - 1, min=0),
            runs.caps.max_slots // CHUNK - 1)
        scene = torch.arange(s_n, dtype=torch.int64, device=dev)[:, None]
        meta = torch.stack([
            t_chunk + scene * n_tiles, rank_off, _take_rows(runs.tile_cnt, t_chunk),
            (last_used[:, None] + scene * n_slots).expand(s_n, n_slots),
        ]).reshape(4, -1).to(torch.int32).contiguous()
    vals = _flat_rows(proj, colors, opacities, 7 + colors.shape[-1])[src]
    empty = ((runs.tile_cnt == 0) | runs.overflowed).reshape(-1)
    return StreamLayout(meta, vals, empty, runs.dropped, runs.n_tx, runs.n_ty,
                        caps.config.tile_size)


def stream_layout(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    width: int,
    height: int,
    config: Optional[TileConfig] = None,
) -> StreamLayout:
    """The stream flavor's layout of one render: the one-scene case of
    stream_layout_scenes (meta row 3 the last occupied slot)."""
    caps = scene_caps([config], [(width, height)], proj.means2d.device, proj.depths.shape[0])
    lay = stream_layout_scenes(_lead(proj), colors[None], opacities[None], caps)
    return lay._replace(dropped=lay.dropped[0])


def _pixel_mask(caps: SceneCaps, n_tx: int, n_ty: int, device) -> Optional[torch.Tensor]:
    """[S, 1, H, W] True on each scene's own pixels of the shared grid, or
    None when every scene fills it."""
    ts = caps.config.tile_size
    w_max = max(w for w, _ in caps.sizes)
    h_max = max(h for _, h in caps.sizes)
    if all((w, h) == (w_max, h_max) for w, h in caps.sizes):
        return None
    w = torch.tensor([w for w, _ in caps.sizes], device=device)[:, None, None, None]
    h = torch.tensor([h for _, h in caps.sizes], device=device)[:, None, None, None]
    xs = torch.arange(w_max, device=device)[None, None, None, :]
    ys = torch.arange(h_max, device=device)[None, None, :, None]
    return (xs < w) & (ys < h)


def composite_scenes(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    bg: torch.Tensor,
    caps: SceneCaps,
    backend: str = "cuda",
) -> RenderOutput:
    """S renders in one compositor launch pair: proj fields [S, N, ...],
    colors [S, N, D], opacities [S, N], bg [S, D]. backend "cuda" takes the
    pair config.compositor names (the tile-grid pair over
    tilegrid_layout_scenes, the stream pair over stream_layout_scenes),
    "tiled" the chunked windowed pair over window_layout_scenes. Returns
    image [S, D, H, W], alpha and depth [S, 1, H, W] at the largest scene
    size (a smaller scene's pixels past its own size are bg / 0) and
    dropped_pairs [S]."""
    if backend == "tiled":
        lay = window_layout_scenes(proj, colors, opacities, caps)
    elif backend == "cuda":
        if caps.config.compositor == "stream":
            lay = stream_layout_scenes(proj, colors, opacities, caps)
        else:
            lay = tilegrid_layout_scenes(proj, colors, opacities, caps)
    else:
        raise ValueError(f"no scene-axis compositor for backend {backend!r}")
    image, alpha, depth = _composite(lay, bg, caps)
    return RenderOutput(image=image, alpha=alpha, depth=depth, radii=proj.radii,
                        dropped_pairs=lay.dropped)


@spanned("composite")
def _composite(lay, bg: torch.Tensor, caps: SceneCaps):
    """(image, alpha, depth) of composite_scenes: the kernel pair of the
    layout's kind over it, then the tiles put back into frames."""
    if isinstance(lay, WindowLayout):
        from egogaussian_tpu_torch.render.window_raster import WindowChunkedCompositor

        img_t, alpha_t, depth_t = WindowChunkedCompositor.apply(
            lay.counts, lay.data, bg.contiguous(), lay.tile_size, lay.n_tx, lay.map_batch)
    else:
        from egogaussian_tpu_torch.render.cuda_raster import TileGridCompositor, tile_bg

        if isinstance(lay, StreamLayout):
            from egogaussian_tpu_torch.render.stream_raster import StreamCompositor

            img_t, alpha_t, depth_t = StreamCompositor.apply(
                lay.meta, lay.vals, bg.contiguous(), lay.tile_size, lay.n_tx,
                lay.empty.shape[0])
        else:
            img_t, alpha_t, depth_t = TileGridCompositor.apply(
                lay.meta, lay.vals, bg.contiguous(), lay.tile_size, lay.n_tx,
                caps.config.bwd_exact_total)
        # tiles owning no chunk (empty or overflowed) are background / zero
        # (the stream kernel never writes them); the mask also cuts the
        # gradient of the overflowed tiles' chunks
        empty = lay.empty[:, None, None]
        img_t = torch.where(empty, tile_bg(bg, empty.shape[0]).to(img_t.dtype), img_t)
        alpha_t = torch.where(empty, torch.zeros_like(alpha_t), alpha_t)
        depth_t = torch.where(empty, torch.zeros_like(depth_t), depth_t)
    ts, n_tx, n_ty = lay.tile_size, lay.n_tx, lay.n_ty
    w_max = max(w for w, _ in caps.sizes)
    h_max = max(h for _, h in caps.sizes)
    s_n = bg.shape[0]

    def untile(x):
        return _untile(x, n_tx, n_ty, ts, w_max, h_max).reshape(s_n, x.shape[-1], h_max, w_max)

    image, alpha, depth = untile(img_t), untile(alpha_t), untile(depth_t)
    own = _pixel_mask(caps, n_tx, n_ty, bg.device)
    if own is not None:
        image = torch.where(own, image, bg[:, :, None, None].to(image.dtype))
        alpha = torch.where(own, alpha, torch.zeros_like(alpha))
        depth = torch.where(own, depth, torch.zeros_like(depth))
    return image, alpha, depth


def _first_scene(out: RenderOutput) -> RenderOutput:
    return RenderOutput(image=out.image[0], alpha=out.alpha[0], depth=out.depth[0],
                        radii=out.radii[0], dropped_pairs=out.dropped_pairs[0])


def composite_cuda(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    bg: torch.Tensor,
    width: int,
    height: int,
    config: Optional[TileConfig] = None,
) -> RenderOutput:
    """Same semantics as the oracle, composited by the kernel pair that
    config.compositor names over its chunk-padded layout (the JAX
    composite_pallas)."""
    config = config or TileConfig()
    caps = scene_caps([config], [(width, height)], proj.means2d.device, proj.depths.shape[0])
    out = composite_scenes(_lead(proj), colors[None], opacities[None], bg[None], caps, "cuda")
    return _first_scene(out)
