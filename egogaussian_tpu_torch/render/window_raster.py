"""The windowed compositors: CUDA kernels, plain PyTorch twins, autograd.

Port of the windowed half of `egogaussian_tpu/render/pallas_raster.py`.
Both pairs composite each tile over its own [M]-row gather window of
depth-sorted pairs (the window `render/tiled.py:bin_gaussians` builds),
with log-space transmittance and no saturation skip:

  chunked (`make_tile_compositor_chunked`, `_fwd_kernel_chunked`,
  `_bwd_kernel_chunked`): the tiled backend's compositor
  (`render/tiled.py:composite_tiled`).
    counts [T] int32, data [T, M, 7+D] float32 (M % 128 == 0; rows
    mu_x | mu_y | a | b | c | op | col x D | z), bg [S, D]
    -> img [T, P, D], alpha [T, P, 1], depth [T, P, 1] and the final
       log-transmittance logT [T, 1, P] saved for the backward.
    The T tiles are S scenes' grids, scene-major, as in the tile-grid
    pair (render/cuda_raster.py): one launch for every scene, each tile
    computed as in a one-scene launch.
    Only the first ceil(count/128) chunks of a tile's window are read;
    rows at or past the count are masked (op = 0). Every tile is written
    (an empty one is bg). The backward is one reverse sweep from logT and
    writes every row: zeros past the count.
  simple (`make_tile_compositor`, `_fwd_kernel`, `_bwd_kernel`):
    mu [T, M, 2], con [T, M, 3], op [T, M, 1] (0 on masked rows),
    col [T, M, D], z [T, M, 1], bg [1, D] -> img, alpha, depth.
    Walks all M rows. The backward recomputes the forward and takes the
    weighted suffix as total - inclusive prefix; it applies no clamp mask
    on `power` (the TPU kernel's `jnp.where(power < 0, dpower, dpower)`
    is a no-op), so the gradient where power is clamped at 0 is the
    kernel's, not autodiff's 1/2 : 1/2 split.
bg gets a zero gradient in both, as in the JAX VJPs.

The kernels are CUDA C++ for sm_90a in `egogaussian_tpu_torch/csrc/
window_chunked_{fwd,bwd}.cu` and `window_{fwd,bwd}.cu` (+ `window_split.cuh`),
built into the library of `render/cuda_raster.py`. Both pairs run a 16x16
quadrant per 256-thread CTA (ts 32: four per tile, the backwards as one
cluster) with a per-warp reach-box cull; the simple pair also skips every
128-row chunk whose op column is all 0, and stages chunks by bulk copy
when M % 4 == 0 (plain loads otherwise). `window_chunked_{forward,backward}
_nocull` and `window_{forward,backward}_nocull` launch the same kernels
with the cull compiled out, as check instances that must agree bit for
bit.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor takes
the plain twin, which walks `map_batch` tiles at a time to bound its
memory. There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from egogaussian_tpu_torch.render.cuda_raster import (
    ALPHA_EPS,
    ALPHA_MAX,
    CHUNK,
    SUPPORTED_D,
    SUPPORTED_TS,
    _chunk_alphas,
    _launch_check,
    _pixel_coords,
    kernel_library,
    tile_bg,
)

MAP_BATCH = 64  # tiles per batch of the CPU twins (TileConfig.map_batch)


def _check_common(bg, ts, tensors, n_tiles=None):
    """Shared checks: tile size, bg, and each (tensor, shape) pair; all on
    one device and contiguous. bg is [1, D], or [S, D] with S dividing
    `n_tiles` where the pair has a scene axis. Returns d."""
    if ts not in SUPPORTED_TS:
        raise ValueError(f"tile size {ts} not in {SUPPORTED_TS}")
    scenes_ok = bg.dim() == 2 and (bg.shape[0] == 1 or (
        n_tiles is not None and bg.shape[0] >= 1 and n_tiles % bg.shape[0] == 0))
    if bg.dtype != torch.float32 or not scenes_ok:
        want = "[1, D]" if n_tiles is None else f"[S, D], S dividing {n_tiles} tiles"
        raise ValueError(f"bg must be float32 {want}, got {bg.dtype} {tuple(bg.shape)}")
    d = bg.shape[1]
    if d not in SUPPORTED_D:
        raise ValueError(f"channel count {d} not in {SUPPORTED_D}")
    for x, shape in tensors:
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"expected float32 {shape}, got {x.dtype} {tuple(x.shape)}")
    for x in (bg, *(x for x, _ in tensors)):
        if x.device != bg.device:
            raise ValueError("all compositor inputs must be on one device")
        if not x.is_contiguous():
            raise ValueError("compositor inputs must be contiguous")
    return d


def _check_chunked(counts, data, bg, ts, tensors=()):
    """Validate what the chunked kernels take; returns (n_tiles, m, d)."""
    if counts.dtype != torch.int32 or counts.dim() != 1:
        raise ValueError(f"counts must be int32 [T], got {counts.dtype} {tuple(counts.shape)}")
    if data.dim() != 3:
        raise ValueError(f"data must be [T, M, 7+D], got {tuple(data.shape)}")
    n_tiles, m = counts.shape[0], data.shape[1]
    if m % CHUNK:
        raise ValueError(f"window rows {m} must be a multiple of {CHUNK}")
    d = _check_common(bg, ts, [(data, (n_tiles, m, 7 + bg.shape[1])), *tensors], n_tiles)
    if counts.device != data.device or not counts.is_contiguous():
        raise ValueError("counts must be contiguous and on the data's device")
    if data.device.type == "cuda" and data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned (chunks load by bulk copy)")
    return n_tiles, m, d


def _check_simple(mu, con, op, col, z, bg, ts, tensors=()):
    """Validate what the simple kernels take; returns (n_tiles, m, d)."""
    if mu.dim() != 3:
        raise ValueError(f"mu must be [T, M, 2], got {tuple(mu.shape)}")
    n_tiles, m = mu.shape[0], mu.shape[1]
    d = bg.shape[1] if bg.dim() == 2 else -1
    shapes = [(mu, (n_tiles, m, 2)), (con, (n_tiles, m, 3)), (op, (n_tiles, m, 1)),
              (col, (n_tiles, m, d)), (z, (n_tiles, m, 1))]
    return n_tiles, m, _check_common(bg, ts, shapes + list(tensors))


def _out_shapes(n_tiles, p, d):
    return [(n_tiles, p, d), (n_tiles, p, 1), (n_tiles, p, 1)]


# ---------------------------------------------------------------------------
# Plain PyTorch twins (CPU path; on the card, reference and timing only)
# ---------------------------------------------------------------------------

def _suffix_sum(x):
    """Inclusive suffix sum along the row axis (dim 2)."""
    return torch.flip(torch.cumsum(torch.flip(x, (2,)), dim=2), (2,))


def _pair_grads(blk, terms, lane_ok, t_excl, dld, s, w, gi, gz, d):
    """Per-row gradient sums over the batch's pixels -> [B, rows, 7+D]
    (dmu_x, dmu_y, da, db, dc, dop, dcol x D, dz) from the alpha terms of
    _chunk_alphas; dalpha gated to eps <= raw < 0.99, dop zero on masked
    rows."""
    alpha, raw, power, dx, dy = terms
    one_minus = torch.maximum(1.0 - alpha, alpha.new_tensor(1e-6))
    dalpha = t_excl * dld - s / one_minus
    gate = (raw >= ALPHA_EPS) & (raw < ALPHA_MAX)
    dalpha = torch.where(gate, dalpha, torch.zeros_like(dalpha))
    dpower = raw * dalpha
    a, b, cc = blk[:, None, 2], blk[:, None, 3], blk[:, None, 4]
    rows = [
        torch.sum((a * dx + b * dy) * dpower, dim=1),
        torch.sum((cc * dy + b * dx) * dpower, dim=1),
        torch.sum(-0.5 * dx * dx * dpower, dim=1),
        torch.sum(-dx * dy * dpower, dim=1),
        torch.sum(-0.5 * dy * dy * dpower, dim=1),
        torch.where(lane_ok, torch.sum(torch.exp(power) * dalpha, dim=1),
                    torch.zeros_like(lane_ok, dtype=blk.dtype)),
    ]
    dcol = torch.einsum("bpl,bpd->bdl", w, gi)
    rows += [dcol[:, j] for j in range(d)]
    rows.append(torch.sum(w * gz, dim=1))
    return torch.stack(rows, dim=2)


def _dl_dw(blk, gi, ga, gz, d):
    """dL/dw [B, P, rows] = col . gimg + z * gdepth + galpha."""
    return torch.einsum("bdl,bpd->bpl", blk[:, 6:6 + d], gi) + blk[:, None, 6 + d] * gz + ga


def _batches(n_tiles, map_batch):
    step = max(1, int(map_batch))
    return [slice(b, min(b + step, n_tiles)) for b in range(0, n_tiles, step)]


def composite_window_chunked_plain_fwd(counts, data, bg, ts: int, n_tx: int,
                                       map_batch: int = MAP_BATCH):
    """The chunked forward kernel's algorithm in plain torch, `map_batch`
    tiles at a time with a Python loop over 128-row chunks: rows at or
    past the tile's count get op = 0, incl = (in-chunk prefix of
    log1p(-alpha)) + carried logT, w = alpha * exp(incl - log1m). A chunk
    past a tile's last one is all masked rows and changes nothing."""
    n_tiles, m, _ = data.shape
    d, p, dev = bg.shape[1], ts * ts, data.device
    px_all, py_all = _pixel_coords(n_tiles, ts, n_tx, dev, bg.shape[0])
    bg_all = tile_bg(bg, n_tiles)
    cnt_all = torch.clamp(counts.to(torch.int64), 0, m)
    lane = torch.arange(CHUNK, device=dev)
    img = torch.empty((n_tiles, p, d), device=dev)
    alpha_o = torch.empty((n_tiles, p, 1), device=dev)
    depth_o = torch.empty((n_tiles, p, 1), device=dev)
    logt_o = torch.empty((n_tiles, 1, p), device=dev)
    for sl in _batches(n_tiles, map_batch):
        cnt, px, py = cnt_all[sl], px_all[sl], py_all[sl]
        bsz = cnt.shape[0]
        log_t = torch.zeros((bsz, p, 1), device=dev)
        acc_img = torch.zeros((bsz, p, d), device=dev)
        acc_a = torch.zeros((bsz, p, 1), device=dev)
        acc_d = torch.zeros((bsz, p, 1), device=dev)
        for k in range(-(-int(cnt.max()) // CHUNK)):
            blk = data[sl, k * CHUNK:(k + 1) * CHUNK].transpose(1, 2)  # [B, 7+D, 128]
            lane_ok = (lane[None] + k * CHUNK) < cnt[:, None]
            alpha, _, _, _, _ = _chunk_alphas(blk, px, py, lane_ok)
            log1m = torch.log1p(-alpha)
            incl = torch.cumsum(log1m, dim=2) + log_t
            w = alpha * torch.exp(incl - log1m)  # [B, P, 128]
            acc_img = acc_img + torch.einsum("bpl,bdl->bpd", w, blk[:, 6:6 + d])
            acc_a = acc_a + torch.sum(w, dim=2, keepdim=True)
            acc_d = acc_d + torch.sum(w * blk[:, None, 6 + d], dim=2, keepdim=True)
            log_t = incl[..., -1:]
        img[sl] = acc_img + torch.exp(log_t) * bg_all[sl]
        alpha_o[sl] = acc_a
        depth_o[sl] = acc_d
        logt_o[sl] = log_t.transpose(1, 2)
    return img, alpha_o, depth_o, logt_o


def composite_window_chunked_plain_bwd(counts, data, bg, logt, gimg, galpha, gdepth,
                                       ts: int, n_tx: int, map_batch: int = MAP_BATCH):
    """The chunked backward kernel's algorithm in plain torch: a reverse
    sweep over each tile's chunks from the saved logT, U = in-chunk suffix
    of log1m + carry, T_excl = exp(logT - U), S = (suffix of wd - wd) +
    carry + T_final * (gimg . bg). Rows at or past the count, and every
    row past the tile's last chunk, are zeros."""
    n_tiles, m, ch = data.shape
    d, dev = bg.shape[1], data.device
    px_all, py_all = _pixel_coords(n_tiles, ts, n_tx, dev, bg.shape[0])
    bg_all = tile_bg(bg, n_tiles)
    cnt_all = torch.clamp(counts.to(torch.int64), 0, m)
    lane = torch.arange(CHUNK, device=dev)
    ddata = torch.zeros_like(data)
    for sl in _batches(n_tiles, map_batch):
        cnt, px, py = cnt_all[sl], px_all[sl], py_all[sl]
        log_total = logt[sl].transpose(1, 2)  # [B, P, 1]
        gi, ga, gz = gimg[sl], galpha[sl], gdepth[sl]
        base_s = torch.exp(log_total) * torch.sum(gi * bg_all[sl], dim=-1, keepdim=True)
        suf_log = torch.zeros_like(log_total)
        suf_s = torch.zeros_like(log_total)
        for k in reversed(range(-(-int(cnt.max()) // CHUNK))):
            blk = data[sl, k * CHUNK:(k + 1) * CHUNK].transpose(1, 2)
            lane_ok = (lane[None] + k * CHUNK) < cnt[:, None]
            terms = _chunk_alphas(blk, px, py, lane_ok)
            alpha = terms[0]
            log1m = torch.log1p(-alpha)
            t_excl = torch.exp(log_total - (_suffix_sum(log1m) + suf_log))
            w = alpha * t_excl
            dld = _dl_dw(blk, gi, ga, gz, d)
            wd = w * dld
            s = ((_suffix_sum(wd) - wd) + suf_s) + base_s
            ddata[sl, k * CHUNK:(k + 1) * CHUNK] = _pair_grads(
                blk, terms, lane_ok, t_excl, dld, s, w, gi, gz, d)
            suf_log = suf_log + torch.sum(log1m, dim=2, keepdim=True)
            suf_s = suf_s + torch.sum(wd, dim=2, keepdim=True)
    return ddata


def _simple_rows(mu, con, op, col, z):
    """[T, M, 7+D] rows mu_x | mu_y | a | b | c | op | col x D | z."""
    return torch.cat([mu, con, op, col, z], dim=2)


def composite_window_plain_fwd(mu, con, op, col, z, bg, ts: int, n_tx: int,
                               map_batch: int = MAP_BATCH):
    """The simple forward kernel's algorithm in plain torch: every row of
    the window, incl = cumsum of log1p(-alpha) over rows, w = alpha *
    exp(incl - log1m), img + exp(incl_last) * bg."""
    rows = _simple_rows(mu, con, op, col, z)
    n_tiles, m, _ = rows.shape
    d, p, dev = bg.shape[1], ts * ts, rows.device
    px_all, py_all = _pixel_coords(n_tiles, ts, n_tx, dev)
    img = torch.empty((n_tiles, p, d), device=dev)
    alpha_o = torch.empty((n_tiles, p, 1), device=dev)
    depth_o = torch.empty((n_tiles, p, 1), device=dev)
    for sl in _batches(n_tiles, map_batch):
        blk = rows[sl].transpose(1, 2)  # [B, 7+D, M]
        lane_ok = torch.ones((blk.shape[0], m), dtype=torch.bool, device=dev)
        alpha, _, _, _, _ = _chunk_alphas(blk, px_all[sl], py_all[sl], lane_ok)
        log1m = torch.log1p(-alpha)
        incl = torch.cumsum(log1m, dim=2)
        w = alpha * torch.exp(incl - log1m)
        t_final = torch.exp(incl[..., -1:]) if m else torch.ones_like(alpha_o[sl])
        img[sl] = torch.einsum("bpl,bdl->bpd", w, blk[:, 6:6 + d]) + t_final * bg[0]
        alpha_o[sl] = torch.sum(w, dim=2, keepdim=True)
        depth_o[sl] = torch.sum(w * blk[:, None, 6 + d], dim=2, keepdim=True)
    return img, alpha_o, depth_o


def composite_window_plain_bwd(mu, con, op, col, z, bg, gimg, galpha, gdepth,
                               ts: int, n_tx: int, map_batch: int = MAP_BATCH):
    """The simple backward kernel's algorithm in plain torch: recompute the
    forward, then S = (total_wd - inclusive prefix of wd) + T_final *
    (gimg . bg), with the same gates. Returns (dmu, dcon, dop, dcol, dz)."""
    rows = _simple_rows(mu, con, op, col, z)
    n_tiles, m, _ = rows.shape
    d, dev = bg.shape[1], rows.device
    px_all, py_all = _pixel_coords(n_tiles, ts, n_tx, dev)
    grads = torch.zeros_like(rows)
    for sl in _batches(n_tiles, map_batch):
        if m == 0:
            break
        blk = rows[sl].transpose(1, 2)
        lane_ok = torch.ones((blk.shape[0], m), dtype=torch.bool, device=dev)
        px, py = px_all[sl], py_all[sl]
        gi, ga, gz = gimg[sl], galpha[sl], gdepth[sl]
        terms = _chunk_alphas(blk, px, py, lane_ok)
        alpha = terms[0]
        log1m = torch.log1p(-alpha)
        incl = torch.cumsum(log1m, dim=2)
        t_excl = torch.exp(incl - log1m)
        w = alpha * t_excl
        dld = _dl_dw(blk, gi, ga, gz, d)
        incl_wd = torch.cumsum(w * dld, dim=2)
        g_dot_bg = torch.sum(gi * bg[0], dim=-1, keepdim=True)
        s = (incl_wd[..., -1:] - incl_wd) + torch.exp(incl[..., -1:]) * g_dot_bg
        grads[sl] = _pair_grads(blk, terms, lane_ok, t_excl, dld, s, w, gi, gz, d)
    return torch.split(grads, [2, 3, 1, d, 1], dim=2)


# ---------------------------------------------------------------------------
# Wrappers: kernel on CUDA tensors, plain twin on CPU tensors
# ---------------------------------------------------------------------------

def _device_kind(x, what):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {x.device}")
    return x.device.type


def _launch_chunked_fwd(symbol, counts, data, bg, ts, n_tx, n_tiles, m, d):
    p = ts * ts
    outs = [torch.empty(s, dtype=torch.float32, device=data.device)
            for s in _out_shapes(n_tiles, p, d) + [(n_tiles, 1, p)]]
    stream = torch.cuda.current_stream(data.device).cuda_stream
    rc = getattr(kernel_library(), symbol)(
        counts.data_ptr(), data.data_ptr(), bg.data_ptr(), *(o.data_ptr() for o in outs),
        n_tiles, m, n_tx, n_tiles // bg.shape[0], ts, d, stream)
    _launch_check(rc, "windowed chunked forward")
    return tuple(outs)


def window_chunked_forward(counts, data, bg, ts: int, n_tx: int, map_batch: int = MAP_BATCH):
    """Chunked forward -> (img, alpha, depth, logT), every tile written.
    CUDA tensors launch the kernel; CPU tensors run
    composite_window_chunked_plain_fwd."""
    n_tiles, m, d = _check_chunked(counts, data, bg, ts)
    if _device_kind(data, "windowed compositor") == "cpu":
        return composite_window_chunked_plain_fwd(counts, data, bg, ts, n_tx, map_batch)
    outs = _launch_chunked_fwd("egogs_window_chunked_fwd", counts, data, bg, ts, n_tx,
                               n_tiles, m, d)
    WindowChunkedCompositor.fwd_launches[d] += 1
    return outs


def window_chunked_forward_nocull(counts, data, bg, ts: int, n_tx: int):
    """The chunked forward kernel instantiated with its per-warp cull
    compiled out (CUDA tensors only; not counted). A check instance: its
    outputs must equal window_chunked_forward's bit for bit."""
    n_tiles, m, d = _check_chunked(counts, data, bg, ts)
    if data.device.type != "cuda":
        raise ValueError("the cull-free check instance runs on CUDA tensors only")
    return _launch_chunked_fwd("egogs_window_chunked_fwd_nocull", counts, data, bg, ts, n_tx,
                               n_tiles, m, d)


def _check_chunked_bwd(counts, data, bg, logt, gimg, galpha, gdepth, ts):
    n_tiles, p, d = counts.shape[0], ts * ts, bg.shape[1]
    _, m, _ = _check_chunked(counts, data, bg, ts, tensors=[
        (logt, (n_tiles, 1, p)), (gimg, (n_tiles, p, d)), (galpha, (n_tiles, p, 1)),
        (gdepth, (n_tiles, p, 1))])
    return n_tiles, m, d


def _launch_chunked_bwd(symbol, counts, data, bg, logt, gimg, galpha, gdepth, ts, n_tx,
                        n_tiles, m, d):
    ddata = torch.empty_like(data)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    rc = getattr(kernel_library(), symbol)(
        *(x.data_ptr() for x in (counts, data, bg, logt, gimg, galpha, gdepth, ddata)),
        n_tiles, m, n_tx, n_tiles // bg.shape[0], ts, d, stream)
    _launch_check(rc, "windowed chunked backward")
    return ddata


def window_chunked_backward(counts, data, bg, logt, gimg, galpha, gdepth, ts: int, n_tx: int,
                            map_batch: int = MAP_BATCH):
    """Chunked backward -> ddata [T, M, 7+D], every row written (zeros at
    or past each tile's count). CUDA tensors launch the kernel; CPU
    tensors run composite_window_chunked_plain_bwd."""
    n_tiles, m, d = _check_chunked_bwd(counts, data, bg, logt, gimg, galpha, gdepth, ts)
    if _device_kind(data, "windowed compositor") == "cpu":
        return composite_window_chunked_plain_bwd(counts, data, bg, logt, gimg, galpha, gdepth,
                                                  ts, n_tx, map_batch)
    ddata = _launch_chunked_bwd("egogs_window_chunked_bwd", counts, data, bg, logt, gimg,
                                galpha, gdepth, ts, n_tx, n_tiles, m, d)
    WindowChunkedCompositor.bwd_launches[d] += 1
    return ddata


def window_chunked_backward_nocull(counts, data, bg, logt, gimg, galpha, gdepth, ts: int,
                                   n_tx: int):
    """The chunked backward kernel instantiated with its per-warp cull
    compiled out (CUDA tensors only; not counted). A check instance: its
    gradients must equal window_chunked_backward's bit for bit."""
    n_tiles, m, d = _check_chunked_bwd(counts, data, bg, logt, gimg, galpha, gdepth, ts)
    if data.device.type != "cuda":
        raise ValueError("the cull-free check instance runs on CUDA tensors only")
    return _launch_chunked_bwd("egogs_window_chunked_bwd_nocull", counts, data, bg, logt, gimg,
                               galpha, gdepth, ts, n_tx, n_tiles, m, d)


def _launch_fwd(symbol, mu, con, op, col, z, bg, ts, n_tx, n_tiles, m, d):
    outs = [torch.empty(s, dtype=torch.float32, device=mu.device)
            for s in _out_shapes(n_tiles, ts * ts, d)]
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    rc = getattr(kernel_library(), symbol)(
        *(x.data_ptr() for x in (mu, con, op, col, z, bg, *outs)), n_tiles, m, n_tx, ts, d,
        stream)
    _launch_check(rc, "windowed forward")
    return tuple(outs)


def window_forward(mu, con, op, col, z, bg, ts: int, n_tx: int, map_batch: int = MAP_BATCH):
    """Simple forward -> (img, alpha, depth). CUDA tensors launch the
    kernel; CPU tensors run composite_window_plain_fwd."""
    n_tiles, m, d = _check_simple(mu, con, op, col, z, bg, ts)
    if _device_kind(mu, "windowed compositor") == "cpu":
        return composite_window_plain_fwd(mu, con, op, col, z, bg, ts, n_tx, map_batch)
    outs = _launch_fwd("egogs_window_fwd", mu, con, op, col, z, bg, ts, n_tx, n_tiles, m, d)
    WindowCompositor.fwd_launches[d] += 1
    return outs


def window_forward_nocull(mu, con, op, col, z, bg, ts: int, n_tx: int):
    """The simple forward kernel instantiated with its per-warp cull
    compiled out (CUDA tensors only; not counted). A check instance: its
    outputs must equal window_forward's bit for bit."""
    n_tiles, m, d = _check_simple(mu, con, op, col, z, bg, ts)
    if mu.device.type != "cuda":
        raise ValueError("the cull-free check instance runs on CUDA tensors only")
    return _launch_fwd("egogs_window_fwd_nocull", mu, con, op, col, z, bg, ts, n_tx, n_tiles,
                       m, d)


def _check_simple_bwd(mu, con, op, col, z, bg, gimg, galpha, gdepth, ts):
    n_tiles, p, d = mu.shape[0], ts * ts, bg.shape[1]
    return _check_simple(mu, con, op, col, z, bg, ts, tensors=[
        (gimg, (n_tiles, p, d)), (galpha, (n_tiles, p, 1)), (gdepth, (n_tiles, p, 1))])


def _launch_bwd(symbol, mu, con, op, col, z, bg, gimg, galpha, gdepth, ts, n_tx, n_tiles, m,
                d):
    grads = [torch.empty_like(x) for x in (mu, con, op, col, z)]
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    rc = getattr(kernel_library(), symbol)(
        *(x.data_ptr() for x in (mu, con, op, col, z, bg, gimg, galpha, gdepth, *grads)),
        n_tiles, m, n_tx, ts, d, stream)
    _launch_check(rc, "windowed backward")
    return tuple(grads)


def window_backward(mu, con, op, col, z, bg, gimg, galpha, gdepth, ts: int, n_tx: int,
                    map_batch: int = MAP_BATCH):
    """Simple backward -> (dmu, dcon, dop, dcol, dz), every row written.
    CUDA tensors launch the kernel; CPU tensors run
    composite_window_plain_bwd."""
    n_tiles, m, d = _check_simple_bwd(mu, con, op, col, z, bg, gimg, galpha, gdepth, ts)
    if _device_kind(mu, "windowed compositor") == "cpu":
        return composite_window_plain_bwd(mu, con, op, col, z, bg, gimg, galpha, gdepth,
                                          ts, n_tx, map_batch)
    grads = _launch_bwd("egogs_window_bwd", mu, con, op, col, z, bg, gimg, galpha, gdepth, ts,
                        n_tx, n_tiles, m, d)
    WindowCompositor.bwd_launches[d] += 1
    return grads


def window_backward_nocull(mu, con, op, col, z, bg, gimg, galpha, gdepth, ts: int,
                           n_tx: int):
    """The simple backward kernel instantiated with its per-warp cull
    compiled out (CUDA tensors only; not counted). A check instance: its
    gradients must equal window_backward's bit for bit."""
    n_tiles, m, d = _check_simple_bwd(mu, con, op, col, z, bg, gimg, galpha, gdepth, ts)
    if mu.device.type != "cuda":
        raise ValueError("the cull-free check instance runs on CUDA tensors only")
    return _launch_bwd("egogs_window_bwd_nocull", mu, con, op, col, z, bg, gimg, galpha,
                       gdepth, ts, n_tx, n_tiles, m, d)


class WindowChunkedCompositor(torch.autograd.Function):
    """(counts, data, bg, ts, n_tx, map_batch) -> (img, alpha, depth) with
    the chunked backward kernel as its gradient; bg gets a zero gradient,
    as in the JAX VJP. fwd_launches / bwd_launches count kernel launches
    per channel count D; the CPU twin path does not count."""

    fwd_launches = {d: 0 for d in SUPPORTED_D}
    bwd_launches = {d: 0 for d in SUPPORTED_D}

    @staticmethod
    def reset_launch_counts():
        for d in SUPPORTED_D:
            WindowChunkedCompositor.fwd_launches[d] = 0
            WindowChunkedCompositor.bwd_launches[d] = 0

    @staticmethod
    def forward(ctx, counts, data, bg, ts, n_tx, map_batch=MAP_BATCH):
        img, alpha, depth, logt = window_chunked_forward(counts, data, bg, ts, n_tx, map_batch)
        ctx.save_for_backward(counts, data, bg, logt)
        ctx.ts, ctx.n_tx, ctx.map_batch = ts, n_tx, map_batch
        return img, alpha, depth

    @staticmethod
    def backward(ctx, gimg, galpha, gdepth):
        counts, data, bg, logt = ctx.saved_tensors
        ddata = window_chunked_backward(counts, data, bg, logt, gimg.contiguous(),
                                        galpha.contiguous(), gdepth.contiguous(), ctx.ts,
                                        ctx.n_tx, ctx.map_batch)
        return None, ddata, torch.zeros_like(bg), None, None, None


class WindowCompositor(torch.autograd.Function):
    """(mu, con, op, col, z, bg, ts, n_tx) -> (img, alpha, depth) with the
    simple backward kernel as its gradient; only the inputs are saved. bg
    gets a zero gradient, as in the JAX VJP. fwd_launches / bwd_launches
    count kernel launches per channel count D; the CPU twin path does not
    count."""

    fwd_launches = {d: 0 for d in SUPPORTED_D}
    bwd_launches = {d: 0 for d in SUPPORTED_D}

    @staticmethod
    def reset_launch_counts():
        for d in SUPPORTED_D:
            WindowCompositor.fwd_launches[d] = 0
            WindowCompositor.bwd_launches[d] = 0

    @staticmethod
    def forward(ctx, mu, con, op, col, z, bg, ts, n_tx):
        out = window_forward(mu, con, op, col, z, bg, ts, n_tx)
        ctx.save_for_backward(mu, con, op, col, z, bg)
        ctx.ts, ctx.n_tx = ts, n_tx
        return out

    @staticmethod
    def backward(ctx, gimg, galpha, gdepth):
        mu, con, op, col, z, bg = ctx.saved_tensors
        grads = window_backward(mu, con, op, col, z, bg, gimg.contiguous(), galpha.contiguous(),
                                gdepth.contiguous(), ctx.ts, ctx.n_tx)
        return (*grads, torch.zeros_like(bg), None, None)


def make_tile_compositor_chunked(n_tiles: int, m: int, d: int, ts: int, n_tx: int):
    """The chunked compositor for a (tiles, window rows, channels, tile
    size) configuration, as the JAX builder of the same name returns it:
    fn(counts [T] int32, data [T, M, 7+D], bg [1, D]) -> (img, alpha,
    depth), differentiable in data."""
    if m % CHUNK:
        raise ValueError(f"max_per_tile {m} must be a multiple of {CHUNK}")

    def compositor(counts, data, bg):
        if data.shape != (n_tiles, m, 7 + d):
            raise ValueError(f"data must be [{n_tiles}, {m}, {7 + d}], got {tuple(data.shape)}")
        return WindowChunkedCompositor.apply(counts, data, bg, ts, n_tx)

    return compositor


def make_tile_compositor(n_tiles: int, m: int, d: int, ts: int, n_tx: int):
    """The simple windowed compositor for a (tiles, window rows, channels,
    tile size) configuration, as the JAX builder of the same name returns
    it: fn(mu [T, M, 2], con [T, M, 3], op [T, M, 1], col [T, M, D],
    z [T, M, 1], bg [1, D]) -> (img, alpha, depth), differentiable in the
    five pair inputs."""

    def compositor(mu, con, op, col, z, bg):
        if mu.shape != (n_tiles, m, 2) or col.shape != (n_tiles, m, d):
            raise ValueError(f"window must be [{n_tiles}, {m}, *] with {d} channels")
        return WindowCompositor.apply(mu, con, op, col, z, bg, ts, n_tx)

    return compositor
