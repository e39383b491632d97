"""The stream compositor: CUDA kernel pair, plain PyTorch twins, autograd.

Port of `make_stream_compositor` in `egogaussian_tpu/render/pallas_raster.py`
(`_stream_fwd_kernel`, `_stream_bwd_kernel`), selected by
TileConfig.compositor="stream". The kernels are CUDA C++ for sm_90a in
`egogaussian_tpu_torch/csrc/stream_{fwd,bwd}.cu`, built into the same
library as the tile-grid pair (render/cuda_raster.py). They run the body of
the chunked windowed pair (`csrc/chunked_pair.cuh`) over a grid of tiles,
each finding its run of slots in meta row 0; `stream_{forward,backward}_nocull`
launch them with the per-warp cull compiled out (checks only).

Interface (the TPU kernels'):
  meta [4, n_slots] int32 per 128-pair chunk slot: owning tile, rank of the
    chunk's first pair within its tile, the tile's pair count, last
    occupied slot (broadcast). A tile's slots are contiguous; slots with
    rank >= count are pure padding.
  vals [n_slots*128, 7+D] float32, row-major pairs
    mu_x | mu_y | a | b | c | op | col x D | z
  bg [S, D] float32: S scenes of T / S tiles each, scene-major (a scene's
    tiles and slots follow the scene before it, render/tiled.py
    stream_layout_scenes); tile t composites over bg[t // (T / S)]
  -> img [T, ts*ts, D], alpha [T, ts*ts, 1], depth [T, ts*ts, 1] and the
     final log-transmittance logT [T, 1, ts*ts] saved for the backward.
Transmittance is carried in log space (log1p, prefix sums, exp) and there
is no saturation skip, unlike the tile-grid pair. Tiles that own no slot
are not written; the caller masks them.
Backward -> dvals [n_slots*128, 7+D] (every slot written; padding zeros).

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor takes
the plain twin. There is no fallback from one to the other.
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


def _check(meta, vals, bg, ts, n_tiles, tensors=()):
    """Validate what the stream kernels take; returns (n_slots, d)."""
    if ts not in SUPPORTED_TS:
        raise ValueError(f"tile size {ts} not in {SUPPORTED_TS}")
    if meta.dtype != torch.int32 or meta.dim() != 2 or meta.shape[0] != 4:
        raise ValueError(f"meta must be int32 [4, n_slots], got {meta.dtype} {tuple(meta.shape)}")
    if bg.dtype != torch.float32 or bg.dim() != 2 or bg.shape[0] < 1:
        raise ValueError(f"bg must be float32 [S, D], got {bg.dtype} {tuple(bg.shape)}")
    if n_tiles % bg.shape[0]:
        raise ValueError(f"{n_tiles} tiles do not split into {bg.shape[0]} scenes")
    n_slots, d = meta.shape[1], bg.shape[1]
    if d not in SUPPORTED_D:
        raise ValueError(f"channel count {d} not in {SUPPORTED_D}")
    if vals.dtype != torch.float32 or tuple(vals.shape) != (n_slots * CHUNK, 7 + d):
        raise ValueError(f"vals must be float32 [{n_slots * CHUNK}, {7 + d}], got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    for x, shape in tensors:
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"expected float32 {shape}, got {x.dtype} {tuple(x.shape)}")
    for x in (meta, vals, bg, *(x for x, _ in tensors)):
        if x.device != vals.device:
            raise ValueError("all compositor inputs must be on one device")
        if not x.is_contiguous():
            raise ValueError("compositor inputs must be contiguous")
    if vals.device.type == "cuda" and vals.data_ptr() % 16:
        raise ValueError("vals must be 16-byte aligned (chunks load as float4)")
    return n_slots, d


# ---------------------------------------------------------------------------
# Plain PyTorch twins (CPU path; on the card, reference and timing only)
# ---------------------------------------------------------------------------

def _runs(meta):
    """Each tile's run of real chunks: (first slot [R], chunk count [R],
    tile [R]). Real chunks (rank < count) are a prefix of their run."""
    t, rank, cnt = (meta[i].to(torch.int64) for i in range(3))
    n_slots = t.shape[0]
    first = torch.ones(n_slots, dtype=torch.bool, device=t.device)
    first[1:] = t[1:] != t[:-1]
    run_id = torch.cumsum(first.to(torch.int64), 0) - 1
    real = rank < cnt
    n_real = torch.zeros(int(first.sum()), dtype=torch.int64, device=t.device)
    n_real.index_add_(0, run_id, real.to(torch.int64))
    c0 = torch.nonzero(first).flatten()
    keep = n_real > 0
    return c0[keep], n_real[keep], t[c0[keep]]


def _run_chunk(meta, vals, c0, n_real, k, d):
    """Chunk k of every run: (live [R], slot [R], blk [R, 7+D, 128],
    lane_ok [R, 128])."""
    live = k < n_real
    slot = torch.where(live, c0 + k, torch.zeros_like(c0))
    blk = vals.reshape(-1, CHUNK, 7 + d)[slot].transpose(1, 2)
    rank = meta[1].to(torch.int64)[slot]
    cnt = meta[2].to(torch.int64)[slot]
    lane = torch.arange(CHUNK, device=vals.device)
    lane_ok = (lane[None] + rank[:, None]) < cnt[:, None]
    return live, slot, blk, lane_ok


def composite_stream_plain_fwd(meta, vals, bg, ts: int, n_tx: int, n_tiles: int):
    """The forward kernel's algorithm in plain torch, vectorized over the
    tiles' runs with a Python loop over the chunk index: log-space
    transmittance, incl = (in-chunk prefix of log1p(-alpha)) + carry,
    w = alpha * exp(incl - log1m). Tiles owning no run come back as
    zeros (the kernel leaves them unwritten)."""
    d = bg.shape[1]
    dev = vals.device
    p = ts * ts
    c0, n_real, tiles = _runs(meta)
    n_runs = tiles.shape[0]
    px, py = _pixel_coords(n_tiles, ts, n_tx, dev, bg.shape[0])
    px, py = px[tiles], py[tiles]
    log_t = torch.zeros((n_runs, p, 1), device=dev)
    acc_img = torch.zeros((n_runs, p, d), device=dev)
    acc_a = torch.zeros((n_runs, p, 1), device=dev)
    acc_d = torch.zeros((n_runs, p, 1), device=dev)
    for k in range(int(n_real.max()) if n_runs else 0):
        live, _, blk, lane_ok = _run_chunk(meta, vals, c0, n_real, k, d)
        alpha, _, _, _, _ = _chunk_alphas(blk, px, py, lane_ok)
        log1m = torch.log1p(-alpha)
        incl = torch.cumsum(log1m, dim=2) + log_t
        w = alpha * torch.exp(incl - log1m)  # [R, P, 128]
        m = live[:, None, None]
        acc_img = torch.where(m, acc_img + torch.einsum("rpl,rdl->rpd", w, blk[:, 6:6 + d]),
                              acc_img)
        acc_a = torch.where(m, acc_a + torch.sum(w, dim=2, keepdim=True), acc_a)
        acc_d = torch.where(m, acc_d + torch.sum(w * blk[:, None, 6 + d], dim=2, keepdim=True),
                            acc_d)
        log_t = torch.where(m, incl[..., -1:], log_t)
    img = torch.zeros((n_tiles, p, d), device=dev)
    alpha_o = torch.zeros((n_tiles, p, 1), device=dev)
    depth_o = torch.zeros((n_tiles, p, 1), device=dev)
    logt_o = torch.zeros((n_tiles, 1, p), device=dev)
    img[tiles] = acc_img + torch.exp(log_t) * tile_bg(bg, n_tiles)[tiles]
    alpha_o[tiles] = acc_a
    depth_o[tiles] = acc_d
    logt_o[tiles] = log_t.transpose(1, 2)
    return img, alpha_o, depth_o, logt_o


def _suffix_sum(x):
    """Inclusive suffix sum along the lane axis."""
    return torch.flip(torch.cumsum(torch.flip(x, (2,)), dim=2), (2,))


def composite_stream_plain_bwd(meta, vals, bg, logt, gimg, galpha, gdepth,
                               ts: int, n_tx: int):
    """The backward kernel's algorithm in plain torch: a reverse sweep per
    run from the saved final logT, U = in-chunk suffix of log1m + carry,
    T_excl = exp(logT - U), S = (suffix of wd - wd) + carry + base_S,
    dalpha = T_excl dL/dw - S / max(1 - alpha, 1e-6) gated to
    eps <= raw < 0.99, per-pair rows summed over the run's pixels. Every
    other slot (padding, slots of no run) is zeros."""
    d = bg.shape[1]
    dev = vals.device
    n_tiles = gimg.shape[0]
    c0, n_real, tiles = _runs(meta)
    n_runs = tiles.shape[0]
    dvals = torch.zeros_like(vals).reshape(-1, CHUNK, 7 + d)
    if n_runs == 0:
        return dvals.reshape(vals.shape)
    px, py = _pixel_coords(n_tiles, ts, n_tx, dev, bg.shape[0])
    px, py = px[tiles], py[tiles]
    log_total = logt[tiles].transpose(1, 2)  # [R, P, 1]
    gi, ga, gz = gimg[tiles], galpha[tiles], gdepth[tiles]
    base_s = torch.exp(log_total) * torch.sum(gi * tile_bg(bg, n_tiles)[tiles], dim=-1,
                                              keepdim=True)
    suf_log = torch.zeros_like(log_total)
    suf_s = torch.zeros_like(log_total)
    for k in reversed(range(int(n_real.max()))):
        live, slot, blk, lane_ok = _run_chunk(meta, vals, c0, n_real, k, d)
        alpha, raw, power, dx, dy = _chunk_alphas(blk, px, py, lane_ok)
        log1m = torch.log1p(-alpha)
        t_excl = torch.exp(log_total - (_suffix_sum(log1m) + suf_log))
        w = alpha * t_excl
        cols = blk[:, 6:6 + d]
        dld = blk[:, None, 6 + d] * gz + ga + torch.einsum("rpd,rdl->rpl", gi, cols)
        wd = w * dld
        s = ((_suffix_sum(wd) - wd) + suf_s) + base_s
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
                        torch.zeros_like(lane_ok, dtype=vals.dtype)),
        ]
        dcol = torch.einsum("rpl,rpd->rdl", w, gi)
        rows += [dcol[:, j] for j in range(d)]
        rows.append(torch.sum(w * gz, dim=1))
        dblk = torch.stack(rows, dim=2)  # [R, 128, 7+D]
        dvals[slot[live]] = dblk[live]
        m = live[:, None, None]
        suf_log = torch.where(m, suf_log + torch.sum(log1m, dim=2, keepdim=True), suf_log)
        suf_s = torch.where(m, suf_s + torch.sum(wd, dim=2, keepdim=True), suf_s)
    return dvals.reshape(vals.shape)


# ---------------------------------------------------------------------------
# Wrappers: kernel on CUDA tensors, plain twin on CPU tensors
# ---------------------------------------------------------------------------

def _launch_fwd(symbol, meta, vals, bg, ts, n_tx, n_tiles, n_slots, d):
    p = ts * ts
    outs = [torch.empty(shape, dtype=torch.float32, device=vals.device)
            for shape in ((n_tiles, p, d), (n_tiles, p, 1), (n_tiles, p, 1), (n_tiles, 1, p))]
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = getattr(kernel_library(), symbol)(
        meta.data_ptr(), vals.data_ptr(), bg.data_ptr(), *(o.data_ptr() for o in outs),
        n_slots, n_tiles, n_tx, n_tiles // bg.shape[0], ts, d, stream)
    _launch_check(rc, "stream forward")
    return tuple(outs)


def stream_forward(meta, vals, bg, ts: int, n_tx: int, n_tiles: int):
    """Forward compositor -> (img, alpha, depth, logT). CUDA tensors launch
    the kernel (tiles owning no slot stay unwritten); CPU tensors run
    composite_stream_plain_fwd."""
    n_slots, d = _check(meta, vals, bg, ts, n_tiles)
    if vals.device.type == "cpu":
        return composite_stream_plain_fwd(meta, vals, bg, ts, n_tx, n_tiles)
    if vals.device.type != "cuda":
        raise ValueError(f"no stream compositor for device {vals.device}")
    outs = _launch_fwd("egogs_stream_fwd", meta, vals, bg, ts, n_tx, n_tiles, n_slots, d)
    StreamCompositor.fwd_launches[d] += 1
    return outs


def stream_forward_nocull(meta, vals, bg, ts: int, n_tx: int, n_tiles: int):
    """The forward kernel instantiated with its per-warp cull compiled out
    (CUDA tensors only; not counted). A check instance: on the tiles that
    own a slot its outputs must equal stream_forward's bit for bit."""
    n_slots, d = _check(meta, vals, bg, ts, n_tiles)
    if vals.device.type != "cuda":
        raise ValueError("the cull-free check instance runs on CUDA tensors only")
    return _launch_fwd("egogs_stream_fwd_nocull", meta, vals, bg, ts, n_tx, n_tiles, n_slots, d)


def _check_bwd(meta, vals, bg, logt, gimg, galpha, gdepth, ts):
    n_tiles, p = logt.shape[0], ts * ts
    d = bg.shape[1]
    n_slots, _ = _check(meta, vals, bg, ts, n_tiles, tensors=[
        (logt, (n_tiles, 1, p)), (gimg, (n_tiles, p, d)), (galpha, (n_tiles, p, 1)),
        (gdepth, (n_tiles, p, 1))])
    return n_slots, n_tiles, d


def _launch_bwd(symbol, meta, vals, bg, logt, gimg, galpha, gdepth, ts, n_tx, n_slots, n_tiles,
                d):
    dvals = torch.empty_like(vals)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = getattr(kernel_library(), symbol)(
        *(x.data_ptr() for x in (meta, vals, bg, logt, gimg, galpha, gdepth, dvals)),
        n_slots, n_tiles, n_tx, n_tiles // bg.shape[0], ts, d, stream)
    _launch_check(rc, "stream backward")
    return dvals


def stream_backward(meta, vals, bg, logt, gimg, galpha, gdepth, ts: int, n_tx: int):
    """Backward compositor -> dvals, every slot written. CUDA tensors launch
    the kernel; CPU tensors run composite_stream_plain_bwd."""
    dims = _check_bwd(meta, vals, bg, logt, gimg, galpha, gdepth, ts)
    if vals.device.type == "cpu":
        return composite_stream_plain_bwd(meta, vals, bg, logt, gimg, galpha, gdepth, ts, n_tx)
    if vals.device.type != "cuda":
        raise ValueError(f"no stream compositor for device {vals.device}")
    dvals = _launch_bwd("egogs_stream_bwd", meta, vals, bg, logt, gimg, galpha, gdepth, ts,
                        n_tx, *dims)
    StreamCompositor.bwd_launches[dims[2]] += 1
    return dvals


def stream_backward_nocull(meta, vals, bg, logt, gimg, galpha, gdepth, ts: int, n_tx: int):
    """The backward kernel instantiated with its per-warp cull compiled out
    (CUDA tensors only; not counted). A check instance: its gradients must
    equal stream_backward's bit for bit."""
    dims = _check_bwd(meta, vals, bg, logt, gimg, galpha, gdepth, ts)
    if vals.device.type != "cuda":
        raise ValueError("the cull-free check instance runs on CUDA tensors only")
    return _launch_bwd("egogs_stream_bwd_nocull", meta, vals, bg, logt, gimg, galpha, gdepth,
                       ts, n_tx, *dims)


class StreamCompositor(torch.autograd.Function):
    """(meta, vals, bg, ts, n_tx, n_tiles) -> (img, alpha, depth) with the
    stream backward kernel as its gradient; bg gets a zero gradient, as in
    the JAX VJP. fwd_launches / bwd_launches count kernel launches per
    channel count D; the CPU twin path does not count."""

    fwd_launches = {d: 0 for d in SUPPORTED_D}
    bwd_launches = {d: 0 for d in SUPPORTED_D}

    @staticmethod
    def reset_launch_counts():
        for d in SUPPORTED_D:
            StreamCompositor.fwd_launches[d] = 0
            StreamCompositor.bwd_launches[d] = 0

    @staticmethod
    def forward(ctx, meta, vals, bg, ts, n_tx, n_tiles):
        img, alpha, depth, logt = stream_forward(meta, vals, bg, ts, n_tx, n_tiles)
        ctx.save_for_backward(meta, vals, bg, logt)
        ctx.ts, ctx.n_tx = ts, n_tx
        return img, alpha, depth

    @staticmethod
    def backward(ctx, gimg, galpha, gdepth):
        meta, vals, bg, logt = ctx.saved_tensors
        dvals = stream_backward(meta, vals, bg, logt, gimg.contiguous(), galpha.contiguous(),
                                gdepth.contiguous(), ctx.ts, ctx.n_tx)
        return None, dvals, torch.zeros_like(bg), None, None, None
