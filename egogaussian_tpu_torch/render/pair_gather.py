"""The pair gather of every binned layout (tile-grid, stream, window) and
its backward: CUDA kernels (`csrc/pair_gather.cu`), plain PyTorch twins,
autograd.

Forward: each layout slot q takes the packed row of its pair, rows[src[q]],
written straight into the layout (the tile-grid's transposed chunks
[n_slots / 128, ch, 128], or rows [n_slots, ch]). Backward: a
deterministic segmented sum per Gaussian. Gaussian g of scene s owns the
pairs offsets[s, g] .. offsets[s, g] + counts[s, g] of its scene's
pre-sort pair array (bin_scenes emits them contiguously, in increasing
tile id), and pair p sits in layout slot pair_slot[s, p] (-1: culled, past
max_pairs or max_per_tile, in an overflowed tile, or in no window row).
The Gaussian's row gets the sum of its pairs' slot gradients in increasing
p, which is increasing slot: the order in which autograd's index backward
of `rows[src]` sums that row, with only the exact zeros of padding and
clamped slots left out. So the gradient is autograd's bit for bit, up to
the sign of a zero, with no sort, no float atomics, and no serial pass over
the clamped slot tail.

Dispatch: CUDA tensors launch the kernels (or raise); CPU tensors take the
plain twins. There is no fallback from one to the other.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from egogaussian_tpu_torch.render.cuda_raster import CHUNK, kernel_library


class PairIndex(NamedTuple):
    """What the gather and its backward read, every tensor int64 on the rows'
    device; S scenes of N Gaussians and MP pair slots each, the rows
    flattened scene-major ([S * N, ch])."""

    src: torch.Tensor  # [n_slots] row of each layout slot
    order: torch.Tensor  # [S, N] row (within its scene) of depth-sorted Gaussian g
    offsets: torch.Tensor  # [S, N] first pre-sort pair of Gaussian g
    counts: torch.Tensor  # [S, N] pairs Gaussian g emits
    pair_slot: torch.Tensor  # [S, MP] layout slot of each pre-sort pair, -1 for none


def _check(rows: torch.Tensor, index: PairIndex, transposed: bool):
    if rows.dtype != torch.float32 or rows.dim() != 2:
        raise ValueError(f"rows must be float32 [R, ch], got {rows.dtype} {tuple(rows.shape)}")
    s_n, n = index.order.shape
    if rows.shape[0] != s_n * n:
        raise ValueError(f"{rows.shape[0]} rows for {s_n} scenes of {n} Gaussians")
    if index.pair_slot.dim() != 2 or index.pair_slot.shape[0] != s_n:
        raise ValueError(f"pair_slot must be [{s_n}, MP], got {tuple(index.pair_slot.shape)}")
    if transposed and index.src.shape[0] % CHUNK:
        raise ValueError(f"{index.src.shape[0]} slots are not whole {CHUNK}-pair chunks")
    for x in index:
        if x.dtype != torch.int64 or x.device != rows.device or not x.is_contiguous():
            raise ValueError("the pair index must be contiguous int64 on the rows' device")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")


def _launch_check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


# ---------------------------------------------------------------------------
# Plain PyTorch twins (CPU path; on the card, reference and timing only)
# ---------------------------------------------------------------------------

def gather_plain(rows: torch.Tensor, src: torch.Tensor, transposed: bool) -> torch.Tensor:
    """The gather kernel's function: rows[src], as transposed chunks or rows."""
    out = rows[src]
    if transposed:
        out = out.reshape(-1, CHUNK, rows.shape[1]).transpose(1, 2).contiguous()
    return out


def _slot_rows(dvals: torch.Tensor, ch: int, transposed: bool) -> torch.Tensor:
    """dvals in the gather's layout as [n_slots, ch] (a copy if transposed)."""
    return dvals.transpose(1, 2).reshape(-1, ch) if transposed else dvals.reshape(-1, ch)


def reduce_plain(dvals: torch.Tensor, index: PairIndex, ch: int,
                 transposed: bool) -> torch.Tensor:
    """The reduce kernel's algorithm: every Gaussian at once, a Python loop
    over the k-th pair of each, added where the pair holds a slot."""
    dv = _slot_rows(dvals, ch, transposed)
    s_n, n = index.order.shape
    mp = index.pair_slot.shape[1]
    first = index.offsets
    live_n = torch.clamp(torch.clamp(first + index.counts, max=mp) - first, min=0)
    k_max = int(live_n.max()) if live_n.numel() else 0
    acc = torch.zeros((s_n, n, ch), dtype=dvals.dtype, device=dvals.device)
    for k in range(k_max):
        q = torch.gather(index.pair_slot, 1, torch.clamp(first + k, max=mp - 1))
        live = (k < live_n) & (q >= 0)
        acc = torch.where(live[..., None], acc + dv[torch.clamp(q, min=0)], acc)
    drows = torch.empty_like(acc)
    drows.scatter_(1, index.order[..., None].expand(-1, -1, ch), acc)
    return drows.reshape(s_n * n, ch)


# ---------------------------------------------------------------------------
# Wrappers: kernel on CUDA tensors, plain twin on CPU tensors
# ---------------------------------------------------------------------------

def gather(rows: torch.Tensor, index: PairIndex, transposed: bool) -> torch.Tensor:
    """The layout's vals from rows. CUDA tensors launch the gather kernel;
    CPU tensors run gather_plain."""
    _check(rows, index, transposed)
    if rows.device.type == "cpu":
        return gather_plain(rows, index.src, transposed)
    if rows.device.type != "cuda":
        raise ValueError(f"no pair gather for device {rows.device}")
    n_slots, ch = index.src.shape[0], rows.shape[1]
    shape = (n_slots // CHUNK, ch, CHUNK) if transposed else (n_slots, ch)
    out = torch.empty(shape, dtype=torch.float32, device=rows.device)
    rc = kernel_library().egogs_pair_gather(
        rows.data_ptr(), index.src.data_ptr(), out.data_ptr(), n_slots, ch, int(transposed),
        torch.cuda.current_stream(rows.device).cuda_stream)
    _launch_check(rc, "pair gather")
    PairGather.gather_launches += 1
    return out


def reduce(dvals: torch.Tensor, index: PairIndex, ch: int, transposed: bool) -> torch.Tensor:
    """drows [S * N, ch] from the layout's gradient. CUDA tensors launch the
    reduce kernel; CPU tensors run reduce_plain."""
    if dvals.dtype != torch.float32 or not dvals.is_contiguous():
        raise ValueError("dvals must be contiguous float32")
    if dvals.numel() != index.src.shape[0] * ch:
        raise ValueError(f"dvals of {dvals.numel()} floats for {index.src.shape[0]} slots")
    if dvals.device.type == "cpu":
        return reduce_plain(dvals, index, ch, transposed)
    if dvals.device.type != "cuda":
        raise ValueError(f"no pair gather for device {dvals.device}")
    s_n, n = index.order.shape
    drows = torch.empty((s_n * n, ch), dtype=torch.float32, device=dvals.device)
    rc = kernel_library().egogs_pair_reduce(
        dvals.data_ptr(), index.pair_slot.data_ptr(), index.offsets.data_ptr(),
        index.counts.data_ptr(), index.order.data_ptr(), drows.data_ptr(), s_n, n,
        index.pair_slot.shape[1], ch, int(transposed),
        torch.cuda.current_stream(dvals.device).cuda_stream)
    _launch_check(rc, "pair reduce")
    PairGather.reduce_launches += 1
    return drows


class PairGather(torch.autograd.Function):
    """(rows, index, transposed) -> the layout's vals, with the reduce
    kernel as its gradient. gather_launches and reduce_launches count
    kernel launches; the CPU twin path does not count."""

    gather_launches = 0
    reduce_launches = 0

    @staticmethod
    def reset_launch_counts():
        PairGather.gather_launches = 0
        PairGather.reduce_launches = 0

    @staticmethod
    def forward(ctx, rows, index: PairIndex, transposed: bool):
        ctx.index, ctx.transposed = index, transposed
        return gather(rows, index, transposed)

    @staticmethod
    def backward(ctx, dvals):
        ch = dvals.shape[1] if ctx.transposed else dvals.shape[-1]
        return reduce(dvals.contiguous(), ctx.index, ch, ctx.transposed), None, None


def gather_pairs(rows: torch.Tensor, index: PairIndex, transposed: bool) -> torch.Tensor:
    """The layout's vals from the packed rows [S * N, ch], differentiable in
    rows: transposed chunks [n_slots / 128, ch, 128] or rows [n_slots, ch]."""
    return PairGather.apply(rows, index, transposed)
