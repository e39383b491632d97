"""The card's float32 FMA peak, and the least time a compositor kernel
could take on the card.

Port of `bench.py:_vpu_peak_gflops` (its Pallas kernel `kern`, the JAX
bench's empirical float32 peak): `fma_chain` steps every element of a
[rows, 128] float32 block n_loop times by x = fma(x, 1.0000001, 1e-9), a
hand-written CUDA kernel (`csrc/fma_peak.cu`, built into the library of
`render/cuda_raster.py`); `fma_chain_plain` is its twin;
`fma_peak_gflops` times it with CUDA events.

The bounds (`bound`, `ops_per_eval`, `covered_evaluations`) are
the yardstick each compositor kernel's time is held against: the larger
of the bytes it must move over the HBM rate and its operations over the
float32 issue rate. Operations are counted as instructions (an add,
multiply, FMA, compare or transcendental is one), so they are divided by
the published instruction rate, half the published 67 TFLOP/s, which
counts an FMA as two flops. Evaluations are counted from the data: the
pair-pixel evaluations whose gated alpha is > 0 (before the tile-grid's
saturation skip), the same whatever implements the kernel.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor takes
the plain twin. There is no fallback from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from egogaussian_tpu_torch.render.cuda_raster import (
    CHUNK,
    _chunk_alphas,
    _chunk_schedule,
    _launch_check,
    _pixel_coords,
    kernel_library,
)

# NVIDIA H100 SXM datasheet, at its 700 W power limit: float32 outside the
# tensor cores (an FMA counted as two flops) and HBM3. The published
# 67 TFLOP/s is what a share is stated against.
FP32_FLOPS = 67e12
# float32 instructions per second: 132 SMs x 128 lanes x 1.98 GHz, the
# published rate with an FMA counted once
FP32_INSTR_PER_S = FP32_FLOPS / 2
HBM_BYTES_PER_S = 3.35e12

# the TPU kernel's constants as float32 (bench.py:275)
FMA_MUL = float(np.float32(1.0000001))
FMA_ADD = float(np.float32(1e-9))
PEAK_LOOP = 120_000  # bench.py:257
PEAK_REPS = 3  # bench.py:287
THREADS_PER_SM = 2048  # resident threads per SM on Hopper
TILE_BATCH = 256  # tiles per step of covered_evaluations (bounds its memory)


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------

def ops_per_eval(kind: str, d: int) -> int:
    """Instructions per pair-pixel evaluation, each add, multiply, FMA,
    compare and transcendental counted as one: the alpha (~12), the
    transmittance step and weight (~4) and the accumulation (2D + 4) in a
    forward; a backward adds dL/dw (2D + 2), S and dalpha (~8) and the
    per-row terms (2D + 20); "bwd2" is a backward with a value-only
    pre-sweep (exact-total, simple windowed)."""
    fwd = 20 + 2 * d
    bwd = fwd + 30 + 4 * d
    return {"fwd": fwd, "bwd": bwd, "bwd2": bwd + fwd}[kind]


def _larger(t_bytes: float, t_ops: float):
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bound(kind: str, d: int, evals: int, n_bytes: int, instr_per_s: float = FP32_INSTR_PER_S):
    """(bound_ms, bound_by): the larger of n_bytes over the HBM rate and
    evals x ops_per_eval(kind, d) instructions over the float32
    instruction rate (the published one unless given)."""
    return _larger(n_bytes / HBM_BYTES_PER_S, evals * ops_per_eval(kind, d) / instr_per_s)


def bound_fma(rows: int, n_loop: int, instr_per_s: float = FP32_INSTR_PER_S):
    """fma_chain's (bound_ms, bound_by): rows x 128 x n_loop FMAs, one
    instruction each, against 8 bytes per element (read once, written
    once)."""
    n = rows * 128
    return _larger(8 * n / HBM_BYTES_PER_S, n * n_loop / instr_per_s)


def covered_evaluations(meta, vals, ts: int, n_tx: int) -> int:
    """Pair-pixel evaluations of a tile-grid layout (meta [3, T], vals
    [n_slots, ch16, 128]) with gated alpha > 0, over every chunk of every
    tile (no saturation skip), from the twin's own alpha. The stream layout
    and the gather window of the same binning hold the same pairs, so when
    no pair is dropped this is their count too."""
    start, cnt, n_chunks, _ = _chunk_schedule(meta)
    n_tiles = meta.shape[1]
    px, py = _pixel_coords(n_tiles, ts, n_tx, vals.device)
    lane = torch.arange(CHUNK, device=vals.device)
    total = torch.zeros((), dtype=torch.int64, device=vals.device)
    with torch.no_grad():
        for b in range(0, n_tiles, TILE_BATCH):
            sl = slice(b, min(b + TILE_BATCH, n_tiles))
            for c in range(int(n_chunks[sl].max()) if n_tiles else 0):
                live = c < n_chunks[sl]
                blk = vals[torch.where(live, start[sl] + c, torch.zeros_like(start[sl]))]
                lane_ok = ((lane[None] + c * CHUNK) < cnt[sl, None]) & live[:, None]
                total += torch.count_nonzero(_chunk_alphas(blk, px[sl], py[sl], lane_ok)[0] > 0)
    return int(total)


# ---------------------------------------------------------------------------
# The FMA chain: kernel, twin, timing
# ---------------------------------------------------------------------------

class FmaChain:
    """Launch count of the fma_chain kernel (the CPU twin path does not
    count)."""

    launches = 0

    @staticmethod
    def reset_launch_counts():
        FmaChain.launches = 0


def _check_block(x):
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 128:
        raise ValueError(f"x must be float32 [rows, 128], got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def fma_chain_plain(x, n_loop: int):
    """The kernel's function in plain torch: n_loop steps of
    x * 1.0000001 + 1e-9 in float64, rounded to float32 after each step
    (one rounding per step, like the fused multiply-add)."""
    _check_block(x)
    y = x.to(torch.float64)
    for _ in range(n_loop):
        y = y.mul_(FMA_MUL).add_(FMA_ADD).to(torch.float32).to(torch.float64)
    return y.to(torch.float32)


def fma_chain(x, n_loop: int):
    """x [rows, 128] float32 stepped n_loop times by fma(x, 1.0000001,
    1e-9). CUDA tensors launch the kernel; CPU tensors run
    fma_chain_plain."""
    _check_block(x)
    if x.device.type == "cpu":
        return fma_chain_plain(x, n_loop)
    if x.device.type != "cuda":
        raise ValueError(f"no fma_chain kernel for device {x.device}")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = kernel_library().egogs_fma_chain(x.data_ptr(), out.data_ptr(), x.numel(),
                                          int(n_loop), stream)
    _launch_check(rc, "fma chain")
    FmaChain.launches += 1
    return out


def default_rows(device) -> int:
    """Rows that give every SM of the card a full set of resident threads,
    one dependent chain each (2,112 on a 132-SM H100)."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count * THREADS_PER_SM // 128


def fma_peak_gflops(device=torch.device("cuda"), n_loop: int = PEAK_LOOP, rows=None) -> float:
    """The card's measured float32 rate in GFLOP/s (FMA = 2 flops): one
    warm-up launch of fma_chain on a [rows, 128] block of ones, then
    PEAK_REPS launches between two CUDA events (rows: default_rows)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the FMA peak is a measurement of a CUDA device")
    rows = default_rows(device) if rows is None else rows
    x = torch.ones((rows, 128), dtype=torch.float32, device=device)
    fma_chain(x, n_loop)
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(PEAK_REPS):
        fma_chain(x, n_loop)
    end.record()
    torch.cuda.synchronize(device)
    seconds = start.elapsed_time(end) / PEAK_REPS * 1e-3
    return rows * 128 * n_loop * 2 / seconds / 1e9
