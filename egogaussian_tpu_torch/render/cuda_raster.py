"""The tile-grid compositor: CUDA kernels, plain PyTorch twins, autograd;
and the build of the kernel library that every compositor shares (the
tile-grid, stream and windowed kernels of `egogaussian_tpu_torch/csrc/`,
and the layouts' pair gather, render/pair_gather.py).

Port of the tile-grid half of `egogaussian_tpu/render/pallas_raster.py`
(`make_tilegrid_compositor`, `_tilegrid_fwd_kernel`, `_tilegrid_bwd_kernel`
in both flavors: exact_total=False rebuilds each pixel's weighted
gradient total from the saved outputs, exact_total=True recomputes it in a
value-only pre-sweep). The kernels are CUDA C++ for sm_90a in
`egogaussian_tpu_torch/csrc/`, compiled by nvcc at first use into
`build/kernels/` as one shared library with a plain C interface and
loaded with ctypes.

Interface (the TPU kernels' own):
  meta [3, T] int32: (first chunk slot, pair count, fit-slot count
    broadcast; slots >= meta[2, 0] belong to no tile)
  vals [n_slots, ch16, 128] float32: 128-pair chunks, transposed, rows
    mu_x | mu_y | a | b | c | op | col x D | z | zero padding
  bg [S, D] float32
  -> img [T, ts*ts, D], alpha [T, ts*ts, 1], depth [T, ts*ts, 1]

The scene axis (the batch axis JAX's vmap adds to the pallas_call): the T
tiles are S scenes' tile grids of T / S tiles each, scene-major; tile t
takes its pixel origin from t mod T / S and its background from bg[t //
(T / S)]. One launch covers every scene, and per tile the work is that of
a one-scene launch, so S scenes in one launch equal S one-scene launches
bit for bit. The meta rows and slots index the whole layout.
Backward -> dvals [n_slots, ch16, 128] (rows dmu_x, dmu_y, da, db, dc, dop,
dcol x D, dz).

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor takes
the plain twin. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Tuple

import torch

from egogaussian_tpu_torch.render.oracle import ALPHA_EPS, ALPHA_MAX

CHUNK = 128
# saturation skip threshold of the TPU kernels (pallas_raster._SAT_SKIP_EPS)
SAT_SKIP_EPS = 1e-7
SUPPORTED_D = (1, 3)
SUPPORTED_TS = (16, 32)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
_SOURCES = ("tilegrid_common.cuh", "tilegrid_cluster.cuh", "chunked_pair.cuh",
            "window_split.cuh", "tilegrid_fwd.cu", "tilegrid_bwd.cu", "stream_fwd.cu", "stream_bwd.cu",
            "window_chunked_fwd.cu", "window_chunked_bwd.cu", "window_fwd.cu", "window_bwd.cu",
            "fma_peak.cu", "pair_gather.cu")
# compile flags of each source; the objects are then linked with -shared
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def ch16_of(d: int) -> int:
    """Rows of a chunk: 7 + d fields rounded up to a multiple of 8."""
    return ((7 + d) + 7) // 8 * 8


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if nvcc is None and os.path.exists(default):
        nvcc = default
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the compositor kernels are built from "
            f"{CSRC_DIR} at first use and need the CUDA toolkit")
    return nvcc


def library_path() -> str:
    """Path of the shared library for the current sources (content hash)."""
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libegogs_raster_{h.hexdigest()[:16]}.so")


def build_library() -> Tuple[str, str]:
    """Compile the kernels with nvcc (if this source hash is not built yet).
    Returns (library path, compiler log). Raises on any failure."""
    out = library_path()
    log_path = out[:-3] + ".log"
    if os.path.exists(out):
        with open(log_path) as f:
            return out, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _find_nvcc()
    tmp = out + f".tmp{os.getpid()}"
    # one nvcc per source, all started together, then one link
    objs, procs = [], []
    for s in _SOURCES:
        if s.endswith(".cu"):
            objs.append(f"{tmp}.{s[:-3]}.o")
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, s), "-o", objs[-1]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    failed = [p.returncode for p in procs if p.returncode != 0]
    if not failed:
        res = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True,
                             text=True)
        log += res.stdout + res.stderr
        failed = [res.returncode] if res.returncode != 0 else []
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, out)
    return out, log


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    path, _ = build_library()
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.egogs_tilegrid_fwd, lib.egogs_tilegrid_fwd_nocull):
        fn.restype = i
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    for fn in (lib.egogs_tilegrid_bwd, lib.egogs_tilegrid_bwd_nocull):
        fn.restype = i
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    for fn in (lib.egogs_stream_fwd, lib.egogs_stream_fwd_nocull):
        fn.restype = i
        fn.argtypes = [p] * 7 + [i] * 6 + [p]
    for fn in (lib.egogs_stream_bwd, lib.egogs_stream_bwd_nocull):
        fn.restype = i
        fn.argtypes = [p] * 8 + [i] * 6 + [p]
    for fn in (lib.egogs_window_chunked_fwd, lib.egogs_window_chunked_fwd_nocull):
        fn.restype = i
        fn.argtypes = [p] * 7 + [i] * 6 + [p]
    for fn in (lib.egogs_window_chunked_bwd, lib.egogs_window_chunked_bwd_nocull):
        fn.restype = i
        fn.argtypes = [p] * 8 + [i] * 6 + [p]
    for fn in (lib.egogs_window_fwd, lib.egogs_window_fwd_nocull):
        fn.restype = i
        fn.argtypes = [p] * 9 + [i] * 5 + [p]
    for fn in (lib.egogs_window_bwd, lib.egogs_window_bwd_nocull):
        fn.restype = i
        fn.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.egogs_fma_chain.restype = i
    lib.egogs_fma_chain.argtypes = [p, p, i, i, p]
    lib.egogs_pair_gather.restype = i
    lib.egogs_pair_gather.argtypes = [p, p, p, ctypes.c_longlong, i, i, p]
    lib.egogs_pair_reduce.restype = i
    lib.egogs_pair_reduce.argtypes = [p] * 6 + [i] * 5 + [p]
    return lib


# ---------------------------------------------------------------------------
# Input checks
# ---------------------------------------------------------------------------

def _check(meta, vals, bg, ts, tensors=()):
    """Validate what the kernels take; returns (n_tiles, d)."""
    if ts not in SUPPORTED_TS:
        raise ValueError(f"tile size {ts} not in {SUPPORTED_TS}")
    if meta.dtype != torch.int32 or meta.dim() != 2 or meta.shape[0] != 3:
        raise ValueError(f"meta must be int32 [3, T], got {meta.dtype} {tuple(meta.shape)}")
    if bg.dtype != torch.float32 or bg.dim() != 2 or bg.shape[0] < 1:
        raise ValueError(f"bg must be float32 [S, D], got {bg.dtype} {tuple(bg.shape)}")
    n_tiles, d = meta.shape[1], bg.shape[1]
    if n_tiles % bg.shape[0]:
        raise ValueError(f"{n_tiles} tiles do not split into {bg.shape[0]} scenes")
    if d not in SUPPORTED_D:
        raise ValueError(f"channel count {d} not in {SUPPORTED_D}")
    if (vals.dtype != torch.float32 or vals.dim() != 3
            or vals.shape[1:] != (ch16_of(d), CHUNK)):
        raise ValueError(
            f"vals must be float32 [n_slots, {ch16_of(d)}, {CHUNK}], got "
            f"{vals.dtype} {tuple(vals.shape)}")
    p = ts * ts
    for x, c in tensors:
        if x.dtype != torch.float32 or tuple(x.shape) != (n_tiles, p, c):
            raise ValueError(
                f"expected float32 [{n_tiles}, {p}, {c}], got {x.dtype} {tuple(x.shape)}")
    for x in (meta, vals, bg, *(x for x, _ in tensors)):
        if x.device != vals.device:
            raise ValueError("all compositor inputs must be on one device")
        if not x.is_contiguous():
            raise ValueError("compositor inputs must be contiguous")
    if vals.device.type == "cuda" and vals.data_ptr() % 16:
        raise ValueError("vals must be 16-byte aligned (chunks load by bulk copy)")
    return n_tiles, d


def _launch_check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(
            f"{what} launch failed: "
            + ("unsupported (d, ts)" if rc < 0 else f"cudaError {rc}"))


# ---------------------------------------------------------------------------
# Plain PyTorch twins (CPU path; on the card, reference and timing only)
# ---------------------------------------------------------------------------

def _pixel_coords(n_tiles: int, ts: int, n_tx: int, device, scenes: int = 1):
    """Pixel centers of every tile's pixels (row-major), [T, P, 1] each;
    the T tiles are `scenes` grids of T / scenes tiles, scene-major."""
    t = torch.arange(n_tiles, device=device) % max(n_tiles // scenes, 1)
    i = torch.arange(ts * ts, device=device)
    tx = (t % n_tx).to(torch.float32)[:, None]
    ty = (t // n_tx).to(torch.float32)[:, None]
    px = tx * ts + (i % ts).to(torch.float32)[None] + 0.5
    py = ty * ts + (i // ts).to(torch.float32)[None] + 0.5
    return px[..., None], py[..., None]


def tile_bg(bg, n_tiles: int):
    """[T, 1, D] background of each tile: row t // (T / S) of bg [S, D]."""
    t = torch.arange(n_tiles, device=bg.device) // max(n_tiles // bg.shape[0], 1)
    return bg[t][:, None, :]


def _chunk_alphas(blk, px, py, lane_ok):
    """alpha [T, P, 128] for chunks blk [T, ch16, 128]; lane_ok [T, 128]."""
    dx = px - blk[:, None, 0]
    dy = py - blk[:, None, 1]
    a, b, c = blk[:, None, 2], blk[:, None, 3], blk[:, None, 4]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    power = torch.minimum(power, power.new_zeros(()))
    op = torch.where(lane_ok, blk[:, 5], torch.zeros_like(blk[:, 5]))[:, None]
    raw = op * torch.exp(power)
    alpha = torch.minimum(raw, raw.new_tensor(ALPHA_MAX))
    alpha = torch.where(alpha < ALPHA_EPS, torch.zeros_like(alpha), alpha)
    return alpha, raw, power, dx, dy


def _chunk_schedule(meta):
    start = meta[0].to(torch.int64)
    cnt = meta[1].to(torch.int64)
    n_chunks = (cnt + CHUNK - 1) // CHUNK
    max_chunks = int(n_chunks.max()) if n_chunks.numel() else 0
    return start, cnt, n_chunks, max_chunks


def _prefix_transmittance(one_minus):
    """Inclusive and exclusive prefix products of (1 - alpha) along lanes."""
    incl = torch.cumprod(one_minus, dim=2)
    excl = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], dim=2)
    return incl, excl


def composite_tilegrid_plain_fwd(meta, vals, bg, ts: int, n_tx: int):
    """The forward kernel's algorithm in plain torch: vectorized over tiles,
    a Python loop over the chunk index, the same tile-wide saturation skip
    (a tile stops once every pixel has T < 1e-7). Differentiable by autograd."""
    n_tiles, d = meta.shape[1], bg.shape[1]
    dev = vals.device
    start, cnt, n_chunks, max_chunks = _chunk_schedule(meta)
    px, py = _pixel_coords(n_tiles, ts, n_tx, dev, bg.shape[0])
    lane = torch.arange(CHUNK, device=dev)
    p = ts * ts
    t_carry = torch.ones((n_tiles, p, 1), device=dev)
    acc_img = torch.zeros((n_tiles, p, d), device=dev)
    acc_a = torch.zeros((n_tiles, p, 1), device=dev)
    acc_d = torch.zeros((n_tiles, p, 1), device=dev)
    for c in range(max_chunks):
        live = (c < n_chunks) & (t_carry.amax(dim=(1, 2)) >= SAT_SKIP_EPS)
        blk = vals[torch.where(live, start + c, torch.zeros_like(start))]
        lane_ok = (lane[None] + c * CHUNK) < cnt[:, None]
        alpha, _, _, _, _ = _chunk_alphas(blk, px, py, lane_ok)
        incl, excl = _prefix_transmittance(1.0 - alpha)
        w = alpha * (t_carry * excl)  # [T, P, 128]
        m = live[:, None, None]
        acc_img = torch.where(m, acc_img + torch.einsum("tpl,tdl->tpd", w, blk[:, 6:6 + d]), acc_img)
        acc_a = torch.where(m, acc_a + torch.sum(w, dim=2, keepdim=True), acc_a)
        acc_d = torch.where(m, acc_d + torch.sum(w * blk[:, None, 6 + d], dim=2, keepdim=True), acc_d)
        t_carry = torch.where(m, t_carry * incl[..., -1:], t_carry)
    return acc_img + t_carry * tile_bg(bg, n_tiles), acc_a, acc_d


def composite_tilegrid_plain_bwd(meta, vals, bg, img, alpha, depth,
                                 gimg, galpha, gdepth, ts: int, n_tx: int,
                                 exact_total: bool = False):
    """The backward kernel's algorithm in plain torch: one forward sweep,
    S = (total - inclusive prefix) + base_S, dalpha gated to
    eps <= raw < 0.99, per-pair rows reduced over each tile's pixels. The
    per-pixel total and base_S = T_final * (gimg . bg) are rebuilt from
    the saved outputs (exact_total=False) or taken from a value-only
    pre-sweep that runs the gradient sweep's own value path, saturation
    votes included (exact_total=True). Slots of no tile and skipped chunks
    are zeros."""
    n_tiles, d = meta.shape[1], bg.shape[1]
    dev = vals.device
    start, cnt, n_chunks, max_chunks = _chunk_schedule(meta)
    px, py = _pixel_coords(n_tiles, ts, n_tx, dev, bg.shape[0])
    lane = torch.arange(CHUNK, device=dev)
    bgv = tile_bg(bg, n_tiles)
    g_dot_bg = torch.sum(gimg * bgv, dim=-1, keepdim=True)

    def chunk_values(c, t_carry, carry_wd):
        """Value path of chunk c (both sweeps): (live, slot, blk, lane_ok,
        alpha terms, one_minus, T_excl, w, dL/dw, inclusive prefix) and the
        advanced (t_carry, carry_wd)."""
        live = (c < n_chunks) & (t_carry.amax(dim=(1, 2)) >= SAT_SKIP_EPS)
        slot = torch.where(live, start + c, torch.zeros_like(start))
        blk = vals[slot]
        lane_ok = (lane[None] + c * CHUNK) < cnt[:, None]
        a_c, raw, power, dx, dy = _chunk_alphas(blk, px, py, lane_ok)
        one_minus = 1.0 - a_c
        incl, excl = _prefix_transmittance(one_minus)
        t_excl = t_carry * excl
        w = a_c * t_excl
        cols = blk[:, 6:6 + d]  # [T, D, 128]
        z = blk[:, None, 6 + d]  # [T, 1, 128]
        dld = z * gdepth + galpha + torch.einsum("tpd,tdl->tpl", gimg, cols)
        pre_wd = torch.cumsum(w * dld, dim=2) + carry_wd
        m = live[:, None, None]
        t_next = torch.where(m, t_carry * incl[..., -1:], t_carry)
        wd_next = torch.where(m, pre_wd[..., -1:], carry_wd)
        return (live, slot, blk, lane_ok, raw, power, dx, dy, one_minus, t_excl, w, dld,
                pre_wd), (t_next, wd_next)

    if exact_total:
        t_carry, carry_wd = torch.ones_like(alpha), torch.zeros_like(alpha)
        for c in range(max_chunks):
            _, (t_carry, carry_wd) = chunk_values(c, t_carry, carry_wd)
        total_wd, base_s = carry_wd, t_carry * g_dot_bg
    else:
        t_total = 1.0 - alpha  # [T, P, 1]
        total_wd = (
            torch.sum((img - t_total * bgv) * gimg, dim=-1, keepdim=True)
            + depth * gdepth
            + alpha * galpha
        )
        base_s = t_total * g_dot_bg
    dvals = torch.zeros_like(vals)
    t_carry, carry_wd = torch.ones_like(alpha), torch.zeros_like(alpha)
    n_pad = ch16_of(d) - (7 + d)
    for c in range(max_chunks):
        (live, slot, blk, lane_ok, raw, power, dx, dy, one_minus, t_excl, w, dld,
         pre_wd), (t_carry, carry_wd) = chunk_values(c, t_carry, carry_wd)
        s = (total_wd - pre_wd) + base_s
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
        dcol = torch.einsum("tpl,tpd->tdl", w, gimg)
        rows += [dcol[:, j] for j in range(d)]
        rows.append(torch.sum(w * gdepth, dim=1))
        rows += [torch.zeros_like(rows[0])] * n_pad
        dblk = torch.stack(rows, dim=1)  # [T, ch16, 128]
        dvals[slot[live]] = dblk[live]
    return dvals


# ---------------------------------------------------------------------------
# Wrappers: kernel on CUDA tensors, plain twin on CPU tensors
# ---------------------------------------------------------------------------

def _launch_fwd(symbol, meta, vals, bg, ts, n_tx):
    n_tiles, d = meta.shape[1], bg.shape[1]
    p = ts * ts
    img = torch.empty((n_tiles, p, d), dtype=torch.float32, device=vals.device)
    alpha = torch.empty((n_tiles, p, 1), dtype=torch.float32, device=vals.device)
    depth = torch.empty((n_tiles, p, 1), dtype=torch.float32, device=vals.device)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = getattr(kernel_library(), symbol)(
        meta.data_ptr(), vals.data_ptr(), bg.data_ptr(), img.data_ptr(),
        alpha.data_ptr(), depth.data_ptr(), n_tiles, n_tx, n_tiles // bg.shape[0], ts, d,
        stream)
    _launch_check(rc, "tilegrid forward")
    return img, alpha, depth


def tilegrid_forward(meta, vals, bg, ts: int, n_tx: int):
    """Forward compositor. CUDA tensors launch the kernel; CPU tensors run
    composite_tilegrid_plain_fwd."""
    _, d = _check(meta, vals, bg, ts)
    if vals.device.type == "cpu":
        return composite_tilegrid_plain_fwd(meta, vals, bg, ts, n_tx)
    if vals.device.type != "cuda":
        raise ValueError(f"no tile-grid compositor for device {vals.device}")
    out = _launch_fwd("egogs_tilegrid_fwd", meta, vals, bg, ts, n_tx)
    TileGridCompositor.fwd_launches[d] += 1
    return out


def tilegrid_forward_nocull(meta, vals, bg, ts: int, n_tx: int):
    """The forward kernel instantiated with its per-warp cull compiled out
    (CUDA tensors only; not counted). A check instance: its outputs must
    equal tilegrid_forward's bit for bit."""
    _check(meta, vals, bg, ts)
    if vals.device.type != "cuda":
        raise ValueError("the cull-free check instance runs on CUDA tensors only")
    return _launch_fwd("egogs_tilegrid_fwd_nocull", meta, vals, bg, ts, n_tx)


def _launch_bwd(symbol, meta, vals, bg, tensors, ts, n_tx, exact_total):
    dvals = torch.empty_like(vals)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = getattr(kernel_library(), symbol)(
        *(x.data_ptr() for x in (meta, vals, bg, *tensors, dvals)),
        meta.shape[1], n_tx, meta.shape[1] // bg.shape[0], ts, bg.shape[1], int(exact_total),
        stream)
    _launch_check(rc, "tilegrid backward")
    return dvals


def tilegrid_backward(meta, vals, bg, img, alpha, depth, gimg, galpha, gdepth,
                      ts: int, n_tx: int, exact_total: bool = False):
    """Backward compositor -> dvals. CUDA tensors launch the kernel of the
    flavor `exact_total` names (it writes only the slots of tiles in meta);
    CPU tensors run composite_tilegrid_plain_bwd."""
    d = bg.shape[1]
    tensors = (img, alpha, depth, gimg, galpha, gdepth)
    _check(meta, vals, bg, ts, tensors=list(zip(tensors, (d, 1, 1, d, 1, 1))))
    if vals.device.type == "cpu":
        return composite_tilegrid_plain_bwd(meta, vals, bg, *tensors, ts, n_tx, exact_total)
    if vals.device.type != "cuda":
        raise ValueError(f"no tile-grid compositor for device {vals.device}")
    dvals = _launch_bwd("egogs_tilegrid_bwd", meta, vals, bg, tensors, ts, n_tx, exact_total)
    counts = (TileGridCompositor.bwd_exact_launches if exact_total
              else TileGridCompositor.bwd_launches)
    counts[d] += 1
    return dvals


def tilegrid_backward_nocull(meta, vals, bg, img, alpha, depth, gimg, galpha, gdepth,
                             ts: int, n_tx: int, exact_total: bool = False):
    """The backward kernel of either flavor instantiated with its per-warp
    cull compiled out (CUDA tensors only; not counted). A check instance:
    its gradients must equal tilegrid_backward's bit for bit."""
    d = bg.shape[1]
    tensors = (img, alpha, depth, gimg, galpha, gdepth)
    _check(meta, vals, bg, ts, tensors=list(zip(tensors, (d, 1, 1, d, 1, 1))))
    if vals.device.type != "cuda":
        raise ValueError("the cull-free check instance runs on CUDA tensors only")
    return _launch_bwd("egogs_tilegrid_bwd_nocull", meta, vals, bg, tensors, ts, n_tx,
                       exact_total)


class TileGridCompositor(torch.autograd.Function):
    """(meta, vals, bg, ts, n_tx, exact_total) -> (img, alpha, depth) with
    the backward kernel of the chosen flavor as its gradient. Slots past
    the fit count get zero gradient and bg gets a zero gradient, as in the
    JAX VJP.

    fwd_launches, bwd_launches (exact_total=False) and bwd_exact_launches
    count kernel launches per channel count D; the CPU twin path does not
    count."""

    fwd_launches = {d: 0 for d in SUPPORTED_D}
    bwd_launches = {d: 0 for d in SUPPORTED_D}
    bwd_exact_launches = {d: 0 for d in SUPPORTED_D}

    @staticmethod
    def reset_launch_counts():
        for counts in (TileGridCompositor.fwd_launches, TileGridCompositor.bwd_launches,
                       TileGridCompositor.bwd_exact_launches):
            for d in SUPPORTED_D:
                counts[d] = 0

    @staticmethod
    def forward(ctx, meta, vals, bg, ts, n_tx, exact_total=False):
        img, alpha, depth = tilegrid_forward(meta, vals, bg, ts, n_tx)
        ctx.save_for_backward(meta, vals, bg, img, alpha, depth)
        ctx.ts, ctx.n_tx, ctx.exact_total = ts, n_tx, exact_total
        return img, alpha, depth

    @staticmethod
    def backward(ctx, gimg, galpha, gdepth):
        meta, vals, bg, img, alpha, depth = ctx.saved_tensors
        dvals = tilegrid_backward(
            meta, vals, bg, img, alpha, depth,
            gimg.contiguous(), galpha.contiguous(), gdepth.contiguous(),
            ctx.ts, ctx.n_tx, ctx.exact_total)
        # slots of no fitting tile were never written (torch.empty): slot q
        # of scene q // (slots per scene) is written below meta[2] of that
        # scene's tiles
        scenes = bg.shape[0]
        q = torch.arange(dvals.shape[0], device=dvals.device)
        first_tile = (q // (dvals.shape[0] // scenes)) * (meta.shape[1] // scenes)
        fit_end = meta[2].to(torch.int64)[first_tile]
        dvals = torch.where((q < fit_end)[:, None, None], dvals, torch.zeros_like(dvals))
        return None, dvals, torch.zeros_like(bg), None, None, None
