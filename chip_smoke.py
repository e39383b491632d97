#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (one JSON line each; any failure raises, so the exit code is
nonzero and no result line is printed):
  1. device:  requires CUDA; prints the card (nvidia-smi name, power limit)
  2. build:   compiles the nine compositor kernels (tile-grid forward, the
              tile-grid backward in both flavors, the stream pair, the
              chunked and simple windowed pairs) and the FMA-peak probe from
              egogaussian_tpu_torch/csrc, one nvcc per source in parallel,
              into one library
  3. kernels: each kernel against its plain PyTorch twin on the card, at
              D = 3 and 1, tile sizes 16 and 32, on three scenes (60
              Gaussians at 48x32, 2k at 256x192, a kNN-init deep-tile scene
              at 320x240); the exact-total backward also against the
              default one; the tile-grid kernels against themselves with
              the per-warp cull compiled out and both backwards twice, bit
              for bit; a hand-made layout that pins the tile-wide
              saturation vote (render/probe_layouts.py:quadrant_scene);
              the simple windowed pair
              also against the chunked one, and both windowed backwards
              twice, bit for bit; the cuda render (tile-grid and stream)
              against the oracle; the exact-total render's gradients
              within 5e-6
  4. slice:   (path 1) stage-1.0 static training (train_static) on a
              640x480 synthetic video with ~100k Gaussians, shortened
              schedule; launch counters must show the tile-grid kernels
              ran; PLY round trip
  5. coarse:  (path 2) stage-2 coarse object pose (estimate_coarse_obj_pose)
              on the same video with the object model the slice hands
              over, shortened schedule, crop windows on; pose error against
              the video's ground truth; pose npz round trip
  6. flavors: (path 2) the stage-2 step from the coarse stage's final state
              under the default, exact-total and stream tile configs:
              gradients and 20 steps' losses against the default's, and a
              label (D = 1) render gradient per flavor
  7. eval:    (path 3) stage-6 evaluation: the eval CLI on the video
              exported in the reference's dataset layout, with path 1's
              model and path 2's poses filled over every frame, random
              LPIPS weights; then every frame at 640x480 through
              render_results with backend="auto" (the tiled backend) on the
              ~100k-Gaussian kNN model at the ground-truth poses
  8. tiled step: the static step under backend="tiled" against "cuda" on
              that model (std mode D = 3, label mode D = 1): gradients and
              20 steps' losses within FLAVOR_TOL
  9. entry:   (path 4) the simple windowed pair through
              make_tile_compositor, forward and backward, on the full-frame
              windows of that model at frame 0 (D = 3 and 1)
 10. peak:    (row 10's path) the card's float32 FMA rate through
              utils/peak.py:fma_peak_gflops, beside the published 67 TFLOP/s
 11. checks after the paths: path 3's frames against backend="cuda"
              (DEEP_FWD_TOL, 0 dropped pairs), path 4 against the twins and
              the chunked pair, every kernel against its twin at path 2's
              own shapes, the FMA chain against its twin at the peak
              path's shapes (bit for bit) and the SM clock under an FMA load
 12. timing:  kernel vs plain twin (CUDA events) at the slice's shapes
              (rows 1-3 also at 1920x1080), and each kernel's bound (bytes
              over the HBM rate or instructions over the float32
              instruction rate, whichever is larger) on the covered
              evaluations of the same inputs, beside the dense count's
              bound and the bound at the measured FMA rate
 13. profile: torch.profiler over std-mode steps at the slice's size:
              device time by kernel and the device's busy share
              (table in chiprun_out/chip_smoke/profile.txt)
Launch counters are set to 0 just before each path and read just after.
Then the kernel table, the nvidia-smi line, and the result line
{"ok": true, "device": {...}}.

Imports no JAX. Writes its outputs under chiprun_out/chip_smoke/.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

# tolerances of the JAX suite between its own backends
# (tests/test_pallas_raster.py:34-36, :77-79) and, for the kNN deep-tile
# scene, the bound of .claude/skills/verify/SKILL.md
FWD_TOL = {"image": 3e-4, "alpha": 3e-4, "depth": 3e-3}
DEEP_FWD_TOL = {"image": 2.5e-3, "alpha": 5e-4, "depth": 3e-3}
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3

# shortened stage-1.0 schedule of the slice phase (reference: 20k std, 5k
# entropy, 5k label; densify every 100 in (500, 40k]; reset every 3000):
# densify at iterations 100 and 150, one opacity reset at 100, leaving 200
# std iterations for opacities to recover before the loss is judged
SLICE_SCHEDULE = dict(std_train_iter=300, entropy_reg_iter=100, label_train_iter=100,
                      densify_from_iter=50, densify_until_iter=199)
SLICE_OPT = dict(densification_interval=50, opacity_reset_interval=100)
# the bench's operating point: 640x480, ~100k Gaussians
SLICE_VIDEO = dict(width=640, height=480, n_bg=100_000, n_obj=2_000, frames_static=12)
STEADY_SKIP = 20  # std iterations left out of the it/s figure
# kNN-initialized cloud (broad low-alpha splats, many pairs near the alpha
# threshold) dense enough for ~2k-deep tiles at 320x240: the bench's knn
# check scene with 20x the Gaussians
KNN_SCENE = dict(width=320, height=240, n_bg=40_000, n_obj=4_000, frames_static=2,
                 frames_dynamic=1, seed=7)
# stage-2 schedule cut from 30k to 200 iterations per frame (reference:
# warm-up 20k, densify (20.5k, 25.5k) every 500, object opacity reset every
# 2.5k), keeping the warm-up, the densify window and one object opacity
# reset inside it
COARSE_SCHEDULE = dict(warm_up_iter=100, total_num_iter=200, densify_from_iter=120,
                       densify_until_iter=180, densification_interval=20,
                       opacity_reset_interval=150)
# the pose trains only on current-frame iterations outside the densify
# window (~55 of the 200); at the reference's 1e-4 Adam moves it at most
# ~0.006 per frame against a ground-truth step of 0.126 (translation) and
# 0.12 rad, so the cut schedule raises the pose learning rates 20x
COARSE_OPT = dict(obj_translation_lr=2e-3, obj_rotation_lr=2e-3)
# stage 2's object model: the slice's trained Gaussians inside the
# ground-truth object's rest-pose box, widened by this margin (the init
# points carry 0.02 noise). The slice's 100 label iterations at the
# reference label_lr (tuned for 30k) move labels ~0.1, so none crosses the
# 0.5 object threshold and the label segmentation hands over nothing.
OBJECT_BOX_MARGIN = 0.1
# fewest object Gaussians the handover must give stage 2
MIN_OBJECT_GAUSSIANS = 50
FLAVOR_STEPS = 20
FLAVOR_TOL = 1e-3  # norm-relative gradient error and relative loss error


PHASE_LOG = []  # path of the run's phases.jsonl, once main has made out_dir


def emit(phase: str, **fields) -> None:
    line = json.dumps({"phase": phase, **fields})
    print(line, flush=True)
    for path in PHASE_LOG:
        with open(path, "a") as f:
            f.write(line + "\n")


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_scene(n: int, seed: int, dev):
    """The JAX suite's random test scene shape (tests/test_render.py)."""
    import torch

    from egogaussian_tpu_torch.ops.covariance import covariance_from_scaling_rotation

    rng = np.random.RandomState(seed)
    t = lambda x: torch.as_tensor(x.astype(np.float32), device=dev)  # noqa: E731
    means = t(rng.randn(n, 3))
    scales = t(np.exp(rng.randn(n, 3) * 0.3 - 2.5))
    cov3d = covariance_from_scaling_rotation(scales, t(rng.randn(n, 4)))
    colors = t(rng.rand(n, 3))
    ops = t(rng.uniform(0.3, 0.95, n))
    return means, cov3d, colors, ops


def look_at_camera(width: int, height: int, dev, focal: float = 60.0):
    from egogaussian_tpu_torch.render.camera import Camera, look_at

    R, t = look_at(np.array([0.0, 0.0, -4.0]), np.zeros(3))
    return Camera.from_colmap(R, t, focal, focal, width, height, device=dev)


def check_layout(name, lay, colors_d, bg, tol, width, height, errs):
    """Kernel fwd + bwd vs plain twins on one layout; records max errors."""
    import torch

    from egogaussian_tpu_torch.render import cuda_raster as cr
    from egogaussian_tpu_torch.render.tiled import _untile

    d = colors_d
    meta, vals = lay.meta, lay.vals.detach().contiguous()
    ts, n_tx, n_ty = lay.tile_size, lay.n_tx, lay.n_ty
    bg2 = bg[None].contiguous()
    k_out = cr.tilegrid_forward(meta, vals, bg2, ts, n_tx)
    p_out = cr.composite_tilegrid_plain_fwd(meta, vals, bg2, ts, n_tx)
    fwd_err = {}
    for key, k, p in zip(("image", "alpha", "depth"), k_out, p_out):
        fwd_err[key] = float((k - p).abs().max())
    # cotangents: the JAX suite's test loss on the twin's outputs
    gen = torch.Generator(device=vals.device).manual_seed(7)
    target = torch.rand((d, height, width), generator=gen, device=vals.device)
    outs = [x.detach().requires_grad_(True) for x in p_out]
    img = _untile(outs[0], n_tx, n_ty, ts, width, height)
    alpha = _untile(outs[1], n_tx, n_ty, ts, width, height)
    depth = _untile(outs[2], n_tx, n_ty, ts, width, height)
    loss = (torch.mean((img - target) ** 2) + 0.3 * torch.mean(alpha)
            + 0.1 * torch.mean(depth))
    gi, ga, gd = torch.autograd.grad(loss, outs)
    saved = [x.detach() for x in p_out]
    k_d = cr.tilegrid_backward(meta, vals, bg2, *saved, gi, ga, gd, ts, n_tx)
    p_d = cr.composite_tilegrid_plain_bwd(meta, vals, bg2, *saved, gi, ga, gd, ts, n_tx)
    k_e = cr.tilegrid_backward(meta, vals, bg2, *saved, gi, ga, gd, ts, n_tx, exact_total=True)
    p_e = cr.composite_tilegrid_plain_bwd(meta, vals, bg2, *saved, gi, ga, gd, ts, n_tx,
                                          exact_total=True)
    fit = int(meta[2, 0])
    k_d, p_d, k_e, p_e = k_d[:fit], p_d[:fit], k_e[:fit], p_e[:fit]
    grad_err = max_err(k_d, p_d)
    exact_err = max_err(k_e, p_e)
    # the two flavors compute the same gradient up to the total's rounding
    flavor_err = max_err(k_e, k_d)
    # what tells the flavors apart: the exact one rebuilds nothing from the
    # saved outputs, so zeroing them leaves its gradient bit-identical,
    # while the default's total and base_S move
    zeros = [torch.zeros_like(x) for x in saved]
    k_e0 = cr.tilegrid_backward(meta, vals, bg2, *zeros, gi, ga, gd, ts, n_tx,
                                exact_total=True)[:fit]
    k_d0 = cr.tilegrid_backward(meta, vals, bg2, *zeros, gi, ga, gd, ts, n_tx)[:fit]
    flavors_apart = torch.equal(k_e0, k_e) and (fit == 0 or not torch.equal(k_d0, k_d))
    same = cull_and_repeat(meta, vals, bg2, k_out, saved, (gi, ga, gd), k_d, k_e, ts, n_tx)
    ok = (all(fwd_err[k] <= tol[k] for k in tol) and flavors_apart and all(same.values())
          and all(grad_excess(a, b) <= 0.0 for a, b in ((k_d, p_d), (k_e, p_e), (k_e, k_d))))
    depth_max = int(meta[1].max())
    emit("kernel_check", case=name, d=d, tile_size=ts, fwd_err=fwd_err,
         grad_max_abs_err=grad_err, exact_grad_max_abs_err=exact_err,
         exact_vs_default_max_abs_err=flavor_err, exact_ignores_saved_outputs=flavors_apart,
         bit_identical=same, grad_scale=float(p_d.abs().max()) if fit else 0.0,
         deepest_tile=depth_max, ok=ok)
    if not ok:
        raise AssertionError(f"kernel vs twin out of tolerance: {name} d={d} ts={ts}")
    errs.setdefault(("fwd", d), []).append(max(fwd_err.values()))
    errs.setdefault(("bwd", d), []).append(grad_err)
    errs.setdefault(("bwd_exact", d), []).append(exact_err)
    return gi, ga, gd


def cull_and_repeat(meta, vals, bg2, k_out, saved, cots, k_d, k_e, ts, n_tx):
    """The tile-grid kernels' exactness checks on one layout: the forward
    and both backward flavors against the same kernels with the per-warp
    cull compiled out (bit for bit), and both backwards run again (bit for
    bit). k_d, k_e: the default and exact-total gradients of the fitting
    slots."""
    import torch

    from egogaussian_tpu_torch.render import cuda_raster as cr

    fit = k_d.shape[0]
    n_out = cr.tilegrid_forward_nocull(meta, vals, bg2, ts, n_tx)
    n_d = cr.tilegrid_backward_nocull(meta, vals, bg2, *saved, *cots, ts, n_tx)[:fit]
    n_e = cr.tilegrid_backward_nocull(meta, vals, bg2, *saved, *cots, ts, n_tx,
                                      exact_total=True)[:fit]
    r_d = cr.tilegrid_backward(meta, vals, bg2, *saved, *cots, ts, n_tx)[:fit]
    r_e = cr.tilegrid_backward(meta, vals, bg2, *saved, *cots, ts, n_tx, exact_total=True)[:fit]
    return {"fwd_cull_off": all(torch.equal(a, b) for a, b in zip(k_out, n_out)),
            "bwd_cull_off": torch.equal(k_d, n_d), "bwd_exact_cull_off": torch.equal(k_e, n_e),
            "bwd_repeat": torch.equal(k_d, r_d), "bwd_exact_repeat": torch.equal(k_e, r_e)}


def check_quadrant_vote(dev, errs):
    """The tile-grid kernels on render/probe_layouts.py:quadrant_scene at
    D = 3 and 1: outputs and both backward flavors against the twins; the
    later chunks' gradient rows zero exactly where the twin's are (tile
    0's quadrant-only splats nonzero, tile 1's skipped chunk all zeros);
    cull-off and repeat bit for bit."""
    import torch

    from egogaussian_tpu_torch.render import cuda_raster as cr
    from egogaussian_tpu_torch.render.probe_layouts import quadrant_scene

    for d in (3, 1):
        meta, vals, bg, n_tx, _, _ = (torch.as_tensor(x, device=dev) if isinstance(x, np.ndarray)
                                      else x for x in quadrant_scene(d))
        k_out = cr.tilegrid_forward(meta, vals, bg, 32, n_tx)
        p_out = cr.composite_tilegrid_plain_fwd(meta, vals, bg, 32, n_tx)
        fwd_err = {k: max_err(a, b) for k, a, b in zip(("image", "alpha", "depth"), k_out, p_out)}
        gen = torch.Generator(device=dev).manual_seed(3)
        cots = [torch.randn(x.shape, generator=gen, device=dev) * 1e-3 for x in p_out]
        saved = [x.detach() for x in p_out]
        res, grads = {}, {}
        for exact in (False, True):
            k_d = cr.tilegrid_backward(meta, vals, bg, *saved, *cots, 32, n_tx, exact_total=exact)
            p_d = cr.composite_tilegrid_plain_bwd(meta, vals, bg, *saved, *cots, 32, n_tx,
                                                  exact_total=exact)
            later = k_d[[2, 4]], p_d[[2, 4]]
            res["exact" if exact else "default"] = dict(
                grad_ok=grad_excess(k_d, p_d) <= 0.0, grad_max_abs_err=max_err(k_d, p_d),
                zero_pattern_equal=torch.equal(later[0] == 0, later[1] == 0),
                quadrant_rows_nonzero=bool((p_d[2, :7 + d, :20] != 0).any(dim=0).all()),
                skipped_chunk_zero=bool((k_d[4] == 0).all()))
            errs.setdefault(("bwd_exact" if exact else "bwd", d), []).append(max_err(k_d, p_d))
            grads[exact] = k_d
        same = cull_and_repeat(meta, vals, bg, k_out, saved, cots, grads[False], grads[True], 32,
                               n_tx)
        ok = (all(fwd_err[k] <= FWD_TOL[k] for k in FWD_TOL) and all(same.values())
              and all(v for r in res.values() for k, v in r.items() if k != "grad_max_abs_err"))
        emit("quadrant_vote_check", d=d, fwd_err=fwd_err, flavors=res, bit_identical=same,
             ok=ok)
        if not ok:
            raise AssertionError(f"quadrant saturation scene: kernel differs from twin (d={d})")
        errs.setdefault(("fwd", d), []).append(max(fwd_err.values()))


def max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def grad_excess(a, b) -> float:
    """Largest excess of |a - b| over the gradient tolerance (<= 0: ok)."""
    if not a.numel():
        return -1.0
    return float(((a - b).abs() - (GRAD_ATOL + GRAD_RTOL * b.abs())).max())


def check_stream(name, lay, cots, colors_d, bg, tol, errs):
    """Stream kernel pair vs plain twins on one layout. The forward is
    compared on the tiles that own a slot (the kernel leaves the others
    unwritten, as the TPU kernel does); the backward on every slot."""
    from egogaussian_tpu_torch.render import stream_raster as sr

    d = colors_d
    meta, vals = lay.meta, lay.vals.detach().contiguous()
    ts, n_tx = lay.tile_size, lay.n_tx
    n_tiles = lay.n_tx * lay.n_ty
    bg2 = bg[None].contiguous()
    k_out = sr.stream_forward(meta, vals, bg2, ts, n_tx, n_tiles)
    p_out = sr.composite_stream_plain_fwd(meta, vals, bg2, ts, n_tx, n_tiles)
    owned = ~lay.empty
    fwd_err = {key: max_err(k[owned], p[owned])
               for key, k, p in zip(("image", "alpha", "depth", "logT"), k_out, p_out)}
    k_d = sr.stream_backward(meta, vals, bg2, p_out[3], *cots, ts, n_tx)
    p_d = sr.composite_stream_plain_bwd(meta, vals, bg2, p_out[3], *cots, ts, n_tx)
    grad_err = max_err(k_d, p_d)
    fwd_tol = dict(tol, logT=tol["image"])
    ok = all(fwd_err[k] <= fwd_tol[k] for k in fwd_tol) and grad_excess(k_d, p_d) <= 0.0
    emit("stream_check", case=name, d=d, tile_size=ts, fwd_err=fwd_err,
         grad_max_abs_err=grad_err, grad_scale=float(p_d.abs().max()),
         slots=int(meta.shape[1]), ok=ok)
    if not ok:
        raise AssertionError(f"stream kernel vs twin out of tolerance: {name} d={d} ts={ts}")
    errs.setdefault(("stream_fwd", d), []).append(max(fwd_err.values()))
    errs.setdefault(("stream_bwd", d), []).append(grad_err)


def split_window(lay):
    """The simple windowed kernels' five inputs from a chunked window:
    (mu, con, op, col, z), op zeroed at and past each tile's count."""
    import torch

    data = lay.data.detach()
    d = data.shape[2] - 7
    rows = torch.arange(data.shape[1], device=data.device)
    live = (rows[None, :] < lay.counts[:, None].long())[..., None]
    op = torch.where(live, data[..., 5:6], torch.zeros_like(data[..., 5:6]))
    return tuple(x.contiguous() for x in (data[..., 0:2], data[..., 2:5], op,
                                          data[..., 6:6 + d], data[..., 6 + d:7 + d]))


def window_cotangents(outs, lay, d, width, height):
    """Cotangents of the JAX suite's test loss at the outputs `outs`
    (img, alpha, depth per tile), as check_layout takes them."""
    import torch

    from egogaussian_tpu_torch.render.tiled import _untile

    gen = torch.Generator(device=outs[0].device).manual_seed(7)
    target = torch.rand((d, height, width), generator=gen, device=outs[0].device)
    leaves = [x.detach().requires_grad_(True) for x in outs]
    img, alpha, depth = (_untile(x, lay.n_tx, lay.n_ty, lay.tile_size, width, height)
                         for x in leaves)
    loss = (torch.mean((img - target) ** 2) + 0.3 * torch.mean(alpha)
            + 0.1 * torch.mean(depth))
    return torch.autograd.grad(loss, leaves)


def check_window(name, lay, bg, tol, width, height, errs):
    """The four windowed kernels on one window (window_layout): each against
    its plain twin (forward within `tol`, gradients within GRAD_ATOL +
    GRAD_RTOL), each backward run twice and bit-identical, and the simple
    pair against the chunked pair on the same window (forward within `tol`,
    gradients within FLAVOR_TOL norm-relative: the simple backward takes
    the suffix as total - prefix, the chunked one sums it)."""
    import torch

    from egogaussian_tpu_torch.render import window_raster as wr

    counts, data = lay.counts, lay.data.detach().contiguous()
    d, ts, n_tx = data.shape[2] - 7, lay.tile_size, lay.n_tx
    bg2 = bg[None].contiguous()
    twin_batch = 16  # bounds the twins' [B, P, rows] temporaries on the card
    k_out = wr.window_chunked_forward(counts, data, bg2, ts, n_tx)
    p_out = wr.composite_window_chunked_plain_fwd(counts, data, bg2, ts, n_tx, twin_batch)
    keys = ("image", "alpha", "depth", "logT")
    fwd_err = {k: max_err(a, b) for k, a, b in zip(keys, k_out, p_out)}
    cots = window_cotangents(p_out[:3], lay, d, width, height)
    k_d = wr.window_chunked_backward(counts, data, bg2, p_out[3], *cots, ts, n_tx)
    k_d2 = wr.window_chunked_backward(counts, data, bg2, p_out[3], *cots, ts, n_tx)
    p_d = wr.composite_window_chunked_plain_bwd(counts, data, bg2, p_out[3], *cots, ts, n_tx,
                                                twin_batch)
    parts = split_window(lay)
    ks_out = wr.window_forward(*parts, bg2, ts, n_tx)
    ps_out = wr.composite_window_plain_fwd(*parts, bg2, ts, n_tx, twin_batch)
    sfwd_err = {k: max_err(a, b) for k, a, b in zip(keys, ks_out, ps_out)}
    ks_d = torch.cat(wr.window_backward(*parts, bg2, *cots, ts, n_tx), dim=2)
    ks_d2 = torch.cat(wr.window_backward(*parts, bg2, *cots, ts, n_tx), dim=2)
    ps_d = torch.cat(wr.composite_window_plain_bwd(*parts, bg2, *cots, ts, n_tx, twin_batch),
                     dim=2)
    cross_fwd = {k: max_err(a, b) for k, a, b in zip(keys, ks_out, k_out)}
    cross_grad = norm_rel(ks_d, k_d)
    fwd_tol = dict(tol, logT=tol["image"])
    repeat = torch.equal(k_d, k_d2) and torch.equal(ks_d, ks_d2)
    ok = (all(fwd_err[k] <= fwd_tol[k] for k in fwd_tol)
          and all(sfwd_err[k] <= tol[k] for k in tol)
          and all(cross_fwd[k] <= tol[k] for k in tol)
          and grad_excess(k_d, p_d) <= 0.0 and grad_excess(ks_d, ps_d) <= 0.0
          and cross_grad <= FLAVOR_TOL and repeat)
    emit("window_check", case=name, d=d, tile_size=ts, window_rows=data.shape[1],
         deepest_tile=int(counts.max()), chunked_fwd_err=fwd_err,
         chunked_grad_max_abs_err=max_err(k_d, p_d), simple_fwd_err=sfwd_err,
         simple_grad_max_abs_err=max_err(ks_d, ps_d), simple_vs_chunked_fwd_err=cross_fwd,
         simple_vs_chunked_grad_norm_rel=cross_grad, grad_scale=float(p_d.abs().max()),
         backward_repeats_bit_for_bit=repeat, ok=ok)
    if not ok:
        raise AssertionError(f"windowed kernels out of tolerance: {name} d={d} ts={ts}")
    errs.setdefault(("window_chunked_fwd", d), []).append(max(fwd_err.values()))
    errs.setdefault(("window_chunked_bwd", d), []).append(max_err(k_d, p_d))
    errs.setdefault(("window_fwd", d), []).append(max(sfwd_err.values()))
    errs.setdefault(("window_bwd", d), []).append(max_err(ks_d, ps_d))
    return cots


def render_vs_oracle(case, cam, scene, bg, cfg, grad_atol=None):
    """The cuda render with tile config `cfg` against the oracle: forward
    errors within FWD_TOL; with grad_atol, gradients of the JAX suite's
    test loss w.r.t. means, colors and opacities within grad_atol."""
    import torch

    from egogaussian_tpu_torch.render.api import render

    means, cov3d, colors, ops = scene
    target = torch.rand((3, cam.height, cam.width),
                        generator=torch.Generator(device=means.device).manual_seed(9),
                        device=means.device)

    def run(backend):
        args = [x.clone().requires_grad_(True) for x in (means, colors, ops)]
        r = render(cam, args[0], cov3d, args[2], bg, colors_precomp=args[1], backend=backend,
                   tile_config=cfg)
        loss = (torch.mean((r.image - target) ** 2) + 0.1 * torch.mean(r.alpha)
                + 0.01 * torch.mean(r.depth))
        return r, torch.autograd.grad(loss, args)

    rk, gk = run("cuda")
    ro, go = run("oracle")
    err = {k: max_err(getattr(rk, k).detach(), getattr(ro, k).detach())
           for k in ("image", "alpha", "depth")}
    ok = all(err[k] <= FWD_TOL[k] for k in FWD_TOL)
    grad_err = max(max_err(a, b) for a, b in zip(gk, go))
    if grad_atol is not None:
        ok = ok and grad_err <= grad_atol
    emit("kernel_vs_oracle", case=case, compositor=cfg.compositor,
         bwd_exact_total=cfg.bwd_exact_total, err=err, grad_max_abs_err=grad_err,
         grad_atol=grad_atol, ok=ok)
    if not ok:
        raise AssertionError(f"cuda render vs oracle out of tolerance: {case}")


def phase_kernels(dev, errs):
    import dataclasses as dc

    import torch

    from egogaussian_tpu_torch.data.synthetic import make_synthetic_video
    from egogaussian_tpu_torch.models.gaussians import from_points
    from egogaussian_tpu_torch.ops.covariance import covariance_from_scaling_rotation
    from egogaussian_tpu_torch.render.camera import Camera, look_at
    from egogaussian_tpu_torch.render.project import project_gaussians
    from egogaussian_tpu_torch.render.tiled import (
        TileConfig,
        stream_layout,
        tilegrid_layout,
        window_layout,
    )
    from egogaussian_tpu_torch.train.common import auto_tile_config, model_colors

    def scene_cases(name, cam, means, cov3d, colors, ops, cfg_of, tol):
        proj = project_gaussians(means, cov3d, cam.viewmat, cam.fx, cam.fy, cam.cx,
                                 cam.cy, cam.width, cam.height)
        labels = torch.as_tensor(
            np.random.RandomState(3).randn(means.shape[0], 1).astype(np.float32), device=dev)
        for ts in (16, 32):
            cfg = cfg_of(ts)
            for d, cols, bg in ((3, colors, torch.tensor([0.2, 0.1, 0.4], device=dev)),
                                (1, labels, torch.zeros(1, device=dev))):
                lay = tilegrid_layout(proj, cols, ops, cam.width, cam.height, cfg)
                slay = stream_layout(proj, cols, ops, cam.width, cam.height,
                                     dc.replace(cfg, compositor="stream"))
                if int(lay.dropped) or int(slay.dropped):
                    raise AssertionError(f"{name}: pairs dropped in the check scene")
                cots = check_layout(name, lay, d, bg, tol, cam.width, cam.height, errs)
                check_stream(name, slay, cots, d, bg, tol, errs)
                wlay = window_layout(proj, cols, ops, cam.width, cam.height, cfg)
                if int(wlay.dropped):
                    raise AssertionError(f"{name}: pairs dropped in the check window")
                check_window(name, wlay, bg, tol, cam.width, cam.height, errs)

    # 0) the tile-wide saturation vote, pinned on a hand-made layout
    check_quadrant_vote(dev, errs)
    # 1) 60 Gaussians at 48x32 (tests/test_pallas_raster.py:23-36)
    cam = look_at_camera(48, 32, dev)
    means, cov3d, colors, ops = random_scene(60, 11, dev)
    small_cfg = lambda ts: TileConfig(max_per_tile=256, max_pairs=8192, tile_size=ts)  # noqa: E731
    scene_cases("random60_48x32", cam, means, cov3d, colors, ops, small_cfg, FWD_TOL)
    # the cuda render against the port's oracle on the same scene: the
    # tile-grid forward, the stream forward and gradients
    bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
    render_vs_oracle("random60_48x32", cam, (means, cov3d, colors, ops), bg, small_cfg(16))
    render_vs_oracle("random60_48x32", cam, (means, cov3d, colors, ops), bg,
                     dc.replace(small_cfg(16), compositor="stream"), grad_atol=GRAD_ATOL)
    # the exact-total render on the JAX suite's 64x48 / 300-Gaussian scene
    # (tests/test_pallas_raster.py:301-347): gradients within 5e-6
    rng = np.random.RandomState(0)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    ex_means = t(rng.randn(300, 3))
    ex_cov = covariance_from_scaling_rotation(t(np.exp(rng.randn(300, 3) * 0.3 - 1.6)),
                                              t(rng.randn(300, 4)))
    ex_scene = (ex_means, ex_cov, t(rng.rand(300, 3)), t(rng.uniform(0.3, 0.99, 300)))
    R, tr = look_at(np.array([0.0, 0.0, -4.0]), np.zeros(3))
    ex_cam = Camera.from_colmap(R, tr, 60.0, 60.0, 64, 48, device=dev)
    render_vs_oracle("random300_64x48", ex_cam, ex_scene, t([0.2, 0.1, 0.3]),
                     TileConfig(max_pairs=16384, max_per_tile=1024, max_slots=16384,
                                bwd_exact_total=True), grad_atol=5e-6)
    # the windowed kernels on the same scene (tiles up to ~200 rows deep)
    ex_proj = project_gaussians(ex_means, ex_cov, ex_cam.viewmat, ex_cam.fx, ex_cam.fy,
                                ex_cam.cx, ex_cam.cy, 64, 48)
    for ts in (16, 32):
        for d, bg in ((3, t([0.2, 0.1, 0.3])), (1, torch.zeros(1, device=dev))):
            wlay = window_layout(ex_proj, ex_scene[2][:, :d].contiguous(), ex_scene[3], 64, 48,
                                 TileConfig(max_pairs=16384, max_per_tile=1024, tile_size=ts))
            check_window("random300_64x48", wlay, bg, FWD_TOL, 64, 48, errs)

    # 2) 2k Gaussians at 256x192
    cam = look_at_camera(256, 192, dev, focal=240.0)
    means, cov3d, colors, ops = random_scene(2000, 12, dev)
    mid_cfg = lambda ts: TileConfig(max_per_tile=2048, max_pairs=262144, tile_size=ts)  # noqa: E731
    scene_cases("random2k_256x192", cam, means, cov3d, colors, ops, mid_cfg, FWD_TOL)

    # 3) kNN-init deep tiles at 320x240 (the bench's knn check scene)
    vid = make_synthetic_video(dev, **KNN_SCENE)
    model = from_points(vid.points, vid.colors, dev, spatial_lr_scale=1.2, seed=0)
    cam = vid.cameras[0]
    opac = torch.where(model.aux.alive, model.opacity, torch.zeros_like(model.opacity))
    knn_cfg = lambda ts: auto_tile_config(model, cam, tile_size=ts)  # noqa: E731
    scene_cases("knn_deep_320x240", cam, model.params.xyz, model.covariance(),
                model_colors(model), opac, knn_cfg, DEEP_FWD_TOL)


def nerfpp_radius(cameras) -> float:
    centers = np.stack([c.camera_center.cpu().numpy() for c in cameras])
    r = float(np.linalg.norm(centers - centers.mean(axis=0), axis=1).max()) * 1.1
    return r if r > 0 else 1.0


def phase_slice(dev, out_dir):
    import torch

    from egogaussian_tpu_torch.config import Config
    from egogaussian_tpu_torch.data import make_synthetic_video, split_viewpoints_by_phase
    from egogaussian_tpu_torch.models.gaussians import load_ply, save_ply
    from egogaussian_tpu_torch.render.cuda_raster import TileGridCompositor
    from egogaussian_tpu_torch.train.static import train_static

    t0 = time.time()
    vid = make_synthetic_video(dev, seed=0, **SLICE_VIDEO)
    torch.cuda.synchronize()
    emit("slice_data", width=vid.cameras[0].width, height=vid.cameras[0].height,
         gaussians=len(vid.points),
         frames=len(vid.cameras), seconds=time.time() - t0)

    cfg = Config()
    cfg.static = dataclasses.replace(cfg.static, **SLICE_SCHEDULE)
    cfg.opt = dataclasses.replace(cfg.opt, **SLICE_OPT)
    groups = split_viewpoints_by_phase(vid.cameras, vid.static_phases)
    extent = nerfpp_radius(vid.cameras)

    losses = []
    clock = {}

    def on_step(it, mode, loss):
        losses.append((it, mode, loss))
        if it in (STEADY_SKIP, cfg.static.std_train_iter):
            torch.cuda.synchronize()
            clock[it] = time.perf_counter()

    TileGridCompositor.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = train_static(vid.cameras, vid.points, vid.colors, cfg, groups, extent,
                       save_dir=out_dir, seed=0, first_phase_only=True, device=dev,
                       on_step=on_step)[0]
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {"fwd": dict(TileGridCompositor.fwd_launches),
                "bwd": dict(TileGridCompositor.bwd_launches)}
    peak = torch.cuda.max_memory_allocated()

    per_mode = {}
    for it, mode, loss in losses:
        m = per_mode.setdefault(mode, {"first": (it, float(loss))})
        m["last"] = (it, float(loss))
    std = np.array([float(l) for _, m, l in losses if m == "std"])
    steady_its = cfg.static.std_train_iter - STEADY_SKIP
    it_s = steady_its / (clock[cfg.static.std_train_iter] - clock[STEADY_SKIP])
    model = res.model
    finite = all(bool(torch.isfinite(v).all()) for v in model.params.as_dict().values())
    emit("slice", schedule=SLICE_SCHEDULE, opt=SLICE_OPT, cameras_extent=extent,
         loss=per_mode, alive=int(model.num_alive), capacity=model.capacity,
         dropped_pairs=res.dropped_pairs, launches=launches,
         std_it_per_s=it_s, std_steady_iters=steady_its, train_seconds=seconds,
         max_memory_allocated=peak, params_finite=finite,
         pred_masks=len(res.pred_masks))
    if not finite:
        raise AssertionError("non-finite parameters after training")
    if not std[-10:].mean() < std[:10].mean():
        raise AssertionError(f"std-mode loss did not fall: {std[:10].mean()} -> {std[-10:].mean()}")
    for kind in ("fwd", "bwd"):
        for d, n in launches[kind].items():
            if n <= 0:
                raise AssertionError(f"tilegrid {kind} kernel (D={d}) never launched on the main path")
    if res.dropped_pairs:
        raise AssertionError(f"{res.dropped_pairs} pairs dropped on the main path")
    hw = (vid.cameras[0].height, vid.cameras[0].width)
    shapes_ok = all(m.shape == hw for m in res.pred_masks.values())
    if not shapes_ok:
        raise AssertionError("predicted masks have the wrong shape")

    # PLY round trip: params of the alive rows must come back bit-identical
    path = os.path.join(out_dir, "roundtrip.ply")
    save_ply(model, path)
    back = load_ply(path, dev, sh_degree=model.sh_degree)
    idx = torch.nonzero(model.aux.alive).flatten()
    n = idx.numel()
    identical = all(
        torch.equal(getattr(model.params, k)[idx], getattr(back.params, k)[:n])
        for k in model.params.as_dict())
    emit("ply_roundtrip", path=path, gaussians=int(n), bit_identical=identical)
    if not identical:
        raise AssertionError("PLY round trip changed parameters")
    return vid, extent, launches, res.model


def launch_counts():
    """Every kernel's launch counter, keyed by the kernels-line name."""
    from egogaussian_tpu_torch.render.cuda_raster import TileGridCompositor as tg
    from egogaussian_tpu_torch.render.stream_raster import StreamCompositor as st
    from egogaussian_tpu_torch.render.window_raster import WindowChunkedCompositor as wc
    from egogaussian_tpu_torch.render.window_raster import WindowCompositor as ws

    from egogaussian_tpu_torch.utils.peak import FmaChain

    out = {"fma_peak": FmaChain.launches}
    for d in (3, 1):
        out[f"tilegrid_fwd_d{d}"] = tg.fwd_launches[d]
        out[f"tilegrid_bwd_d{d}"] = tg.bwd_launches[d]
        out[f"tilegrid_bwd_exact_d{d}"] = tg.bwd_exact_launches[d]
        out[f"stream_fwd_d{d}"] = st.fwd_launches[d]
        out[f"stream_bwd_d{d}"] = st.bwd_launches[d]
        out[f"window_chunked_fwd_d{d}"] = wc.fwd_launches[d]
        out[f"window_chunked_bwd_d{d}"] = wc.bwd_launches[d]
        out[f"window_fwd_d{d}"] = ws.fwd_launches[d]
        out[f"window_bwd_d{d}"] = ws.bwd_launches[d]
    return out


def reset_launch_counts():
    from egogaussian_tpu_torch.render.cuda_raster import TileGridCompositor
    from egogaussian_tpu_torch.render.stream_raster import StreamCompositor
    from egogaussian_tpu_torch.render.window_raster import WindowChunkedCompositor, WindowCompositor
    from egogaussian_tpu_torch.utils.peak import FmaChain

    for fn in (TileGridCompositor, StreamCompositor, WindowChunkedCompositor, WindowCompositor,
               FmaChain):
        fn.reset_launch_counts()


def coarse_config():
    from egogaussian_tpu_torch.config import Config

    cfg = Config()
    cfg.coarse = dataclasses.replace(cfg.coarse, **COARSE_SCHEDULE)
    cfg.opt = dataclasses.replace(cfg.opt, **COARSE_OPT)
    return cfg


def pose_errors(T, T_gt, points):
    """Errors of poses T [F,4,4] against ground truth T_gt [F,4,4] (numpy):
    rotation (degrees), translation, and ADD, the mean distance between
    the object's rest-pose points moved by each (Hinterstoisser et al.,
    ACCV 2012), which weighs rotation by the object's extent."""
    rel = np.einsum("fji,fjk->fik", T[:, :3, :3], T_gt[:, :3, :3])
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) * 0.5, -1.0, 1.0)
    trans = np.linalg.norm(T[:, :3, 3] - T_gt[:, :3, 3], axis=1)

    def move(M):
        return np.einsum("fij,nj->fni", M[:, :3, :3], points) + M[:, None, :3, 3]

    add = np.linalg.norm(move(T) - move(T_gt), axis=2).mean(axis=1)
    return np.degrees(np.arccos(cos)), trans, add


def object_handover(model, vid, split=True):
    """The object-only model stage 2 starts from: the slice's trained
    Gaussians inside the ground-truth object's rest-pose box (static phase
    0 sees the object at rest), widened by OBJECT_BOX_MARGIN. With
    split=False, the whole model with is_object set by that box."""
    import torch

    from egogaussian_tpu_torch.models.gaussians import split_by_is_object

    pts = vid.gt_means[vid.gt_is_object]
    lo = torch.as_tensor(pts.min(axis=0) - OBJECT_BOX_MARGIN, device=model.device)
    hi = torch.as_tensor(pts.max(axis=0) + OBJECT_BOX_MARGIN, device=model.device)
    xyz = model.params.xyz
    inside = torch.all((xyz >= lo) & (xyz <= hi), dim=1).to(torch.int32)
    model = dataclasses.replace(model, aux=dataclasses.replace(model.aux, is_object=inside))
    return split_by_is_object(model)[0] if split else model


def phase_coarse(dev, vid, extent, obj_model, out_dir):
    """Stage 2 on the slice's video with the object model handed over from
    the slice. Pose errors of the accumulated object pose (the object's
    pose at each frame) and of the per-frame delta, against the video's
    ground truth; the identity's errors beside them. The run counters come
    from the stage's closing metrics record."""
    import torch

    from egogaussian_tpu_torch.data import split_viewpoints_by_phase
    from egogaussian_tpu_torch.models.pose import load_pose_sequence
    from egogaussian_tpu_torch.render.cuda_raster import TileGridCompositor
    from egogaussian_tpu_torch.train.coarse_pose import estimate_coarse_obj_pose
    from egogaussian_tpu_torch.utils.logging import MetricsLogger, set_active_logger

    n_obj = int(obj_model.num_alive)
    if n_obj < MIN_OBJECT_GAUSSIANS:
        raise AssertionError(f"the handover gave stage 2 {n_obj} object Gaussians")
    cfg = coarse_config()
    static_g = split_viewpoints_by_phase(vid.cameras, vid.static_phases)
    dyn_g = split_viewpoints_by_phase(vid.cameras, vid.dynamic_phases)
    losses = {}

    def on_step(frame, it, loss):
        losses.setdefault(frame, []).append(loss)

    save_dir = os.path.join(out_dir, "coarse")
    log_dir = os.path.join(save_dir, "metrics")
    logger = MetricsLogger(log_dir=log_dir)
    set_active_logger(logger)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        seq, model, solved = estimate_coarse_obj_pose(
            vid.cameras, obj_model, cfg, static_g, dyn_g, extent, save_dir=save_dir, seed=0,
            device=dev, on_step=on_step)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        set_active_logger(None)
        logger.close()
    with open(os.path.join(log_dir, "metrics.jsonl")) as fh:
        stats = [r for r in map(json.loads, fh) if r.get("event") == "stage_end"][-1]
    peak = torch.cuda.max_memory_allocated()
    launches = {"fwd": TileGridCompositor.fwd_launches[3], "bwd": TileGridCompositor.bwd_launches[3]}

    frames = sorted(solved)
    dyn = [f for f in frames if f in dyn_g[0]]
    pts = vid.gt_means[vid.gt_is_object].astype(np.float64)
    gt_d = vid.gt_obj_deltas.astype(np.float64)
    gt_a = np.stack([np.linalg.multi_dot([np.eye(4)] + [gt_d[g] for g in range(f, -1, -1)])
                     for f in range(len(gt_d))])
    eye = np.tile(np.eye(4), (len(gt_d), 1, 1))
    deltas = seq.deltas().cpu().numpy().astype(np.float64)
    errs = {"delta": pose_errors(deltas, gt_d, pts),  # per-frame delta
            "pose": pose_errors(seq.accum_T().cpu().numpy().astype(np.float64), gt_a, pts),
            "identity": pose_errors(eye, gt_a, pts)}  # the object left at rest
    per_frame = {int(f): {"loss_first": float(losses[f][0]), "loss_last": float(losses[f][-1]),
                          "steps": len(losses[f])} for f in frames}
    for kind, (rot, tr, add) in errs.items():
        for f in frames:
            per_frame[int(f)].update({f"{kind}_err_deg": float(rot[f]),
                                      f"{kind}_err_t": float(tr[f]),
                                      f"{kind}_add": float(add[f])})
    mean = {f"{kind}_{m}": float(v[dyn].mean()) for kind in ("pose", "identity")
            for m, v in zip(("err_deg", "err_t", "add"), errs[kind])}
    finite = all(bool(torch.isfinite(v).all()) for v in model.params.as_dict().values())
    back, _ = load_pose_sequence(os.path.join(save_dir, "obj_pose_sequence.npz"), dev)
    npz_ok = all(torch.equal(getattr(back, f), getattr(seq, f))
                 for f in ("translations", "rotations", "solved"))
    emit("coarse", schedule=COARSE_SCHEDULE, opt=COARSE_OPT, object_gaussians_in=n_obj,
         object_gaussians_out=int(model.num_alive), capacity=model.capacity,
         frames=per_frame, mean_over_dynamic=mean, steps=int(stats["steps"]),
         elided_noop_iters=int(stats["elided"]), it_per_s=stats["steps"] / seconds,
         seconds=seconds, crop_size_initial=stats["crop_size_initial"],
         crop_size_final=stats["crop_size"], crop_escapes=int(stats["crop_escapes"]),
         dropped_pairs=int(stats["dropped_pairs"]), max_memory_allocated=peak,
         tilegrid_launches_d3=launches, params_finite=finite, pose_npz_roundtrip=npz_ok)
    if not finite:
        raise AssertionError("non-finite parameters after the coarse stage")
    if stats["dropped_pairs"]:
        raise AssertionError(f"{stats['dropped_pairs']} pairs dropped after regrowth")
    if min(launches.values()) <= 0:
        raise AssertionError(f"the coarse stage launched no tile-grid kernel: {launches}")
    if not mean["pose_add"] < mean["identity_add"]:
        raise AssertionError(f"coarse pose no better than the identity: {mean}")
    if not npz_ok:
        raise AssertionError("pose npz round trip changed the sequence")
    return seq, model, dyn, cfg


def norm_rel(a, b) -> float:
    """||a - b|| / ||b|| (0 when both are zero)."""
    den = float(b.norm())
    num = float((a - b).norm())
    return num / den if den > 0 else num


def flavor_frame(dev, vid, seq, model, dyn, cfg):
    """The state the step flavors start from: the coarse stage's last
    dynamic frame f, its solved pose, the fixed-transform tables, the
    default tile config and the stage's crop size."""
    from types import SimpleNamespace

    from egogaussian_tpu_torch.data.readers import stack_cameras
    from egogaussian_tpu_torch.models.pose import pose_from_rt
    from egogaussian_tpu_torch.train.coarse_pose import _accum_tables
    from egogaussian_tpu_torch.train.common import auto_tile_config, pose_crop_size

    batch = stack_cameras(vid.cameras, dev)
    f = dyn[-1]
    table_T, table_R = _accum_tables(seq)
    return SimpleNamespace(
        batch=batch, f=f, table_T=table_T, table_R=table_R,
        pose0=pose_from_rt(seq.rotations[f], seq.translations[f]),
        base=auto_tile_config(model, batch.camera(0), tile_size=cfg.render.tile_size),
        crop=pose_crop_size(batch, cfg, "flavors"))


def phase_flavors(model, cfg, fr):
    """The stage-2 step under the three tile configs (same capacities, the
    same crop window), from the coarse stage's final state `fr`
    (flavor_frame): each flavor's gradients against the default's, then
    FLAVOR_STEPS steps of each from the same state with each step's loss
    against the default's (and each flavor's step rate, host clock between
    two syncs); and per flavor a label render (D = 1) through the public
    render_label with its label gradient against the default's."""
    import torch

    from egogaussian_tpu_torch.models.optim import adam_init
    from egogaussian_tpu_torch.ops.losses import bce_with_logits
    from egogaussian_tpu_torch.render.api import render_label
    from egogaussian_tpu_torch.train.coarse_pose import coarse_step, pose_loss_grads

    cp = cfg.coarse
    dev = model.device
    batch, f, table_T, table_R = fr.batch, fr.f, fr.table_T, fr.table_R
    pose0, base, crop = fr.pose0, fr.base, fr.crop
    flavors = {"default": base,
               "exact_total": dataclasses.replace(base, bwd_exact_total=True),
               "stream": dataclasses.replace(base, compositor="stream")}
    lam = dict(lambda_image=cp.lambda_image, lambda_dssim=cp.lambda_dssim,
               lambda_l1_alpha=cp.lambda_Ll1_alpha, lambda_l2_alpha=cp.lambda_Ll2_alpha)
    # each flavor's own kernels (launch-count names) must run in its turn
    own = {"default": ("tilegrid_fwd_d3", "tilegrid_bwd_d3", "tilegrid_bwd_d1"),
           "exact_total": ("tilegrid_fwd_d3", "tilegrid_bwd_exact_d3", "tilegrid_bwd_exact_d1"),
           "stream": ("stream_fwd_d3", "stream_bwd_d3", "stream_fwd_d1", "stream_bwd_d1")}
    grads, losses, label_grads, flavor_launches, step_rate = {}, {}, {}, {}, {}
    for name, tcfg in flavors.items():
        before = launch_counts()
        g = pose_loss_grads(model, pose0, batch, f, table_T[f], table_R[f], True,
                            backend="cuda", tile_config=tcfg, crop_size=crop, **lam)
        grads[name] = g
        m, opt, pose, popt = model, adam_init(model.params), pose0, adam_init(pose0)
        drop = torch.zeros((), dtype=torch.int64, device=dev)
        crop_max = torch.zeros((3,), dtype=torch.int32, device=dev)
        trace = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(FLAVOR_STEPS):
            m, opt, pose, popt, loss, _, drop, crop_max = coarse_step(
                m, opt, pose, popt, batch, f, table_T, table_R, f - 1, cp.warm_up_iter + 1 + k,
                drop, train_pose=True, first_frame=False, grad_params=True, opt_cfg=cfg.opt,
                coarse_cfg=cp, backend="cuda", tile_config=tcfg, crop_size=crop,
                crop_max=crop_max)
            trace.append(loss)
        torch.cuda.synchronize()
        step_rate[name] = FLAVOR_STEPS / (time.perf_counter() - t0)
        losses[name] = torch.stack(trace).cpu().numpy()
        # the label render (D = 1): BCE against the frame's object mask
        cam, _, _, obj_mask = batch.frame(f)
        labels = model.params.label[:, 0].detach().clone().requires_grad_(True)
        img = render_label(cam, model.params.xyz, model.covariance(), model.opacity, labels,
                           valid_mask=model.aux.alive, backend="cuda", tile_config=tcfg)
        (label_grads[name],) = torch.autograd.grad(bce_with_logits(img, obj_mask), labels)
        after = launch_counts()
        flavor_launches[name] = {k: after[k] - before[k] for k in own[name]}
    ref = grads["default"]
    report = {}
    ok = True
    for name in ("exact_total", "stream"):
        g = grads[name]
        errs = {k: norm_rel(getattr(g.params, k), getattr(ref.params, k))
                for k in g.params.as_dict()}
        errs["pose_translation"] = norm_rel(g.pose.translation, ref.pose.translation)
        errs["pose_rot6d"] = norm_rel(g.pose.rot6d, ref.pose.rot6d)
        errs["label_d1"] = norm_rel(label_grads[name], label_grads["default"])
        loss_rel = np.abs(losses[name] - losses["default"]) / np.abs(losses["default"])
        report[name] = {"grad_norm_rel_err": errs, "loss0": float(g.loss),
                        "step_loss_max_rel_err": float(loss_rel.max())}
        ok = ok and max(errs.values()) <= FLAVOR_TOL and float(loss_rel.max()) <= FLAVOR_TOL
    ok = ok and all(n > 0 for counts in flavor_launches.values() for n in counts.values())
    emit("flavors", frame=int(f), crop_size=crop, tile_size=base.tile_size,
         max_pairs=base.max_pairs, max_slots=base.max_slots, steps=FLAVOR_STEPS,
         default_loss0=float(ref.loss), default_losses=[float(x) for x in losses["default"]],
         flavors=report, launches=flavor_launches, it_per_s=step_rate, bound=FLAVOR_TOL,
         ok=ok)
    if not ok:
        raise AssertionError(f"a step flavor disagrees with the default: {report}")


def phase_frame_kernels(model, fr, errs):
    """Every kernel against its twin at the shapes path 2 gives it, on the
    flavor frame's state `fr`: the posed object model's cropped
    projection, built as pose_loss_grads renders it (D = 3, crop window
    with a partial bottom tile row), and the label render's full-frame
    projection (D = 1)."""
    import torch

    from egogaussian_tpu_torch.models.pose import pose_to_se3
    from egogaussian_tpu_torch.render.crop import crop_window, mask_rect
    from egogaussian_tpu_torch.render.project import project_gaussians
    from egogaussian_tpu_torch.render.tiled import stream_layout, tilegrid_layout
    from egogaussian_tpu_torch.train.common import model_colors

    cam, _, _, obj_mask = fr.batch.frame(fr.f)
    alive, opac = model.aux.alive, model.opacity
    scfg = dataclasses.replace(fr.base, compositor="stream")

    def project(xyz, cov3d):
        return project_gaussians(xyz, cov3d, cam.viewmat, cam.fx, cam.fy, cam.cx, cam.cy,
                                 cam.width, cam.height, valid_mask=alive)

    with torch.no_grad():
        # D = 3: the object Gaussians at pose @ fixed_T, covariance rotated
        T = pose_to_se3(fr.pose0) @ fr.table_T[fr.f]
        R = fr.pose0.rotation @ fr.table_R[fr.f]
        xyz = model.params.xyz
        xyz = torch.where((model.aux.is_object == 1)[:, None], xyz @ T[:3, :3].T + T[:3, 3], xyz)
        proj = project(xyz, model.covariance_rotated(R, 1))
        w, h = cam.width, cam.height
        if fr.crop is not None:
            w, h = fr.crop
            ox, oy, _ = crop_window(proj, opac, alive, mask_rect(obj_mask), w, h, cam.width,
                                    cam.height, align=fr.base.tile_size)
            shift = torch.stack([ox, oy]).to(proj.means2d.dtype)
            proj = proj._replace(means2d=proj.means2d - shift[None, :])
        cases = [(f"frame{fr.f}_crop_{w}x{h}", proj, model_colors(model), w, h,
                  torch.zeros(3, device=model.device))]
        # D = 1: the label render, unmoved geometry, full frame
        cases.append((f"frame{fr.f}_label_{cam.width}x{cam.height}",
                      project(model.params.xyz, model.covariance()), model.params.label,
                      cam.width, cam.height, torch.zeros(1, device=model.device)))
        for case, pr, cols, cw, ch, bg in cases:
            lay = tilegrid_layout(pr, cols, opac, cw, ch, fr.base)
            slay = stream_layout(pr, cols, opac, cw, ch, scfg)
            if int(lay.dropped) or int(slay.dropped):
                raise AssertionError(f"{case}: pairs dropped")
            with torch.enable_grad():
                cots = check_layout(case, lay, cols.shape[1], bg, FWD_TOL, cw, ch, errs)
            check_stream(case, slay, cots, cols.shape[1], bg, FWD_TOL, errs)


def knn_model(dev, vid, extent):
    """The slice's kNN-initialized model (~102k Gaussians, the state std
    mode starts from), with is_object from the video's ground truth."""
    import torch

    from egogaussian_tpu_torch.models.gaussians import from_points

    model = from_points(vid.points, vid.colors, dev, spatial_lr_scale=extent, seed=0)
    is_obj = torch.zeros_like(model.aux.is_object)
    is_obj[:len(vid.gt_is_object)] = torch.as_tensor(vid.gt_is_object.astype(np.int32),
                                                     device=dev)
    return dataclasses.replace(model, aux=dataclasses.replace(model.aux, is_object=is_obj))


def gt_pose_sequence(vid, dev):
    """The video's ground-truth object motion as a solved PoseSequence."""
    import torch

    from egogaussian_tpu_torch.models.pose import PoseSequence

    deltas = torch.as_tensor(vid.gt_obj_deltas, device=dev)
    return PoseSequence(translations=deltas[:, :3, 3].contiguous(),
                        rotations=deltas[:, :3, :3].contiguous(),
                        solved=torch.ones(len(vid.cameras), dtype=torch.bool, device=dev))


def check_results_txt(path):
    """results.txt in the JAX package's layout: per eval bucket a name line
    then SSIM, PSNR and LPIPS lines. Returns its lines."""
    with open(path) as f:
        lines = f.read().splitlines()
    ok = len(lines) == 8 and lines[0] == "dynamic_eval" and lines[4] == "static_eval"
    for i in (0, 4):
        ok = ok and all(lines[i + 1 + k].startswith(p)
                        for k, p in enumerate(("  SSIM : ", "  PSNR : ", "  LPIPS: ")))
    if not ok:
        raise AssertionError(f"results.txt is not in the JAX layout: {lines}")
    return lines


def phase_eval(dev, vid, extent, slice_model, coarse_seq, out_dir):
    """Path 3, stage 6. (a) The eval CLI end to end on the card: the
    slice's video exported in the reference's dataset layout, path 1's
    model as fine_all/gaussians_all.ply (is_object from the ground-truth
    box, as handed to path 2), path 2's pose sequence filled over every
    frame as stage 4 fills it, random LPIPS weights. (b) Every frame at
    640x480 through render_results with backend="auto" and no tile config
    (the tiled backend, as the JAX pipeline's stage 6 runs it) on the
    102k-Gaussian kNN model at the ground-truth poses. Returns what the
    comparison after the path needs."""
    import torch

    from egogaussian_tpu_torch.cli.eval import main as eval_main
    from egogaussian_tpu_torch.data.export_colmap import export_colmap_dataset
    from egogaussian_tpu_torch.data.readers import phase_membership_mask
    from egogaussian_tpu_torch.eval.lpips import random_lpips_weights, save_lpips_weights
    from egogaussian_tpu_torch.eval.render_results import render_results
    from egogaussian_tpu_torch.models.gaussians import save_ply
    from egogaussian_tpu_torch.models.pose import interpolate_pose_sequence, save_pose_sequence

    # the dataset and the CLI's PNGs (~100 MB) go to the gitignored build/,
    # results.txt to out_dir
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_eval")
    shutil.rmtree(root, ignore_errors=True)
    src = export_colmap_dataset(vid, os.path.join(root, "data"))
    model_dir = os.path.join(root, "model")
    handed = object_handover(slice_model, vid, split=False)
    save_ply(handed, os.path.join(model_dir, "fine_all", "gaussians_all.ply"))
    dyn_mask = phase_membership_mask(vid.cameras, vid.dynamic_phases)
    dyn_mask |= coarse_seq.solved.cpu().numpy()
    filled = interpolate_pose_sequence(coarse_seq, dyn_mask)
    save_pose_sequence(os.path.join(model_dir, "interpolate_pose_coarse", "obj_pose_sequence.npz"),
                       filled, vid.image_names)
    weights = os.path.join(root, "lpips_random_weights.npz")
    save_lpips_weights(random_lpips_weights(0), weights)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = eval_main(["-s", src, "-m", model_dir, "--lpips_weights", weights,
                         "--device", str(dev)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_peak = torch.cuda.max_memory_allocated()
    results_txt = os.path.join(model_dir, "evaluation", "results.txt")
    lines = check_results_txt(results_txt)
    shutil.copy(results_txt, os.path.join(out_dir, "eval_results.txt"))
    n_png = sum(len(files) for _, _, files in os.walk(os.path.join(model_dir, "evaluation")))
    shutil.rmtree(root)
    finite = all(np.isfinite(v) for m in metrics.values() for v in m.values())
    emit("eval_cli", frames=len(vid.cameras), gaussians=int(handed.num_alive),
         pose_frames_filled=int(filled.solved.sum()), metrics=metrics,
         lpips_weights="random (random_lpips_weights(0)): LPIPS values are uncalibrated",
         results_txt=lines, files_written=n_png, seconds=cli_s,
         seconds_per_frame=cli_s / len(vid.cameras), max_memory_allocated=cli_peak,
         metrics_finite=finite)
    if not finite or n_png != 2 * len(vid.cameras) + 1:
        raise AssertionError(f"eval CLI output incomplete: {n_png} files, metrics {metrics}")

    model = knn_model(dev, vid, extent)
    seq = gt_pose_sequence(vid, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    buckets = render_results(vid.cameras, model, seq, backend="auto")
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    renders = [e["render"] for b in buckets.values() for e in b]
    emit("eval_full_width", frames=len(renders), gaussians=int(model.num_alive),
         width=vid.cameras[0].width, height=vid.cameras[0].height, backend="auto -> tiled",
         seconds=full_s, seconds_per_frame=full_s / len(renders),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         renders_finite=all(bool(np.isfinite(r).all()) for r in renders))
    return model, seq, buckets


def compare_eval_frames(vid, model, seq, buckets):
    """After path 3's counts are read: every frame of the full-width
    evaluation rendered again through the tiled backend ("auto", no tile
    config) and through "cuda" with auto_tile_config, within DEEP_FWD_TOL,
    with 0 dropped pairs in both; render_results' image must be the
    8-bit quantization of the tiled render."""
    import torch

    from egogaussian_tpu_torch.eval.render_results import _quantize8
    from egogaussian_tpu_torch.train.common import auto_tile_config, render_gaussians

    accum_T, accum_R = seq.accum_T(), seq.accum_R()
    bg = torch.zeros(3, device=model.device)
    by_name = {e["name"]: e["render"] for b in buckets.values() for e in b}
    worst = {k: 0.0 for k in DEEP_FWD_TOL}
    dropped = {"tiled": 0, "cuda": 0}
    same_as_results = True
    with torch.no_grad():
        for f, cam in enumerate(vid.cameras):
            cfg = auto_tile_config(model, cam)
            rt = render_gaussians(model, cam, bg, pose_T=accum_T[f], extra_rot=accum_R[f],
                                  backend="auto")
            rc = render_gaussians(model, cam, bg, pose_T=accum_T[f], extra_rot=accum_R[f],
                                  backend="cuda", tile_config=cfg)
            for k in worst:
                worst[k] = max(worst[k], max_err(getattr(rt, k), getattr(rc, k)))
            dropped["tiled"] += int(rt.dropped_pairs)
            dropped["cuda"] += int(rc.dropped_pairs)
            same_as_results &= bool(np.array_equal(_quantize8(rt.image.cpu().numpy()),
                                                   by_name[cam.image_name]))
    ok = (all(worst[k] <= DEEP_FWD_TOL[k] for k in worst) and not any(dropped.values())
          and same_as_results)
    emit("eval_vs_cuda", frames=len(vid.cameras), max_abs_err=worst, tol=DEEP_FWD_TOL,
         dropped_pairs=dropped, results_are_quantized_tiled_renders=same_as_results, ok=ok)
    if not ok:
        raise AssertionError(f"tiled eval renders disagree with cuda: {worst}, {dropped}")


TILED_STEPS = 20


def phase_tiled_step(dev, vid, extent):
    """The static step (train/static.py:_static_step) on the slice's kNN
    model at 640x480 under backend="tiled" against "cuda", with one tile
    config (auto_tile_config, ts 32): per mode (std at D = 3, label at
    D = 1) each parameter group's gradient at the first state, then
    TILED_STEPS steps of each from that state with each step's loss.
    Norm-relative gradient error and relative loss error within
    FLAVOR_TOL."""
    import torch

    from egogaussian_tpu_torch.config import Config
    from egogaussian_tpu_torch.data import split_viewpoints_by_phase
    from egogaussian_tpu_torch.data.readers import stack_cameras
    from egogaussian_tpu_torch.models.optim import adam_init
    from egogaussian_tpu_torch.train.common import auto_tile_config
    from egogaussian_tpu_torch.train.static import _frames_loss_grads, _static_step

    cfg = Config()
    model = knn_model(dev, vid, extent)
    group = split_viewpoints_by_phase(vid.cameras, vid.static_phases)[0]
    batch = stack_cameras([vid.cameras[i] for i in group], dev)
    tcfg = auto_tile_config(model, batch.camera(0))
    bg = torch.zeros(3, device=dev)
    report, ok = {}, True
    step_s = {}
    for mode in ("std", "label"):
        grads, losses = {}, {}
        for backend in ("tiled", "cuda"):
            grads[backend], _, _, _, drop = _frames_loss_grads(
                model, batch, [0], batch.hand_masks, mode, cfg.opt.lambda_dssim, backend,
                tcfg, bg)
            if int(drop.max()):
                raise AssertionError(f"tiled step: {int(drop.max())} pairs dropped ({backend})")
            m, opt = model, adam_init(model.params)
            drop_max = torch.zeros((), dtype=torch.int64, device=dev)
            trace = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for k in range(TILED_STEPS):
                m, opt, loss, _, drop_max = _static_step(
                    m, opt, batch, [k % len(group)], batch.hand_masks, k + 1, drop_max,
                    mode=mode, lambda_dssim=cfg.opt.lambda_dssim, backend=backend,
                    tile_config=tcfg, opt_cfg=cfg.opt, label_lr=cfg.static.label_lr)
                trace.append(loss)
            torch.cuda.synchronize()
            step_s[f"{mode}_{backend}"] = (time.perf_counter() - t0) / TILED_STEPS
            losses[backend] = torch.stack(trace).cpu().numpy()
            if int(drop_max):
                raise AssertionError(f"tiled step: {int(drop_max)} pairs dropped in {mode} steps")
        g, ref = grads["tiled"], grads["cuda"]
        errs = {k: norm_rel(getattr(g, k), getattr(ref, k)) for k in g.as_dict()
                if float(getattr(ref, k).norm()) > 0}
        loss_rel = np.abs(losses["tiled"] - losses["cuda"]) / np.abs(losses["cuda"])
        report[mode] = {"grad_norm_rel_err": errs, "step_loss_max_rel_err": float(loss_rel.max()),
                        "losses_cuda": [float(x) for x in losses["cuda"]]}
        ok = ok and max(errs.values()) <= FLAVOR_TOL and float(loss_rel.max()) <= FLAVOR_TOL
    emit("tiled_step", gaussians=int(model.num_alive), tile_size=tcfg.tile_size,
         max_per_tile=tcfg.max_per_tile, steps=TILED_STEPS, modes=report,
         seconds_per_step=step_s, bound=FLAVOR_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"tiled step disagrees with cuda: {report}")


def entry_windows(model, cam):
    """Path 4's inputs: the full-frame window (default TileConfig: ts 16,
    1,024 rows) of `model` at `cam`, for the image (D = 3) and the label
    (D = 1)."""
    import torch

    from egogaussian_tpu_torch.render.project import project_gaussians
    from egogaussian_tpu_torch.render.tiled import TileConfig, window_layout
    from egogaussian_tpu_torch.train.common import model_colors

    dev = model.device
    with torch.no_grad():
        proj = project_gaussians(model.params.xyz, model.covariance(), cam.viewmat, cam.fx,
                                 cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                                 valid_mask=model.aux.alive)
        opac = torch.where(model.aux.alive, model.opacity, torch.zeros_like(model.opacity))
        out = []
        for d, cols, bg in ((3, model_colors(model), torch.zeros(3, device=dev)),
                            (1, model.params.label, torch.zeros(1, device=dev))):
            lay = window_layout(proj, cols, opac, cam.width, cam.height, TileConfig())
            if int(lay.dropped):
                raise AssertionError(f"entry window D={d}: {int(lay.dropped)} pairs dropped")
            out.append((d, lay, bg))
    return out


def phase_entry(model, cam):
    """Path 4: the simple windowed pair through its entry point,
    `make_tile_compositor`, forward and backward (autograd) on the
    full-frame windows of entry_windows. Returns the windows and the
    outputs for the checks after the path."""
    import torch

    from egogaussian_tpu_torch.render.window_raster import make_tile_compositor

    results = []
    for d, lay, bg in entry_windows(model, cam):
        parts = [x.requires_grad_(True) for x in split_window(lay)]
        n_tiles, m = parts[0].shape[:2]
        fn = make_tile_compositor(n_tiles, m, d, lay.tile_size, lay.n_tx)
        outs = fn(*parts, bg[None].contiguous())
        cots = window_cotangents([o.detach() for o in outs], lay, d, cam.width, cam.height)
        grads = torch.autograd.grad(outs, parts, grad_outputs=cots)
        torch.cuda.synchronize()
        results.append((d, lay, bg, [o.detach() for o in outs], cots, grads))
    return results


def check_entry(results, cam, errs):
    """Path 4's outputs against the twins and the chunked pair (check_window
    on the same windows), and the entry point's autograd results against
    the kernels called directly."""
    import torch

    from egogaussian_tpu_torch.render import window_raster as wr

    for d, lay, bg, outs, cots, grads in results:
        case = f"entry_frame0_{cam.width}x{cam.height}"
        check_window(case, lay, bg, FWD_TOL, cam.width, cam.height, errs)
        parts = split_window(lay)
        bg2 = bg[None].contiguous()
        direct = wr.window_forward(*parts, bg2, lay.tile_size, lay.n_tx)
        dgrads = wr.window_backward(*parts, bg2, *cots, lay.tile_size, lay.n_tx)
        same = (all(torch.equal(a, b) for a, b in zip(outs, direct))
                and all(torch.equal(a, b) for a, b in zip(grads, dgrads)))
        emit("entry_point", d=d, tiles=lay.counts.shape[0], window_rows=parts[0].shape[1],
             deepest_tile=int(lay.counts.max()), pairs=int(lay.counts.sum()),
             autograd_equals_direct_kernels=same, ok=same)
        if not same:
            raise AssertionError("make_tile_compositor's autograd path differs from its kernels")


def tilegrid_bounds(d, p, lay, instr_per_s):
    """Rows 1-3's bounds on one tile-grid layout: {key: (bound_ms, bound_by,
    dense_bound_ms, bound_ms at the measured rate)}, and the covered and
    dense evaluation counts. Bytes: the chunks of the pairs the data has,
    read once (twice for the backward's gradient chunk out), the per-pixel
    planes."""
    from egogaussian_tpu_torch.utils.peak import covered_evaluations

    f = 4  # bytes per float32
    n_tiles, pp = lay.meta.shape[1], lay.n_tx * lay.n_ty * p
    cnt = lay.meta[1].long()
    dense = int(cnt.sum()) * p
    cov = covered_evaluations(lay.meta, lay.vals, lay.tile_size, lay.n_tx)
    used_slots = int(((cnt + CHUNK_ROWS - 1) // CHUNK_ROWS).sum())
    chunk_bytes = used_slots * CHUNK_ROWS * lay.vals.shape[1] * f
    out_bytes = pp * (d + 2) * f  # img, alpha, depth
    return {
        ("fwd", d): bounds_of("fwd", d, cov, dense, 12 * n_tiles + chunk_bytes + out_bytes,
                              instr_per_s),
        ("bwd", d): bounds_of("bwd", d, cov, dense, 12 * n_tiles + 2 * chunk_bytes
                              + 2 * out_bytes, instr_per_s),
        ("bwd_exact", d): bounds_of("bwd2", d, cov, dense, 12 * n_tiles + 2 * chunk_bytes
                                    + out_bytes, instr_per_s),
    }, cov, dense


def bounds_of(kind, d, covered, dense, n_bytes, instr_per_s):
    """(bound_ms on the covered evaluations, bound_by, bound_ms on the dense
    count, bound_ms on the covered evaluations at the measured rate)."""
    from egogaussian_tpu_torch.utils.peak import bound

    ms, by = bound(kind, d, covered, n_bytes)
    return (ms, by, bound(kind, d, dense, n_bytes)[0],
            bound(kind, d, covered, n_bytes, instr_per_s)[0])


def kernel_bounds(d, p, lay, slay, wlay, instr_per_s):
    """Each kernel's bounds on this run's layouts (tilegrid_bounds for rows
    1-3): the evaluations the data needs (gated alpha > 0; the three
    layouts come from one binning that dropped no pair, so they hold the
    same pairs and the tile-grid layout's count is every row's) and the
    bytes each kernel must move (the pair rows it needs read once,
    per-pixel planes, every gradient row it writes)."""
    f = 4
    out, cov, dense = tilegrid_bounds(d, p, lay, instr_per_s)
    n_tiles, pp = lay.meta.shape[1], lay.n_tx * lay.n_ty * p
    ch = 7 + d
    cnt = lay.meta[1].long()
    used_slots = int(((cnt + CHUNK_ROWS - 1) // CHUNK_ROWS).sum())
    srow_bytes = used_slots * CHUNK_ROWS * ch * f
    out_bytes = pp * (d + 2) * f
    cot_bytes = out_bytes
    wcnt = wlay.counts.long()
    t_rows = wlay.data.shape[0] * wlay.data.shape[1]
    need_rows = int(wcnt.sum()) * ch * f
    out.update({
        ("stream_fwd", d): bounds_of("fwd", d, cov, dense, 16 * slay.meta.shape[1]
                                     + srow_bytes + out_bytes + pp * f, instr_per_s),
        ("stream_bwd", d): bounds_of("bwd", d, cov, dense, 16 * slay.meta.shape[1]
                                     + srow_bytes + pp * f + cot_bytes
                                     + slay.vals.numel() * f, instr_per_s),
        ("window_chunked_fwd", d): bounds_of("fwd", d, cov, dense, 4 * n_tiles + need_rows
                                             + out_bytes + pp * f, instr_per_s),
        ("window_chunked_bwd", d): bounds_of("bwd", d, cov, dense, 4 * n_tiles + need_rows
                                             + pp * f + cot_bytes + t_rows * ch * f,
                                             instr_per_s),
        # the simple pair reads every row's op to find the masked ones
        ("window_fwd", d): bounds_of("fwd", d, cov, dense, t_rows * f + need_rows
                                     + out_bytes, instr_per_s),
        ("window_bwd", d): bounds_of("bwd2", d, cov, dense, t_rows * f + need_rows
                                     + cot_bytes + t_rows * ch * f, instr_per_s),
    })
    return out, {"covered": cov, "dense": dense}


CHUNK_ROWS = 128  # pairs per chunk of the padded layouts


def frame_1080(cam):
    """The timing camera at 1920x1080: intrinsics scaled by 3 (the
    1920x1440 frame), cropped to its middle 1,080 rows; 60 x 34 tiles at
    ts 32."""
    return dataclasses.replace(cam, fx=cam.fx * 3, fy=cam.fy * 3, cx=cam.cx * 3,
                               cy=cam.cy * 3 - 180, width=1920, height=1080, gt_image=None,
                               hand_mask=None)


def time_tilegrid(meta, vals, bg2, ts, n_tx, dev):
    """Rows 1-3 (kernel ms, plain twin ms) on one tile-grid layout, with
    random cotangents of scale 1e-3 on the kernel's own outputs; and the
    cull-off instances' ms (what the per-warp cull saves)."""
    import torch

    from egogaussian_tpu_torch.render import cuda_raster as cr

    out = cr.tilegrid_forward(meta, vals, bg2, ts, n_tx)
    gen = torch.Generator(device=dev).manual_seed(1)
    cot = [torch.randn(x.shape, generator=gen, device=dev) * 1e-3 for x in out]
    times = {"fwd": (cuda_ms(lambda: cr.tilegrid_forward(meta, vals, bg2, ts, n_tx)),
                     cuda_ms(lambda: cr.composite_tilegrid_plain_fwd(meta, vals, bg2, ts, n_tx),
                             iters=5, warmup=1))}
    for key, exact in (("bwd", False), ("bwd_exact", True)):
        times[key] = (
            cuda_ms(lambda: cr.tilegrid_backward(meta, vals, bg2, *out, *cot, ts, n_tx,
                                                 exact_total=exact)),
            cuda_ms(lambda: cr.composite_tilegrid_plain_bwd(meta, vals, bg2, *out, *cot, ts,
                                                            n_tx, exact_total=exact),
                    iters=5, warmup=1))
    nocull = {
        "fwd": cuda_ms(lambda: cr.tilegrid_forward_nocull(meta, vals, bg2, ts, n_tx)),
        "bwd": cuda_ms(lambda: cr.tilegrid_backward_nocull(meta, vals, bg2, *out, *cot, ts,
                                                           n_tx)),
        "bwd_exact": cuda_ms(lambda: cr.tilegrid_backward_nocull(meta, vals, bg2, *out, *cot, ts,
                                                                 n_tx, exact_total=True))}
    return times, nocull, out, cot


def phase_timing(dev, vid, extent, errs, peak_gflops):
    """Kernel vs plain twin (CUDA events) on the kNN-initialized model of the
    slice (its heaviest, ~100k Gaussians, the state std mode starts from),
    with its auto tile config (ts 32), D = 3 (image) and D = 1 (label):
    every kernel on frame 0 at 640x480, and rows 1-3 again on the same
    frame at 1920x1080 (frame_1080), where the grid fills the card. Each
    kernel's bound on the same inputs: on the covered evaluations (gated
    alpha > 0) at the published rate, on the dense count (pairs x pixels,
    PR 3's yardstick), and on the covered evaluations at the FMA rate this
    run measured. Returns the 640x480 times and bounds."""
    import torch

    from egogaussian_tpu_torch.render import stream_raster as sr
    from egogaussian_tpu_torch.render import window_raster as wr
    from egogaussian_tpu_torch.render.project import project_gaussians
    from egogaussian_tpu_torch.render.tiled import stream_layout, tilegrid_layout, window_layout
    from egogaussian_tpu_torch.train.common import auto_tile_config, model_colors

    instr_per_s = peak_gflops * 1e9 / 2  # FMA = 2 flops, 1 instruction
    model = knn_model(dev, vid, extent)
    opac = torch.where(model.aux.alive, model.opacity, torch.zeros_like(model.opacity))
    times, bounds = {}, {}
    for main_frame, cam in ((True, vid.cameras[0]), (False, frame_1080(vid.cameras[0]))):
        cfg = auto_tile_config(model, cam)
        proj = project_gaussians(model.params.xyz, model.covariance(), cam.viewmat, cam.fx,
                                 cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                                 valid_mask=model.aux.alive)
        for d, cols, bg in ((3, model_colors(model), torch.zeros(3, device=dev)),
                            (1, model.params.label, torch.zeros(1, device=dev))):
            lay = tilegrid_layout(proj, cols, opac, cam.width, cam.height, cfg)
            if int(lay.dropped):
                raise AssertionError(f"timing frame {cam.width}x{cam.height}: pairs dropped")
            case = f"timing_{cam.width}x{cam.height}_d{d}"
            cots = check_layout(case, lay, d, bg, FWD_TOL, cam.width, cam.height, errs)
            meta, vals = lay.meta, lay.vals.detach().contiguous()
            ts, n_tx = lay.tile_size, lay.n_tx
            p, n_tiles = ts * ts, lay.n_tx * lay.n_ty
            bg2 = bg[None].contiguous()
            with torch.no_grad():
                t, nocull, _, cot = time_tilegrid(meta, vals, bg2, ts, n_tx, dev)
            if main_frame:
                slay = stream_layout(proj, cols, opac, cam.width, cam.height,
                                     dataclasses.replace(cfg, compositor="stream"))
                check_stream(case, slay, cots, d, bg, FWD_TOL, errs)
                wlay = window_layout(proj, cols, opac, cam.width, cam.height, cfg)
                check_window(case, wlay, bg, FWD_TOL, cam.width, cam.height, errs)
                if int(slay.dropped) or int(wlay.dropped):
                    raise AssertionError(f"timing frame {case}: stream or window pairs dropped")
                b, counts = kernel_bounds(d, p, lay, slay, wlay, instr_per_s)
                smeta, svals = slay.meta, slay.vals.detach().contiguous()
                counts_w, data = wlay.counts, wlay.data.detach().contiguous()
                parts = split_window(wlay)
                with torch.no_grad():
                    sout = sr.stream_forward(smeta, svals, bg2, ts, n_tx, n_tiles)
                    t["stream_fwd"] = (
                        cuda_ms(lambda: sr.stream_forward(smeta, svals, bg2, ts, n_tx, n_tiles)),
                        cuda_ms(lambda: sr.composite_stream_plain_fwd(smeta, svals, bg2, ts, n_tx,
                                                                      n_tiles), iters=5, warmup=1))
                    t["stream_bwd"] = (
                        cuda_ms(lambda: sr.stream_backward(smeta, svals, bg2, sout[3], *cot, ts,
                                                           n_tx)),
                        cuda_ms(lambda: sr.composite_stream_plain_bwd(smeta, svals, bg2, sout[3],
                                                                      *cot, ts, n_tx),
                                iters=5, warmup=1))
                    wout = wr.window_chunked_forward(counts_w, data, bg2, ts, n_tx)
                    t["window_chunked_fwd"] = (
                        cuda_ms(lambda: wr.window_chunked_forward(counts_w, data, bg2, ts, n_tx)),
                        cuda_ms(lambda: wr.composite_window_chunked_plain_fwd(counts_w, data, bg2,
                                                                              ts, n_tx),
                                iters=5, warmup=1))
                    t["window_chunked_bwd"] = (
                        cuda_ms(lambda: wr.window_chunked_backward(counts_w, data, bg2, wout[3],
                                                                   *cot, ts, n_tx)),
                        cuda_ms(lambda: wr.composite_window_chunked_plain_bwd(
                            counts_w, data, bg2, wout[3], *cot, ts, n_tx), iters=5, warmup=1))
                    t["window_fwd"] = (
                        cuda_ms(lambda: wr.window_forward(*parts, bg2, ts, n_tx)),
                        cuda_ms(lambda: wr.composite_window_plain_fwd(*parts, bg2, ts, n_tx, 16),
                                iters=3, warmup=1))
                    t["window_bwd"] = (
                        cuda_ms(lambda: wr.window_backward(*parts, bg2, *cot, ts, n_tx)),
                        cuda_ms(lambda: wr.composite_window_plain_bwd(*parts, bg2, *cot, ts, n_tx,
                                                                      16), iters=3, warmup=1))
                extra = dict(slots=vals.shape[0], window_rows=data.shape[1], dropped=0)
                times.update({(k, d): v for k, v in t.items()})
                bounds.update(b)
            else:
                b, cov, dense = tilegrid_bounds(d, p, lay, instr_per_s)
                counts = {"covered": cov, "dense": dense}
                extra = dict(slots=vals.shape[0], dropped=0)
            keys = [k for k in KERNELS if k in t]
            emit("timing", frame=f"{cam.width}x{cam.height}", d=d, tile_size=ts,
                 gaussians=int(model.num_alive), tiles=n_tiles, deepest_tile=int(meta[1].max()),
                 pairs=int(meta[1].sum()), evaluations=counts,
                 measured_fp32_gflops=peak_gflops, **extra,
                 **{f"{k}_ms": t[k][0] for k in keys},
                 **{f"{k}_nocull_ms": v for k, v in nocull.items()},
                 **{f"{k}_plain_ms": t[k][1] for k in keys},
                 **{f"{k}_bound_ms": b[(k, d)][0] for k in keys},
                 **{f"{k}_dense_bound_ms": b[(k, d)][2] for k in keys},
                 **{f"{k}_bound_ms_at_measured_rate": b[(k, d)][3] for k in keys})
    return times, bounds


def phase_peak(dev):
    """Row 10's path: the card's float32 FMA rate through its entry point,
    fma_peak_gflops (fma_chain at n_loop 120,000 on a block that fills
    every SM), beside the published 67 TFLOP/s and the card's power
    limit. Returns GFLOP/s."""
    from egogaussian_tpu_torch.utils.peak import (
        FP32_FLOPS,
        PEAK_LOOP,
        default_rows,
        fma_peak_gflops,
    )

    gflops = fma_peak_gflops(dev)
    emit("peak", fp32_gflops=gflops, share_of_published=gflops * 1e9 / FP32_FLOPS,
         published_gflops=FP32_FLOPS / 1e9, rows=default_rows(dev), n_loop=PEAK_LOOP,
         nvidia_smi=nvidia_smi_line())
    return gflops


def check_peak(dev, errs, peak_gflops):
    """fma_chain against its twin at the peak path's shapes: a seeded
    [default_rows, 128] block in [1, 1.45) at n_loop 120,000, bit for bit
    (each step moves x by 1-2 ulp, so a skipped step shows); the twin's
    timed run is the one compared. Then the kernel's time and bound, and
    the SM clock under a sustained FMA load (sm_clock_under_load) with the
    issue-rate peak at that clock. Returns (ms, plain_ms, bound)."""
    import torch

    from egogaussian_tpu_torch.utils.peak import (
        PEAK_LOOP,
        bound_fma,
        default_rows,
        fma_chain,
        fma_chain_plain,
    )

    rows = default_rows(dev)
    x = torch.as_tensor(np.random.RandomState(0).uniform(1.0, 1.45, (rows, 128))
                        .astype(np.float32), device=dev)
    k = fma_chain(x, PEAK_LOOP)
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(fma_chain_plain(x, PEAK_LOOP)), iters=1, warmup=0)
    err = max_err(k, plain[0])
    same = torch.equal(k, plain[0])
    errs[("fma_peak", None)] = [err]
    ms = cuda_ms(lambda: fma_chain(x, PEAK_LOOP), iters=3, warmup=1)
    b = bound_fma(rows, PEAK_LOOP)
    emit("peak_check", rows=rows, n_loop=PEAK_LOOP, max_abs_err=err, tol=0.0,
         bit_identical=same, ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1], ok=same)
    if not same:
        raise AssertionError(f"fma_chain differs from its twin: max abs err {err}")
    clock, max_clock, loaded = sm_clock_under_load(dev, rows)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    at_clock = sms * 128 * 2 * clock * 1e6 / 1e9  # FMA lanes x 2 flops x clock
    emit("peak_clock", sm_clock_mhz=clock, max_sm_clock_mhz=max_clock, read_under_load=loaded,
         issue_peak_gflops_at_clock=at_clock, fp32_gflops=peak_gflops,
         share_of_issue_peak_at_clock=peak_gflops / at_clock, nvidia_smi=nvidia_smi_line())
    return ms, plain_ms, b


def sm_clock_under_load(dev, rows, launches: int = 300):
    """nvidia-smi's SM clock and maximum SM clock (MHz) read 0.5 s into a
    queue of back-to-back fma_chain launches (rows x 128 chains of
    10 x 120,000 FMAs each, ~4 s of work), and whether that work was still
    running when the reading returned."""
    import torch

    from egogaussian_tpu_torch.utils.peak import PEAK_LOOP, fma_chain

    x = torch.ones((rows, 128), dtype=torch.float32, device=dev)
    torch.cuda.synchronize(dev)
    for _ in range(launches):
        fma_chain(x, 10 * PEAK_LOOP)
    done = torch.cuda.Event()
    done.record()
    time.sleep(0.5)
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    loaded = not done.query()
    torch.cuda.synchronize(dev)
    clock, max_clock = (float(v) for v in res.stdout.strip().splitlines()[0].split(","))
    return clock, max_clock, loaded


def phase_profile(dev, vid, extent, out_dir, iters: int = 40, skip: int = 10):
    """torch.profiler over std-mode iterations skip+1..iters of train_static
    (no densify): device time by kernel, and the device's busy share of the
    window's wall time (one stream, so kernel times add up). Table written
    to out_dir/profile.txt."""
    import torch

    from egogaussian_tpu_torch.config import Config
    from egogaussian_tpu_torch.data import split_viewpoints_by_phase
    from egogaussian_tpu_torch.train.static import train_static

    cfg = Config()
    cfg.static = dataclasses.replace(cfg.static, std_train_iter=iters, entropy_reg_iter=0,
                                     label_train_iter=0, densify_from_iter=10**9,
                                     densify_until_iter=0)
    groups = split_viewpoints_by_phase(vid.cameras, vid.static_phases)
    sched = torch.profiler.schedule(skip_first=skip - 1, wait=0, warmup=1, active=iters - skip,
                                     repeat=1)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    clock = {}

    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        def on_step(it, mode, loss):
            if it in (skip, iters):
                torch.cuda.synchronize()
                clock[it] = time.perf_counter()
            prof.step()

        train_static(vid.cameras, vid.points, vid.colors, cfg, groups, extent, seed=0,
                     first_phase_only=True, device=dev, on_step=on_step)
    wall_ms = (clock[iters] - clock[skip]) * 1e3 / (iters - skip)
    rows = []
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith("ProfilerStep")):
            continue  # host-side ops; their device time is their kernels'
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        rows.append((dev_us / (iters - skip) / 1e3, e.count // (iters - skip), e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        f.write(f"std-mode step, {iters - skip} profiled iterations; wall {wall_ms:.3f} ms/it, "
                f"device busy {busy_ms:.3f} ms/it\n")
        for ms, calls, name in rows:
            f.write(f"{ms:10.4f} ms/it  {calls:5d} calls/it  {name}\n")
    emit("profile", wall_ms_per_it=wall_ms, device_busy_ms_per_it=busy_ms,
         device_idle_share=1.0 - busy_ms / wall_ms,
         top=[{"op": n[:80], "ms_per_it": ms, "calls_per_it": c} for ms, c, n in rows[:15]])


# kernel key -> (kernels-line name stem, source, the TPU kernel it replaces)
KERNELS = {
    "fwd": ("tilegrid_fwd", "egogaussian_tpu_torch/csrc/tilegrid_fwd.cu",
            "egogaussian_tpu/render/pallas_raster.py:890"),
    "bwd": ("tilegrid_bwd", "egogaussian_tpu_torch/csrc/tilegrid_bwd.cu",
            "egogaussian_tpu/render/pallas_raster.py:984"),
    "bwd_exact": ("tilegrid_bwd_exact", "egogaussian_tpu_torch/csrc/tilegrid_bwd.cu",
                  "egogaussian_tpu/render/pallas_raster.py:1073"),
    "stream_fwd": ("stream_fwd", "egogaussian_tpu_torch/csrc/stream_fwd.cu",
                   "egogaussian_tpu/render/pallas_raster.py:530"),
    "stream_bwd": ("stream_bwd", "egogaussian_tpu_torch/csrc/stream_bwd.cu",
                   "egogaussian_tpu/render/pallas_raster.py:583"),
    "window_chunked_fwd": ("window_chunked_fwd", "egogaussian_tpu_torch/csrc/window_chunked_fwd.cu",
                           "egogaussian_tpu/render/pallas_raster.py:235"),
    "window_chunked_bwd": ("window_chunked_bwd", "egogaussian_tpu_torch/csrc/window_chunked_bwd.cu",
                           "egogaussian_tpu/render/pallas_raster.py:295"),
    "window_fwd": ("window_fwd", "egogaussian_tpu_torch/csrc/window_fwd.cu",
                   "egogaussian_tpu/render/pallas_raster.py:105"),
    "window_bwd": ("window_bwd", "egogaussian_tpu_torch/csrc/window_bwd.cu",
                   "egogaussian_tpu/render/pallas_raster.py:133"),
    "fma_peak": ("fma_peak", "egogaussian_tpu_torch/csrc/fma_peak.cu", "bench.py:273"),
}
# the path whose launch counts the kernels line reports for each kernel (per
# D where they differ: evaluation renders images only, the tiled step's
# label mode runs the D = 1 forward)
PATH_OF = {"fwd": "slice", "bwd": "slice", "bwd_exact": "coarse", "stream_fwd": "coarse",
           "stream_bwd": "coarse", "window_chunked_fwd": {3: "eval", 1: "tiled_step"},
           "window_chunked_bwd": "tiled_step", "window_fwd": "entry", "window_bwd": "entry",
           "fma_peak": "peak"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the kernel checks (no slice, no result line)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from egogaussian_tpu_torch.render import cuda_raster as cr

    dev = torch.device("cuda", 0)
    out_dir = os.path.join("chiprun_out", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    # every phase line also goes to phases.jsonl: the output's tail is cut
    PHASE_LOG.append(os.path.join(out_dir, "phases.jsonl"))
    open(PHASE_LOG[0], "w").close()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.time()
    path, log = cr.build_library()
    cr.kernel_library()
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        f.write(log)
    emit("build", seconds=time.time() - t0, library=os.path.relpath(path),
         ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln])

    errs = {}
    phase_kernels(dev, errs)
    if args.kernels_only:
        return 0

    # path 1: stage-1.0 static training
    reset_launch_counts()
    vid, extent, _, slice_model = phase_slice(dev, out_dir)
    path_launches = {"slice": launch_counts()}
    # path 2: stage-2 coarse pose, then its step under each flavor
    reset_launch_counts()
    seq, model, dyn, ccfg = phase_coarse(dev, vid, extent, object_handover(slice_model, vid),
                                         out_dir)
    fr = flavor_frame(dev, vid, seq, model, dyn, ccfg)
    phase_flavors(model, ccfg, fr)
    path_launches["coarse"] = launch_counts()
    # path 3: stage-6 evaluation (the eval CLI, then every frame at full
    # width through the tiled backend)
    reset_launch_counts()
    eval_model, eval_seq, buckets = phase_eval(dev, vid, extent, slice_model, seq, out_dir)
    path_launches["eval"] = launch_counts()
    # the tiled backend's train step (the chunked windowed backward)
    reset_launch_counts()
    phase_tiled_step(dev, vid, extent)
    path_launches["tiled_step"] = launch_counts()
    # path 4: the simple windowed pair through make_tile_compositor
    reset_launch_counts()
    entry = phase_entry(eval_model, vid.cameras[0])
    path_launches["entry"] = launch_counts()
    # row 10's path: the FMA peak that bounds are read against
    reset_launch_counts()
    peak_gflops = phase_peak(dev)
    path_launches["peak"] = launch_counts()
    frames = 2 * len(vid.cameras)  # the eval CLI's frames and the full-width frames
    # per mode (std: D = 3, label: D = 1) and backend: the gradient check
    # and the steps
    steps = TILED_STEPS + 1
    emit("launches", **path_launches,
         per_eval_frame={k: n / frames for k, n in path_launches["eval"].items() if n},
         per_tiled_step={k: n / steps for k, n in path_launches["tiled_step"].items() if n})
    # checks after the paths' counts are read: path 3's frames against the
    # cuda backend, path 4 against the twins and the chunked pair, every
    # kernel against its twin at path 2's own shapes
    compare_eval_frames(vid, eval_model, eval_seq, buckets)
    check_entry(entry, vid.cameras[0], errs)
    phase_frame_kernels(model, fr, errs)
    ms, plain_ms, b = check_peak(dev, errs, peak_gflops)
    times, bounds = phase_timing(dev, vid, extent, errs, peak_gflops)
    times[("fma_peak", None)] = (ms, plain_ms)
    bounds[("fma_peak", None)] = (b[0], b[1], b[0], None)
    phase_profile(dev, vid, extent, out_dir)

    table = []
    for key, (stem, src, replaces) in KERNELS.items():
        for d in ((None,) if key == "fma_peak" else (3, 1)):
            name = stem if d is None else f"{stem}_d{d}"
            path = PATH_OF[key][d] if isinstance(PATH_OF[key], dict) else PATH_OF[key]
            table.append({
                "name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": path_launches[path][name],
                "max_abs_err": max(errs[(key, d)]),
                "ms": times[(key, d)][0], "plain_ms": times[(key, d)][1],
                "bound_ms": bounds[(key, d)][0], "bound_by": bounds[(key, d)][1],
                "dense_bound_ms": bounds[(key, d)][2],
                "bound_ms_at_measured_rate": bounds[(key, d)][3],
                # no single PyTorch call composites Gaussians or chains FMAs
                "library_ms": None,
            })
    missing = [k["name"] for k in table if k["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: {missing}")
    print(json.dumps({"kernels": table}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
