#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (one JSON line each; any failure raises, so the exit code is
nonzero and no result line is printed):
  1. device:  requires CUDA; prints the card (nvidia-smi name, power limit)
  2. build:   compiles the nine compositor kernels (tile-grid forward, the
              tile-grid backward in both flavors, the stream pair, the
              chunked and simple windowed pairs), the pair gather and its
              reduce, and the FMA-peak probe from
              egogaussian_tpu_torch/csrc, one nvcc per source in parallel,
              into one library
  3. kernels: each kernel against its plain PyTorch twin on the card, at
              D = 3 and 1, tile sizes 16 and 32, on three scenes (60
              Gaussians at 48x32, 2k at 256x192, a kNN-init deep-tile scene
              at 320x240); the exact-total backward also against the
              default one; the tile-grid kernels against themselves with
              the per-warp cull compiled out and both backwards twice, bit
              for bit, and so the chunked windowed pair; a hand-made
              layout that pins the tile-wide saturation vote
              (render/probe_layouts.py:quadrant_scene) and a hand-made
              window of the chunked pair's edge cases (window_probe);
              the simple windowed pair
              also against the chunked one and against its cull-off
              instances, bit for bit, and both windowed backwards twice,
              bit for bit, also on a hand-made window of the simple pair's
              edge cases (simple_window_probe: 300 and 258 rows, masked
              rows among live ones, an all-masked chunk and tile, alphas
              at the 0.99 clamp and the 1/255 gate); the stream pair
              against its cull-off
              instances and its backward twice, bit for bit, on every
              stream layout, and on a hand-made layout of its slot-run
              edge cases (stream_probe, whole and cut at the slot
              capacity); the cuda render (tile-grid and stream)
              against the oracle; the exact-total render's gradients
              within 5e-6; the scene axis (scene_axis_check): each case
              beside a second scene at twice its binning capacities in
              one launch of rows 1-7 against two one-scene launches, and
              so the twins, bit for bit; the layouts' pair gather at the
              static training cell's sizes (check_pair_gather) against its
              twins and autograd's index backward, bit for bit, with times
  4. slice:   (path 1) stage-1.0 static training (train_static) on a
              640x480 synthetic video with ~100k Gaussians, shortened
              schedule; launch counters must show the tile-grid kernels
              ran, and the pair gather and reduce once per compositor
              forward and backward; PLY round trip
  5. coarse:  (path 2) stage-2 coarse object pose (estimate_coarse_obj_pose)
              on the same video with the object model the slice hands
              over, shortened schedule, crop windows on; pose error against
              the video's ground truth; pose npz round trip
  6. flavors: (path 2) the stage-2 step from the coarse stage's final state
              under the default, exact-total and stream tile configs:
              gradients and 20 steps' losses against the default's, and a
              label (D = 1) render gradient per flavor; then the stream
              step in lockstep (stream_lockstep): two lanes (the crop
              window beside the full frame, the model beside itself padded
              to twice its capacity), 5 steps at S = 2, each lane bit for
              bit its own S = 1 steps
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
 10. pipeline: (path 5) the training CLI (cli/train.py) over all six
              stages on the slice's video exported in the reference's
              dataset layout, at a cut schedule (pipeline_flags): stage 1.0
              segments the object itself (label rate raised), stages 1.2
              and 2-6 follow; per-stage wall time, it/s and alive counts
              from the run's metrics.jsonl, stage 6's metrics (random
              LPIPS weights); every artifact of JAX's layout, at least
              MIN_OBJECT_GAUSSIANS handed to stage 2, every dynamic frame
              solved after stage 4, finite losses, no dropped pairs
 10b. checkpoint: (path 6) the same CLI command with --checkpoint_every
              CKPT_EVERY as a child process (this script with
              --train-child, which flushes its launch counts to a file),
              SIGKILLed as soon as static/ckpt_static_phase0.npz exists,
              restarted (stage 1.0 resumes mid-stage), SIGKILLed again as
              soon as a stage-3 ckpt_fine_obj.npz exists, restarted with
              --resume and run to the end: each restart's ckpt_resume
              record at its file's iteration, and the output against path
              5's within PATH6_TOL (alive counts at every handover, solved
              frames, poses, gaussians_all.ply, stage-6 PSNR / SSIM)
 10c. viewers: (path 7) on path 5's output at 640x480: render_trajectory
              and render_double_trajectory over every frame,
              render_freeview and render_multiview (tiled backend), one
              SIBR round trip through the network viewer, ply_tools
              recolor / info, build_native
 10d. multi: (path 8) cli/train_multi.py (--mesh 1x1, --seed 0) over
              path 5's exported video and a second one (seed MULTI_SEED,
              same sizes, 102,000 Gaussians) with path 5's flags, both in
              one lockstep (every training stage one batched step per
              iteration for both videos, one compositor launch for both
              scenes' tiles), as a child process (this script with
              --train-multi-child); its launch counts; then video 1 alone
              through the training CLI with --seed 1 (a child, not
              counted); per-stage seconds of the lockstep beside path 5's
              and video 1's own run's; checks after the counts: each video
              against its own run bit for bit, every file byte for byte
              (video 0 against path 5, video 1 against its own run);
              video 1's artifacts, handover, solved frames, losses, dropped
              pairs and stage 6, the launches against what the videos'
              records imply for a lockstep, a --resume rerun that trains
              nothing, every kernel against its twin on video 1's stage-3
              and stage-5 inputs; then CUDA kernels, runtime launch calls,
              ATen ops and wall ms per iteration at S = 1 and S = 2
              (torch.profiler) of the static step and, on path 5's stage-3
              start, the cropped stage-2 and stage-3 pose steps and the
              stage-5 step; and the stage-3 pose gradient of that start
              under doubled binning capacities, the model padded in the
              stack, a lockstep lane beside one of twice the capacity (all
              three bit for bit) and a model of twice its own capacity
              (pose_probe)
 10e. distributed: (path 9, the distributed layer; NCCL takes one GPU per
              rank, so the multi-rank runs are gloo ranks sharing the card)
              9a: train_static on path 1's video at DIST_SCHEDULE and frame
              batch 2 in this process, then twice in one 2-rank gloo
              mesh (one frame per rank; the video sent through host
              memory): both
              ranks' final models bit for bit, the PLYs written by rank 0
              alone, the second mesh run bit for bit the first, the mesh
              run against the single process within DIST_STATIC_TOL, step
              ms of both and the gloo all_gather of the step's buffer
              timed alone; 9b: _dp_static_step on a one-rank NCCL group
              against _static_step, DIST_STEPS steps bit for bit; 9c:
              make_sharded_render and make_memory_sharded_render on 2
              gloo ranks, path 3's kNN model at frame 0, backends "cuda"
              and "tiled", against the single render within DEEP_FWD_TOL
              with nothing dropped, and after the counts are read rows
              1-2 against their twins on slab 0's layout; 9d:
              cli/train_multi.py --mesh 2x1 --dist_backend gloo
              --stage1_only over path 8's videos and flags (a child), every
              stage-1.0/1.2 file byte for byte path 8's; 9e:
              parallel/dryrun.py:dryrun_multichip(2) (two gloo CPU ranks),
              the frame-data-parallel checks, then the scene-axis checks;
              9c-9e run in a thread beside path 6 (whose runs are checked
              by their files alone), 9a-9b alone after path 8
 11. peak:    (row 10's path) the card's float32 FMA rate through
              utils/peak.py:fma_peak_gflops, beside the published 67 TFLOP/s
 12. checks after the paths: path 7's renders against backend="cuda"
              (DEEP_FWD_TOL, 0 dropped pairs), the served bytes against
              send_image of render_gaussians, the recolored PLYs, the
              native PLY read and write against the numpy ones; the eval
              CLI on path 5's output against its
              stage 6 (PSNR within 1e-4 dB, SSIM within 1e-6) and the
              training CLI again with --resume (no stage retrains, the
              same metrics); path 3's frames against backend="cuda"
              (DEEP_FWD_TOL, 0 dropped pairs) and, on each frame's gather
              window, the chunked pair against its cull-off instances bit
              for bit, and every owner lookup of the frames' binning
              against its scan form (cummax) int for int; path 4 against
              the twins and the chunked pair,
              every kernel against its twin at path 2's own shapes, the
              FMA chain against its twin at the peak path's shapes (bit
              for bit) and the SM clock under an FMA load
 13. timing:  kernel vs plain twin (CUDA events) at the slice's shapes
              (rows 1-9 also at 1920x1080, rows 6-9 also with
              evaluation's own tile config, ts 16), the cull-off
              instances of rows 1-9, and each kernel's bound
              (bytes over the HBM rate or instructions over the float32
              instruction rate, whichever is larger) on the covered
              evaluations of the same inputs, beside the dense count's
              bound and the bound at the measured FMA rate; rows 1-7 at
              S = 2 (frames 0 and 1 in one launch) beside the sum of the
              two one-scene launches
 14. profile: torch.profiler over std-mode steps at the slice's size:
              device time by kernel and the device's busy share
              (table in chiprun_out/chip_smoke/profile.txt)
 15. eval profile: torch.profiler over render_results on 8 frames of path
              3(b), before (the owner lookups swapped for their cummax
              scan forms) and after: device time by op, busy share, host
              ops (chiprun_out/chip_smoke/eval_profile.txt); no cummax
              after
Launch counters are set to 0 just before each path and read just after.
Then the kernel table, the nvidia-smi line, and the result line
{"ok": true, "device": {...}}. With --pipeline-only, paths 5-8 and their
checks alone (no result line); --repro adds a second unbroken run of path
5's flags and prints its spread against path 5 (what PATH6_TOL holds).

Imports no JAX. Writes its outputs under chiprun_out/chip_smoke/.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import filecmp
import json
import os
import shutil
import subprocess
import sys
import threading
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
EMIT_LOCK = threading.Lock()  # paths 9c-9e emit from a thread beside path 6


STARTED = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase line, with the seconds since this process started the
    script (where the time goes)."""
    line = json.dumps({"phase": phase, **fields,
                       "elapsed_s": round(time.perf_counter() - STARTED, 2)})
    with EMIT_LOCK:
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


def check_window_probe(dev, errs):
    """The windowed kernels (check_window) on render/probe_layouts.py:
    window_probe at D = 3 and 1, ts 16 and 32: a tile three chunks deep,
    footprints across the quadrant and warp-patch edges, live rows past
    each count, an empty tile, pairs on either side of the 1/255 gate."""
    import torch

    from egogaussian_tpu_torch.render.probe_layouts import window_probe
    from egogaussian_tpu_torch.render.tiled import WindowLayout

    for ts in (16, 32):
        for d in (3, 1):
            counts, data, bg, n_tx, w, h = window_probe(d, ts)
            lay = WindowLayout(torch.as_tensor(counts, device=dev),
                               torch.as_tensor(data, device=dev),
                               torch.zeros((), dtype=torch.int64, device=dev), n_tx, 1, ts, 16)
            check_window("window_probe", lay, torch.as_tensor(bg[0], device=dev), FWD_TOL, w, h,
                         errs)


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
    unwritten, as the TPU kernel does); the backward on every slot. Then
    the forward (on the tiles the kernel writes) and the backward against
    the same kernels with the per-warp cull compiled out, and the backward
    run again, all bit for bit."""
    import torch

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
    written = torch.zeros(n_tiles, dtype=torch.bool, device=vals.device)
    written[meta[0].long()] = True
    n_out = sr.stream_forward_nocull(meta, vals, bg2, ts, n_tx, n_tiles)
    n_d = sr.stream_backward_nocull(meta, vals, bg2, p_out[3], *cots, ts, n_tx)
    r_d = sr.stream_backward(meta, vals, bg2, p_out[3], *cots, ts, n_tx)
    same = {"fwd_cull_off": all(torch.equal(a[written], b[written]) for a, b in zip(k_out, n_out)),
            "bwd_cull_off": torch.equal(k_d, n_d), "bwd_repeat": torch.equal(k_d, r_d)}
    grad_err = max_err(k_d, p_d)
    fwd_tol = dict(tol, logT=tol["image"])
    ok = (all(fwd_err[k] <= fwd_tol[k] for k in fwd_tol) and grad_excess(k_d, p_d) <= 0.0
          and all(same.values()))
    emit("stream_check", case=name, d=d, tile_size=ts, fwd_err=fwd_err,
         grad_max_abs_err=grad_err, grad_scale=float(p_d.abs().max()),
         slots=int(meta.shape[1]), bit_identical=same, ok=ok)
    if not ok:
        raise AssertionError(f"stream kernel vs twin or cull-off out of tolerance: {name} "
                             f"d={d} ts={ts}")
    errs.setdefault(("stream_fwd", d), []).append(max(fwd_err.values()))
    errs.setdefault(("stream_bwd", d), []).append(grad_err)


def check_stream_probe(dev, errs):
    """The stream pair (check_stream) on render/probe_layouts.py:stream_probe
    at D = 3 and 1, ts 16 and 32, whole and cut at the slot capacity:
    empty tiles between runs, a run of exactly two chunks, a one-pair tile,
    the empty last tile over the pure-padding tail, a run cut at n_slots,
    opaque rows past each count. Cotangents: seeded, scale 1e-2."""
    import torch

    from egogaussian_tpu_torch.render.probe_layouts import stream_probe
    from egogaussian_tpu_torch.render.tiled import StreamLayout

    for ts in (16, 32):
        for d in (3, 1):
            for cut in (False, True):
                meta, vals, bg, n_tx, _, _ = stream_probe(d, ts, cut)
                meta, vals = torch.as_tensor(meta, device=dev), torch.as_tensor(vals, device=dev)
                real = torch.zeros(n_tx, dtype=torch.bool, device=dev)
                real[meta[0].long()[meta[1] < meta[2]]] = True
                lay = StreamLayout(meta, vals, ~real, torch.zeros((), dtype=torch.int64,
                                                                  device=dev), n_tx, 1, ts)
                gen = torch.Generator(device=dev).manual_seed(13)
                cots = [torch.randn((n_tx, ts * ts, c), generator=gen, device=dev) * 1e-2
                        for c in (d, 1, 1)]
                check_stream(f"stream_probe{'_cut' if cut else ''}", lay, cots, d,
                             torch.as_tensor(bg[0], device=dev), FWD_TOL, errs)


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


def chunked_exactness(counts, data, bg2, ts, n_tx, k_out, logt, cots, k_d):
    """The chunked windowed pair's exactness checks on one window: the
    forward (outputs k_out) and the backward (gradient k_d, from logt and
    cots) against the same kernels with the per-warp cull compiled out, and
    the backward run again, all bit for bit."""
    import torch

    from egogaussian_tpu_torch.render import window_raster as wr

    n_out = wr.window_chunked_forward_nocull(counts, data, bg2, ts, n_tx)
    n_d = wr.window_chunked_backward_nocull(counts, data, bg2, logt, *cots, ts, n_tx)
    r_d = wr.window_chunked_backward(counts, data, bg2, logt, *cots, ts, n_tx)
    return {"fwd_cull_off": all(torch.equal(a, b) for a, b in zip(k_out, n_out)),
            "bwd_cull_off": torch.equal(k_d, n_d), "bwd_repeat": torch.equal(k_d, r_d)}


def simple_exactness(parts, bg2, ts, n_tx, k_out, cots, k_d):
    """The simple windowed pair's cull-off checks on one window (its five
    inputs `parts`): the forward (outputs k_out) and the backward (gradients
    k_d concatenated, from cots) against the same kernels with the per-warp
    cull compiled out, bit for bit."""
    import torch

    from egogaussian_tpu_torch.render import window_raster as wr

    n_out = wr.window_forward_nocull(*parts, bg2, ts, n_tx)
    n_d = torch.cat(wr.window_backward_nocull(*parts, bg2, *cots, ts, n_tx), dim=2)
    return {"simple_fwd_cull_off": all(torch.equal(a, b) for a, b in zip(k_out, n_out)),
            "simple_bwd_cull_off": torch.equal(k_d, n_d)}


def check_simple_probe(dev, errs):
    """The simple windowed pair on render/probe_layouts.py:
    simple_window_probe at D = 3 and 1, ts 16 and 32, 300 and 258 window
    rows (not a multiple of 128; not of 4, so staged by plain loads): masked
    rows among live ones, an all-masked chunk between live chunks, an
    all-masked tile, alphas at the 0.99 clamp and on either side of 1/255,
    a mean on a pixel centre, power clamped at 0, footprints across the
    quadrant and warp-patch edges. Against the twins (FWD_TOL; gradients
    within GRAD_ATOL + GRAD_RTOL), against the cull-off instances and the
    backward run twice, bit for bit. Cotangents: the CPU test's (seeded
    numpy, scale 1)."""
    import torch

    from egogaussian_tpu_torch.render import window_raster as wr
    from egogaussian_tpu_torch.render.probe_layouts import SIMPLE_PROBE_ROWS, simple_window_probe

    for ts in (16, 32):
        for d in (3, 1):
            for m in SIMPLE_PROBE_ROWS:
                *parts_np, bg, n_tx, _, _ = simple_window_probe(d, ts, m)
                parts = [torch.as_tensor(x, device=dev) for x in parts_np]
                bg2 = torch.as_tensor(bg, device=dev)
                n_tiles, p = parts[0].shape[0], ts * ts
                rng = np.random.RandomState(40 + d + ts)
                cots = [torch.as_tensor(rng.randn(n_tiles, p, c).astype(np.float32), device=dev)
                        for c in (d, 1, 1)]
                k_out = wr.window_forward(*parts, bg2, ts, n_tx)
                p_out = wr.composite_window_plain_fwd(*parts, bg2, ts, n_tx)
                fwd_err = {k: max_err(a, b) for k, a, b in
                           zip(("image", "alpha", "depth"), k_out, p_out)}
                k_d = torch.cat(wr.window_backward(*parts, bg2, *cots, ts, n_tx), dim=2)
                r_d = torch.cat(wr.window_backward(*parts, bg2, *cots, ts, n_tx), dim=2)
                p_d = torch.cat(wr.composite_window_plain_bwd(*parts, bg2, *cots, ts, n_tx),
                                dim=2)
                same = simple_exactness(parts, bg2, ts, n_tx, k_out, cots, k_d)
                same["simple_bwd_repeat"] = torch.equal(k_d, r_d)
                grad_err = max_err(k_d, p_d)
                ok = (all(fwd_err[k] <= FWD_TOL[k] for k in FWD_TOL)
                      and grad_excess(k_d, p_d) <= 0.0 and all(same.values()))
                emit("simple_probe_check", d=d, tile_size=ts, window_rows=m, fwd_err=fwd_err,
                     grad_max_abs_err=grad_err, grad_scale=float(p_d.abs().max()),
                     bit_identical=same, ok=ok)
                if not ok:
                    raise AssertionError(f"simple window probe: kernel vs twin or cull-off "
                                         f"d={d} ts={ts} m={m}")
                errs.setdefault(("window_fwd", d), []).append(max(fwd_err.values()))
                errs.setdefault(("window_bwd", d), []).append(grad_err)


def check_window(name, lay, bg, tol, width, height, errs):
    """The four windowed kernels on one window (window_layout): each against
    its plain twin (forward within `tol`, gradients within GRAD_ATOL +
    GRAD_RTOL), each backward run twice and bit-identical, both pairs
    against their cull-off instances bit for bit (chunked_exactness,
    simple_exactness), and the
    simple pair against the chunked pair on the same window (forward within
    `tol`, gradients within FLAVOR_TOL norm-relative: the simple backward
    takes the suffix as total - prefix, the chunked one sums it)."""
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
    same = chunked_exactness(counts, data, bg2, ts, n_tx, k_out, p_out[3], cots, k_d)
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
    same.update(simple_exactness(parts, bg2, ts, n_tx, ks_out, cots, ks_d))
    same["simple_bwd_repeat"] = torch.equal(ks_d, ks_d2)
    ok = (all(fwd_err[k] <= fwd_tol[k] for k in fwd_tol)
          and all(sfwd_err[k] <= tol[k] for k in tol)
          and all(cross_fwd[k] <= tol[k] for k in tol)
          and grad_excess(k_d, p_d) <= 0.0 and grad_excess(ks_d, ps_d) <= 0.0
          and cross_grad <= FLAVOR_TOL and all(same.values()))
    emit("window_check", case=name, d=d, tile_size=ts, window_rows=data.shape[1],
         deepest_tile=int(counts.max()), chunked_fwd_err=fwd_err,
         chunked_grad_max_abs_err=max_err(k_d, p_d), simple_fwd_err=sfwd_err,
         simple_grad_max_abs_err=max_err(ks_d, ps_d), simple_vs_chunked_fwd_err=cross_fwd,
         simple_vs_chunked_grad_norm_rel=cross_grad, grad_scale=float(p_d.abs().max()),
         bit_identical=same, ok=ok)
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

    def scene_cases(name, cam, means, cov3d, colors, ops, cfg_of, tol, other, twins=True):
        proj = project_gaussians(means, cov3d, cam.viewmat, cam.fx, cam.fy, cam.cx,
                                 cam.cy, cam.width, cam.height)
        labels = torch.as_tensor(
            np.random.RandomState(3).randn(means.shape[0], 1).astype(np.float32), device=dev)
        # the scene axis: a second scene (`other`: camera, means, covariances,
        # colors, opacities) at twice the binning capacities, in one launch
        cam2, means2, cov2, colors2, ops2 = other
        proj2 = project_gaussians(means2, cov2, cam2.viewmat, cam2.fx, cam2.fy, cam2.cx,
                                  cam2.cy, cam2.width, cam2.height)
        labels2 = torch.as_tensor(
            np.random.RandomState(4).randn(means2.shape[0], 1).astype(np.float32), device=dev)
        for ts in (16, 32):
            cfg = cfg_of(ts)
            cfg2 = dc.replace(cfg, max_pairs=2 * cfg.max_pairs,
                              max_per_tile=2 * cfg.max_per_tile,
                              max_slots=2 * (cfg.max_slots or cfg.max_pairs))
            for d, cols, cols2, bg in ((3, colors, colors2, torch.tensor([0.2, 0.1, 0.4],
                                                                         device=dev)),
                                       (1, labels, labels2, torch.zeros(1, device=dev))):
                scene_axis_check(f"{name}_scenes2", [(proj, cols, ops), (proj2, cols2, ops2)],
                                 [cfg, cfg2], [bg, torch.full_like(bg, 0.3)], cam.width,
                                 cam.height, dev, twins=twins)
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

    # 0) the tile-wide saturation vote and the windowed and stream pairs'
    # edge cases, pinned on hand-made layouts
    check_quadrant_vote(dev, errs)
    check_window_probe(dev, errs)
    check_simple_probe(dev, errs)
    check_stream_probe(dev, errs)
    # 1) 60 Gaussians at 48x32 (tests/test_pallas_raster.py:23-36)
    cam = look_at_camera(48, 32, dev)
    means, cov3d, colors, ops = random_scene(60, 11, dev)
    small_cfg = lambda ts: TileConfig(max_per_tile=256, max_pairs=8192, tile_size=ts)  # noqa: E731
    scene_cases("random60_48x32", cam, means, cov3d, colors, ops, small_cfg, FWD_TOL,
                (cam, *random_scene(60, 13, dev)))
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
    scene_cases("random2k_256x192", cam, means, cov3d, colors, ops, mid_cfg, FWD_TOL,
                (cam, *random_scene(2000, 14, dev)))

    # 3) kNN-init deep tiles at 320x240 (the bench's knn check scene)
    vid = make_synthetic_video(dev, **KNN_SCENE)
    model = from_points(vid.points, vid.colors, dev, spatial_lr_scale=1.2, seed=0)
    cam = vid.cameras[0]
    opac = torch.where(model.aux.alive, model.opacity, torch.zeros_like(model.opacity))
    knn_cfg = lambda ts: auto_tile_config(model, cam, tile_size=ts)  # noqa: E731
    scene_cases("knn_deep_320x240", cam, model.params.xyz, model.covariance(),
                model_colors(model), opac, knn_cfg, DEEP_FWD_TOL,
                (vid.cameras[1], model.params.xyz, model.covariance(), model_colors(model),
                 opac), twins=False)
    # 4) the layouts' pair gather at the static training cell's sizes
    check_pair_gather(dev)


HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's published HBM rate


def gather_cell_layouts(dev, n: int = 500_000, width: int = 1600, height: int = 900):
    """The pair gather's inputs at the static training cell's sizes
    (render/probe_layouts.py:gather_scene at ts 32 with estimated
    capacities), for the tile-grid, stream and window layouts: per layout
    (rows, index, transposed, dvals), dvals the gradient the layout's own
    compositor gives a loss of random weights."""
    import torch

    from egogaussian_tpu_torch.ops.covariance import covariance_from_scaling_rotation
    from egogaussian_tpu_torch.render import tiled
    from egogaussian_tpu_torch.render.camera import Camera, look_at
    from egogaussian_tpu_torch.render.probe_layouts import gather_scene
    from egogaussian_tpu_torch.render.project import ProjectedGaussians, project_gaussians

    means, scales, quats, colors, ops, focal = (
        torch.as_tensor(x, device=dev) if not isinstance(x, float) else x
        for x in gather_scene(n, width, height))
    R, tr = look_at(np.array([0.0, 0.0, -4.0]), np.zeros(3))
    cam = Camera.from_colmap(R, tr, focal, focal, width, height, device=dev)
    proj = project_gaussians(means, covariance_from_scaling_rotation(scales, quats),
                             cam.viewmat, cam.fx, cam.fy, cam.cx, cam.cy, width, height)
    cfg = tiled.estimate_tile_config(proj.means2d, proj.radii, width, height, tile_size=32,
                                     opacities=ops)
    lead = ProjectedGaussians(*(x.detach()[None].requires_grad_(x.is_floating_point())
                                for x in proj))
    out = {}
    real = tiled.gather_pairs
    for kind, fn, c in (("tilegrid", tiled.tilegrid_layout_scenes, cfg),
                        ("stream", tiled.stream_layout_scenes,
                         dataclasses.replace(cfg, compositor="stream")),
                        ("window", tiled.window_layout_scenes, cfg)):
        caps = tiled.scene_caps([c], [(width, height)], dev, means.shape[0])
        seen = {}

        def record(rows, index, transposed):
            vals = real(rows, index, transposed)
            vals.retain_grad()
            seen.update(rows=rows.detach(), index=index, transposed=transposed, vals=vals)
            return vals

        tiled.gather_pairs = record
        try:
            lay = fn(lead, colors[None], ops[None], caps)
        finally:
            tiled.gather_pairs = real
        image, alpha, depth = tiled._composite(lay, torch.zeros((1, 3), device=dev), caps)
        gen = torch.Generator(device=dev).manual_seed(0)
        loss = sum(torch.sum(x * torch.rand(x.shape, device=dev, generator=gen))
                   for x in (image, alpha, depth))
        loss.backward()
        out[kind] = (seen["rows"], seen["index"], seen["transposed"], seen["vals"].grad,
                     seen["vals"].detach(), int(lay.dropped.sum()))
    return out, cfg


def check_pair_gather(dev):
    """render/pair_gather.py at the static training cell's sizes
    (gather_cell_layouts): per layout, the gather kernel against rows[src]
    and the reduce kernel against its plain twin and against autograd's
    CUDA index backward of rows[src], on the layout compositor's own
    gradient, bit for bit (torch.equal: up to the sign of a zero); one
    launch of each kernel per layout forward and backward. Then, on the
    tile-grid layout (the training path), each kernel's time (CUDA events)
    beside its byte bound, the twins' times and autograd's rows[src]
    forward + backward (library_ms); one "pair_gather" line."""
    import torch

    from egogaussian_tpu_torch.render import pair_gather as pg

    pg.PairGather.reset_launch_counts()
    layouts, cfg = gather_cell_layouts(dev)
    launches = (pg.PairGather.gather_launches, pg.PairGather.reduce_launches)
    if launches != (3, 3):
        raise AssertionError(f"pair gather launches {launches}, not one pair per layout")
    line = dict(max_pairs=cfg.max_pairs, max_slots=cfg.max_slots,
                max_per_tile=cfg.max_per_tile)
    for kind, (rows, index, transposed, dvals, vals, dropped) in layouts.items():
        ch = rows.shape[1]
        if not torch.equal(vals, pg.gather_plain(rows, index.src, transposed)):
            raise AssertionError(f"pair gather {kind}: kernel != rows[src]")
        leaf = rows.clone().requires_grad_(True)
        (lib,) = torch.autograd.grad(pg.gather_plain(leaf, index.src, transposed), leaf, dvals)
        got = pg.reduce(dvals, index, ch, transposed)
        plain = pg.reduce_plain(dvals, index, ch, transposed)
        if not (torch.equal(got, plain) and torch.equal(got, lib)):
            raise AssertionError(
                f"pair reduce {kind}: kernel vs twin {max_err(got, plain):.3g}, "
                f"vs autograd {max_err(got, lib):.3g}")
        held = index.pair_slot >= 0
        line[kind] = dict(slots=index.src.shape[0], held_pairs=int(held.sum()), dropped=dropped,
                          tail_slots=int((index.src == index.src[-1]).sum()),
                          nonzero_grad_rows=int((lib != 0).any(1).sum()))
    rows, index, _, dvals, _, _ = layouts["tilegrid"]
    ch = rows.shape[1]
    n_slots, n_rows = index.src.shape[0], rows.shape[0]
    held = int((index.pair_slot >= 0).sum())
    gather_bytes = 4 * n_slots * ch + 8 * n_slots + 4 * n_rows * ch
    reduce_bytes = 8 * index.pair_slot.numel() + 3 * 8 * n_rows + 4 * held * ch + 4 * n_rows * ch
    leaf = rows.clone().requires_grad_(True)

    def library():
        torch.autograd.grad(pg.gather_plain(leaf, index.src, True), leaf, dvals)

    with torch.no_grad():
        t = dict(gather_ms=cuda_ms(lambda: pg.gather(rows, index, True)),
                 reduce_ms=cuda_ms(lambda: pg.reduce(dvals, index, ch, True)),
                 gather_plain_ms=cuda_ms(lambda: pg.gather_plain(rows, index.src, True)),
                 reduce_plain_ms=cuda_ms(lambda: pg.reduce_plain(dvals, index, ch, True),
                                         iters=3, warmup=1))
    t["library_ms"] = cuda_ms(library, iters=3, warmup=1)
    emit("pair_gather", **line, **t, gather_bound_ms=gather_bytes / HBM_BYTES_PER_S * 1e3,
         reduce_bound_ms=reduce_bytes / HBM_BYTES_PER_S * 1e3, gather_bytes=gather_bytes,
         reduce_bytes=reduce_bytes, launches=dict(gather=launches[0], reduce=launches[1]))


# ---------------------------------------------------------------------------
# The scene axis of rows 1-7 (the lockstep's one launch for all scenes): an
# S-scene launch against S one-scene launches
# ---------------------------------------------------------------------------

def scene_axis_layouts(scenes, cfgs, width, height):
    """One-scene tile-grid, stream and gather-window layouts of `scenes`
    (proj, colors, opacities per scene, one frame size) and their S-scene
    layouts (render/tiled.py tilegrid_layout_scenes, stream_layout_scenes,
    window_layout_scenes) over the scenes' own capacities."""
    import torch

    from egogaussian_tpu_torch.render.project import ProjectedGaussians
    from egogaussian_tpu_torch.render.tiled import (
        scene_caps,
        stream_layout,
        stream_layout_scenes,
        tilegrid_layout,
        tilegrid_layout_scenes,
        window_layout,
        window_layout_scenes,
    )

    singles = [(tilegrid_layout(p, c, o, width, height, cfg),
                window_layout(p, c, o, width, height, cfg),
                stream_layout(p, c, o, width, height, cfg))
               for (p, c, o), cfg in zip(scenes, cfgs)]
    proj = ProjectedGaussians(*(torch.stack(list(x)) for x in zip(*(s[0] for s in scenes))))
    caps = scene_caps(cfgs, [(width, height)] * len(scenes), scenes[0][1].device,
                      scenes[0][1].shape[0])
    cols = torch.stack([s[1] for s in scenes])
    ops = torch.stack([s[2] for s in scenes])
    return singles, (tilegrid_layout_scenes(proj, cols, ops, caps),
                     window_layout_scenes(proj, cols, ops, caps),
                     stream_layout_scenes(proj, cols, ops, caps))


SCENE_TWIN_TOL = 1e-5  # the twins' S-scene calls against their one-scene calls, on the card


def scene_axis_check(name, scenes, cfgs, bgs, width, height, dev, twins=True):
    """Rows 1-7 on S scenes in one launch against each scene's one-scene
    launch, bit for bit: forward outputs tile for tile (the stream pair's
    on the tiles that own a slot: it leaves the others unwritten), both
    tile-grid backward flavors slot for slot over each scene's fitting
    slots, the stream backward over each scene's own slots, the chunked
    backward row for row over each scene's own window (and zeros past
    both). With `twins`, the plain twins' S-scene calls against their
    one-scene calls the same way, within SCENE_TWIN_TOL: on the card
    cuBLAS picks the twins' batched products by batch count (on the CPU
    the twins agree bit for bit, tests/test_torch_multi_scene.py). Emits
    one scene_axis line; raises on any kernel difference."""
    import torch

    from egogaussian_tpu_torch.render import cuda_raster as cr
    from egogaussian_tpu_torch.render import stream_raster as sr
    from egogaussian_tpu_torch.render import window_raster as wr

    singles, (lay, wlay, slay) = scene_axis_layouts(scenes, cfgs, width, height)
    s_n = len(scenes)
    ts, n_tx = lay.tile_size, lay.n_tx
    n_t = lay.n_tx * lay.n_ty
    bg = torch.stack(bgs).contiguous()
    gen = torch.Generator(device=dev).manual_seed(5)
    same, errs_of = {}, {}

    def tiles(x, s):
        return x[s * n_t:(s + 1) * n_t]

    impls = [("kernel", cr.tilegrid_forward, cr.tilegrid_backward, wr.window_chunked_forward,
              wr.window_chunked_backward, sr.stream_forward, sr.stream_backward)]
    if twins:
        impls.append(("twin", cr.composite_tilegrid_plain_fwd, cr.composite_tilegrid_plain_bwd,
                      wr.composite_window_chunked_plain_fwd,
                      wr.composite_window_chunked_plain_bwd, sr.composite_stream_plain_fwd,
                      sr.composite_stream_plain_bwd))
    vals = lay.vals.detach().contiguous()
    data = wlay.data.detach().contiguous()
    svals = slay.vals.detach().contiguous()
    for kind, fwd, bwd, wfwd, wbwd, sfwd, sbwd in impls:
        with torch.no_grad():
            out = fwd(lay.meta, vals, bg, ts, n_tx)
            cot = [torch.randn(x.shape, generator=gen, device=dev) * 1e-3 for x in out]
            dv = {e: bwd(lay.meta, vals, bg, *out, *cot, ts, n_tx, exact_total=e)
                  for e in (False, True)}
            wout = wfwd(wlay.counts, data, bg, ts, n_tx)
            wcot = [torch.randn(x.shape, generator=gen, device=dev) * 1e-3 for x in wout[:3]]
            wdd = wbwd(wlay.counts, data, bg, wout[3], *wcot, ts, n_tx)
            sout = sfwd(slay.meta, svals, bg, ts, n_tx, s_n * n_t)
            sdv = sbwd(slay.meta, svals, bg, sout[3], *cot, ts, n_tx)
            ok, err = True, 0.0
            sps = vals.shape[0] // s_n
            srows = svals.shape[0] // s_n

            def agree(a, b):
                nonlocal err
                err = max(err, max_err(a, b))
                return torch.equal(a, b)

            for s, ((l1, w1, s1), b1) in enumerate(zip(singles, bgs)):
                v1 = l1.vals.detach().contiguous()
                b1 = b1[None].contiguous()
                o1 = fwd(l1.meta, v1, b1, ts, n_tx)
                ok &= all([agree(tiles(a, s), b) for a, b in zip(out, o1)])
                fit = int(l1.meta[2, 0])
                for e in (False, True):
                    d1 = bwd(l1.meta, v1, b1, *o1, *(tiles(c, s) for c in cot), ts, n_tx,
                             exact_total=e)
                    ok &= agree(dv[e][s * sps:s * sps + fit], d1[:fit])
                d1w = w1.data.detach().contiguous()
                wo1 = wfwd(w1.counts, d1w, b1, ts, n_tx)
                ok &= all([agree(tiles(a, s), b) for a, b in zip(wout, wo1)])
                wd1 = wbwd(w1.counts, d1w, b1, wo1[3], *(tiles(c, s) for c in wcot), ts, n_tx)
                m1 = d1w.shape[1]
                ok &= agree(tiles(wdd, s)[:, :m1], wd1)
                ok &= not bool(tiles(wdd, s)[:, m1:].any())
                sv1 = s1.vals.detach().contiguous()
                so1 = sfwd(s1.meta, sv1, b1, ts, n_tx, n_t)
                owned = ~s1.empty
                ok &= all([agree(tiles(a, s)[owned], b[owned]) for a, b in zip(sout, so1)])
                sd1 = sbwd(s1.meta, sv1, b1, so1[3], *(tiles(c, s) for c in cot), ts, n_tx)
                k = sv1.shape[0]
                ok &= agree(sdv[s * srows:s * srows + k], sd1)
                ok &= not bool(sdv[s * srows + k:(s + 1) * srows].any())
            same[kind] = bool(ok)
            errs_of[kind] = err
    twin_ok = not twins or errs_of["twin"] <= SCENE_TWIN_TOL
    emit("scene_axis", case=name, scenes=s_n, d=bg.shape[1], tile_size=ts, tiles=n_t * s_n,
         slots=vals.shape[0], stream_slots=svals.shape[0] // CHUNK_ROWS,
         window_rows=data.shape[1], bit_identical=same, max_abs_err=errs_of,
         ok=same["kernel"] and twin_ok)
    if not (same["kernel"] and twin_ok):
        raise AssertionError(f"scene axis: {name} S={s_n} d={bg.shape[1]} ts={ts}: an "
                             f"S-scene launch differs from the one-scene launches {same}")


def time_scene_axis(name, scenes, cfgs, bgs, width, height, dev):
    """Rows 1-7 at S = len(scenes): one S-scene launch against the sum of
    the one-scene launches (CUDA events; the layouts of
    scene_axis_layouts). Returns {key: (S-scene ms, sum of one-scene ms)}."""
    import torch

    from egogaussian_tpu_torch.render import cuda_raster as cr
    from egogaussian_tpu_torch.render import stream_raster as sr
    from egogaussian_tpu_torch.render import window_raster as wr

    singles, (lay, wlay, slay) = scene_axis_layouts(scenes, cfgs, width, height)
    bg = torch.stack(bgs).contiguous()
    ts, n_tx = lay.tile_size, lay.n_tx

    def ms_of(meta, vals, counts, data, smeta, svals, b):
        vals, data = vals.detach().contiguous(), data.detach().contiguous()
        svals = svals.detach().contiguous()
        n_t = meta.shape[1]
        with torch.no_grad():
            out = cr.tilegrid_forward(meta, vals, b, ts, n_tx)
            wout = wr.window_chunked_forward(counts, data, b, ts, n_tx)
            sout = sr.stream_forward(smeta, svals, b, ts, n_tx, n_t)
            return {
                "fwd": cuda_ms(lambda: cr.tilegrid_forward(meta, vals, b, ts, n_tx)),
                "bwd": cuda_ms(lambda: cr.tilegrid_backward(meta, vals, b, *out, *out, ts, n_tx)),
                "bwd_exact": cuda_ms(lambda: cr.tilegrid_backward(
                    meta, vals, b, *out, *out, ts, n_tx, exact_total=True)),
                "stream_fwd": cuda_ms(lambda: sr.stream_forward(smeta, svals, b, ts, n_tx, n_t)),
                "stream_bwd": cuda_ms(lambda: sr.stream_backward(
                    smeta, svals, b, sout[3], *sout[:3], ts, n_tx)),
                "window_chunked_fwd": cuda_ms(lambda: wr.window_chunked_forward(
                    counts, data, b, ts, n_tx)),
                "window_chunked_bwd": cuda_ms(lambda: wr.window_chunked_backward(
                    counts, data, b, wout[3], *wout[:3], ts, n_tx))}

    multi = ms_of(lay.meta, lay.vals, wlay.counts, wlay.data, slay.meta, slay.vals, bg)
    ones = [ms_of(l1.meta, l1.vals, w1.counts, w1.data, s1.meta, s1.vals, b[None].contiguous())
            for (l1, w1, s1), b in zip(singles, bgs)]
    times = {k: (multi[k], sum(o[k] for o in ones)) for k in multi}
    emit("scene_axis_timing", case=name, scenes=len(scenes), d=bg.shape[1], tile_size=ts,
         **{f"{k}_ms_s{len(scenes)}": v[0] for k, v in times.items()},
         **{f"{k}_ms_s1_sum": v[1] for k, v in times.items()},
         **{f"{k}_ms_s1": [o[k] for o in ones] for k in multi})
    return times


def nerfpp_radius(cameras) -> float:
    centers = np.stack([c.camera_center.cpu().numpy() for c in cameras])
    r = float(np.linalg.norm(centers - centers.mean(axis=0), axis=1).max()) * 1.1
    return r if r > 0 else 1.0


def slice_video(dev):
    """Path 1's video (ground truth rendered by the oracle on the card)."""
    import torch

    from egogaussian_tpu_torch.data import make_synthetic_video

    t0 = time.time()
    vid = make_synthetic_video(dev, seed=0, **SLICE_VIDEO)
    torch.cuda.synchronize()
    emit("slice_data", width=vid.cameras[0].width, height=vid.cameras[0].height,
         gaussians=len(vid.points),
         frames=len(vid.cameras), seconds=time.time() - t0)
    return vid


def phase_slice(dev, vid, out_dir):
    import torch

    from egogaussian_tpu_torch.config import Config
    from egogaussian_tpu_torch.data import split_viewpoints_by_phase
    from egogaussian_tpu_torch.models.gaussians import load_ply, save_ply
    from egogaussian_tpu_torch.render.cuda_raster import TileGridCompositor
    from egogaussian_tpu_torch.render.pair_gather import PairGather
    from egogaussian_tpu_torch.train.static import train_static

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
    PairGather.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = train_static(vid.cameras, vid.points, vid.colors, cfg, groups, extent,
                       save_dir=out_dir, seed=0, first_phase_only=True, device=dev,
                       on_step=on_step)[0]
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {"fwd": dict(TileGridCompositor.fwd_launches),
                "bwd": dict(TileGridCompositor.bwd_launches),
                "pair_gather": PairGather.gather_launches,
                "pair_reduce": PairGather.reduce_launches}
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
    # every tile-grid layout gathers through the pair gather, and every
    # backward through its reduce
    if (launches["pair_gather"], launches["pair_reduce"]) != (
            sum(launches["fwd"].values()), sum(launches["bwd"].values())):
        raise AssertionError(f"pair gather launches {launches} do not follow the compositor's")
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

    from egogaussian_tpu_torch.render.pair_gather import PairGather
    from egogaussian_tpu_torch.utils.peak import FmaChain

    out = {"fma_peak": FmaChain.launches, "pair_gather": PairGather.gather_launches,
           "pair_reduce": PairGather.reduce_launches}
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
    from egogaussian_tpu_torch.render.pair_gather import PairGather
    from egogaussian_tpu_torch.render.stream_raster import StreamCompositor
    from egogaussian_tpu_torch.render.window_raster import WindowChunkedCompositor, WindowCompositor
    from egogaussian_tpu_torch.utils.peak import FmaChain

    for fn in (TileGridCompositor, StreamCompositor, WindowChunkedCompositor, WindowCompositor,
               FmaChain, PairGather):
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


STREAM_LOCKSTEP_STEPS = 5


def trees_equal(a, b) -> bool:
    """Every tensor of two trees of dataclasses bit for bit (other leaves
    ignored)."""
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if dataclasses.is_dataclass(a):
        return all(trees_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return True


def phase_stream_lockstep(model, cfg, fr, dyn, seq):
    """The stage-2 pose step with compositor="stream" in lockstep (rows 4-5
    with the scene axis): two lanes, the flavor frame's state (its crop
    window) and the coarse model padded to twice its capacity at the
    previous dynamic frame's pose (the full frame), STREAM_LOCKSTEP_STEPS
    steps of pose_scenes_step at S = 2 against each lane's own pose_step
    at S = 1: losses, models, poses and both Adam states bit for bit."""
    import torch

    from egogaussian_tpu_torch.models.gaussians import ensure_capacity
    from egogaussian_tpu_torch.models.optim import adam_init
    from egogaussian_tpu_torch.models.pose import pose_from_rt
    from egogaussian_tpu_torch.parallel.multi_scene import stack_scenes, unstack_scenes
    from egogaussian_tpu_torch.render.tiled import scene_caps
    from egogaussian_tpu_torch.train.coarse_pose import (
        _coarse_lr_tree,
        _coarse_pose_lrs,
        pose_scenes_step,
        pose_step,
    )

    cp = cfg.coarse
    dev = model.device
    scfg = dataclasses.replace(fr.base, compositor="stream")
    padded, _, _ = ensure_capacity(model, adam_init(model.params), min_free=model.capacity + 1)
    f1 = dyn[-2] if len(dyn) > 1 else fr.f
    lanes = [dict(model=model, f=fr.f, pose=fr.pose0, crop=fr.crop),
             dict(model=padded, f=f1, pose=pose_from_rt(seq.rotations[f1], seq.translations[f1]),
                  crop=None)]
    it = cp.warm_up_iter + 1
    lrs = _coarse_lr_tree(model, it, cfg.opt, cp, False)
    plr_t, plr_r = _coarse_pose_lrs(it, cfg.opt, cp)
    lam = dict(lambda_image=cp.lambda_image, lambda_dssim=cp.lambda_dssim,
               lambda_l1_alpha=cp.lambda_Ll1_alpha, lambda_l2_alpha=cp.lambda_Ll2_alpha,
               backend="cuda")
    zero3 = torch.zeros((3,), dtype=torch.int32, device=dev)
    drop = torch.zeros((), dtype=torch.int64, device=dev)
    singles = []
    for ln in lanes:
        state = (ln["model"], adam_init(ln["model"].params), ln["pose"], adam_init(ln["pose"]))
        losses = []
        for _ in range(STREAM_LOCKSTEP_STEPS):
            out = pose_step(*state, fr.batch, ln["f"], fr.table_T[ln["f"]],
                            fr.table_R[ln["f"]], lrs, plr_t, plr_r, True, drop, True,
                            tile_config=scfg, crop_size=ln["crop"],
                            crop_max=zero3 if ln["crop"] is not None else 0, **lam)
            state = out[:4]
            losses.append(out[4])
        singles.append((state, torch.stack(losses)))
    w, h = fr.batch.width, fr.batch.height
    caps = scene_caps([scfg, scfg], [ln["crop"] or (w, h) for ln in lanes], dev,
                      padded.capacity)
    crop = any(ln["crop"] is not None for ln in lanes)
    state = (stack_scenes([ln["model"] for ln in lanes]),
             stack_scenes([adam_init(ln["model"].params) for ln in lanes]),
             stack_scenes([ln["pose"] for ln in lanes]),
             stack_scenes([adam_init(ln["pose"]) for ln in lanes]))
    fs = torch.tensor([ln["f"] for ln in lanes], device=dev)
    losses = []
    before = launch_counts()
    for _ in range(STREAM_LOCKSTEP_STEPS):
        out = pose_scenes_step(*state, stack_scenes([fr.batch, fr.batch]), fs, fr.table_T[fs],
                               fr.table_R[fs], lrs, plr_t, plr_r, True, drop.repeat(2),
                               [True, True], caps=caps, crop=crop,
                               crop_max=zero3.repeat(2, 1) if crop else 0, **lam)
        state = out[:4]
        losses.append(out[4])
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in ("stream_fwd_d3", "stream_bwd_d3")}
    caps_n = [ln["model"].capacity for ln in lanes]
    views = [unstack_scenes(state[0], 2, caps_n), unstack_scenes(state[1], 2, caps_n),
             unstack_scenes(state[2], 2), unstack_scenes(state[3], 2)]
    losses = torch.stack(losses)
    same = [torch.equal(losses[:, j], one_losses)
            and all(trees_equal(v[j], b) for v, b in zip(views, one))
            for j, (one, one_losses) in enumerate(singles)]
    ok = all(same) and all(n == STREAM_LOCKSTEP_STEPS for n in launches.values())
    emit("stream_lockstep", frames=[ln["f"] for ln in lanes], crops=[ln["crop"] for ln in lanes],
         capacities=caps_n, steps=STREAM_LOCKSTEP_STEPS, launches=launches,
         losses=losses.cpu().numpy().tolist(), lanes_bit_for_bit=same, ok=ok)
    if not ok:
        raise AssertionError(f"stream lockstep: a lane parts from its own steps {same}, "
                             f"launches {launches}")


def phase_frame_kernels(model, fr, errs, prefix=""):
    """Every kernel against its twin at the shapes path 2 gives it, on the
    flavor frame's state `fr`: the posed object model's cropped
    projection, built as pose_loss_grads renders it (D = 3, crop window
    with a partial bottom tile row; the full frame when fr.crop is None),
    and the label render's full-frame projection (D = 1); the windowed
    kernels on the gather windows of the same projections and tile config.
    `prefix` starts every case name."""
    import torch

    from egogaussian_tpu_torch.models.pose import pose_to_se3
    from egogaussian_tpu_torch.render.crop import crop_window, mask_rect
    from egogaussian_tpu_torch.render.project import project_gaussians
    from egogaussian_tpu_torch.render.tiled import stream_layout, tilegrid_layout, window_layout
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
        window = "crop" if fr.crop is not None else "full"
        cases = [(f"{prefix}frame{fr.f}_{window}_{w}x{h}", proj, model_colors(model), w, h,
                  torch.zeros(3, device=model.device))]
        # D = 1: the label render, unmoved geometry, full frame
        cases.append((f"{prefix}frame{fr.f}_label_{cam.width}x{cam.height}",
                      project(model.params.xyz, model.covariance()), model.params.label,
                      cam.width, cam.height, torch.zeros(1, device=model.device)))
        for case, pr, cols, cw, ch, bg in cases:
            lay = tilegrid_layout(pr, cols, opac, cw, ch, fr.base)
            slay = stream_layout(pr, cols, opac, cw, ch, scfg)
            if int(lay.dropped) or int(slay.dropped):
                raise AssertionError(f"{case}: pairs dropped")
            wlay = window_layout(pr, cols, opac, cw, ch, fr.base)
            if int(wlay.dropped):
                raise AssertionError(f"{case}: window pairs dropped")
            with torch.enable_grad():
                cots = check_layout(case, lay, cols.shape[1], bg, FWD_TOL, cw, ch, errs)
                check_window(case, wlay, bg, FWD_TOL, cw, ch, errs)
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
    8-bit quantization of the tiled render. On each frame's gather window
    (built as the tiled render builds it; the chunked forward on it must
    give the render's image bit for bit) the chunked pair against its
    cull-off instances and the backward repeated, bit for bit
    (chunked_exactness, cotangents of scale 1e-3). Every owner lookup of
    these frames' binning (bin_pairs' pair expansion, the tile-grid
    layout's slot streams) against its scan form, int for int
    (owner_lookups "check")."""
    import torch

    from egogaussian_tpu_torch.eval.render_results import _quantize8
    from egogaussian_tpu_torch.render import window_raster as wr
    from egogaussian_tpu_torch.render.project import project_gaussians
    from egogaussian_tpu_torch.render.tiled import _untile, window_layout
    from egogaussian_tpu_torch.train.common import (
        auto_tile_config,
        model_colors,
        render_gaussians,
    )

    accum_T, accum_R = seq.accum_T(), seq.accum_R()
    bg = torch.zeros(3, device=model.device)
    by_name = {e["name"]: e["render"] for b in buckets.values() for e in b}
    worst = {k: 0.0 for k in DEEP_FWD_TOL}
    dropped = {"tiled": 0, "cuda": 0}
    same_as_results = True
    exact = {"window_gives_the_render": True}
    gen = torch.Generator(device=model.device).manual_seed(11)
    is_obj = (model.aux.is_object == 1)[:, None]
    owners = {}
    with torch.no_grad(), owner_lookups("check", owners):
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
            # the frame's gather window, as render_gaussians -> composite_tiled build it
            xyz = model.params.xyz
            xyz = torch.where(is_obj, xyz @ accum_T[f][:3, :3].T + accum_T[f][:3, 3], xyz)
            proj = project_gaussians(xyz, model.covariance_rotated(accum_R[f], 1), cam.viewmat,
                                     cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                                     valid_mask=model.aux.alive)
            lay = window_layout(proj, model_colors(model), model.opacity, cam.width, cam.height)
            data, bg2 = lay.data.contiguous(), bg[None].contiguous()
            k_out = wr.window_chunked_forward(lay.counts, data, bg2, lay.tile_size, lay.n_tx)
            exact["window_gives_the_render"] &= torch.equal(
                _untile(k_out[0], lay.n_tx, lay.n_ty, lay.tile_size, cam.width, cam.height),
                rt.image)
            cots = [torch.randn(x.shape, generator=gen, device=x.device) * 1e-3
                    for x in k_out[:3]]
            k_d = wr.window_chunked_backward(lay.counts, data, bg2, k_out[3], *cots,
                                             lay.tile_size, lay.n_tx)
            for k, v in chunked_exactness(lay.counts, data, bg2, lay.tile_size, lay.n_tx, k_out,
                                          k_out[3], cots, k_d).items():
                exact[k] = exact.get(k, True) and v
    owners_equal = (set(owners) == {"pair_owner", "slot_owner"}
                    and not any(v["mismatched"] for v in owners.values()))
    ok = (all(worst[k] <= DEEP_FWD_TOL[k] for k in worst) and not any(dropped.values())
          and same_as_results and all(exact.values()) and owners_equal)
    emit("eval_vs_cuda", frames=len(vid.cameras), max_abs_err=worst, tol=DEEP_FWD_TOL,
         dropped_pairs=dropped, results_are_quantized_tiled_renders=same_as_results,
         tile_size=lay.tile_size, tiles=int(lay.counts.shape[0]), bit_identical=exact,
         owner_lookup_vs_scan=owners, ok=ok)
    if not ok:
        raise AssertionError(f"tiled eval renders disagree with cuda, the cull-off kernels or "
                             f"the owner scan: {worst}, {dropped}, {exact}, {owners}")


def _scan_owner(n_slots, starts, vals):
    """vals scattered with max at their start slots (starts outside
    [0, n_slots) drop out), then a running max over the slots."""
    import torch

    idx = torch.where((starts >= 0) & (starts < n_slots), starts,
                      torch.full_like(starts, n_slots))
    buf = torch.zeros(n_slots + 1, dtype=torch.int64, device=starts.device)
    buf.scatter_reduce_(0, idx, vals.to(torch.int64), reduce="amax", include_self=True)
    return torch.cummax(buf[:n_slots], 0).values


def scan_pair_owner(offsets, counts, n_slots):
    """The scan form of render/tiled.py:pair_owner, as the port computed it
    before the parallel lookup (and the JAX package still does): each
    Gaussian of count > 0 marked with g + 1 at its start slot, a running
    max, minus one. A check only: the port does not call it. A leading
    scene axis ([S, N], as render/tiled.py:bin_scenes passes) is scanned
    scene by scene."""
    import torch

    if offsets.dim() == 2:
        return torch.stack([scan_pair_owner(o, c, n_slots) for o, c in zip(offsets, counts)])
    n = offsets.shape[0]
    start = torch.where(counts > 0, offsets, torch.full_like(offsets, n_slots))
    marks = torch.arange(1, n + 1, dtype=torch.int64, device=offsets.device)
    return torch.clamp(_scan_owner(n_slots, start, marks) - 1, 0, max(n - 1, 0))


def scan_slot_owner(starts2, n_slots):
    """The scan form of render/tiled.py:slot_owner (check only; a leading
    scene axis is scanned scene by scene)."""
    import torch

    if starts2.dim() == 2:
        return torch.stack([scan_slot_owner(s, n_slots) for s in starts2])
    tiles = torch.arange(starts2.shape[0], dtype=torch.int64, device=starts2.device)
    return _scan_owner(n_slots, starts2, tiles)


@contextlib.contextmanager
def owner_lookups(mode, stats=None):
    """Swap render/tiled.py's owner lookups for a while. mode "scan": the
    scan forms run in their place (the binning as it was before the
    parallel lookup, for the eval profile's before); mode "check": both
    forms run and are compared int for int, stats counting calls and
    mismatches per lookup."""
    from egogaussian_tpu_torch.render import tiled

    lookups = {"pair_owner": (tiled.pair_owner, scan_pair_owner),
               "slot_owner": (tiled.slot_owner, scan_slot_owner)}

    def swap(name, new, scan):
        def checked(*args):
            out = new(*args)
            st = stats.setdefault(name, {"calls": 0, "slots": 0, "mismatched": 0})
            st["calls"] += 1
            st["slots"] += out.numel()
            st["mismatched"] += int((out != scan(*args)).sum())
            return out
        setattr(tiled, name, scan if mode == "scan" else checked)

    try:
        for name, (new, scan) in lookups.items():
            swap(name, new, scan)
        yield
    finally:
        for name, (new, _) in lookups.items():
            setattr(tiled, name, new)


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
    1-3; the stream rows only with a stream layout slay): the evaluations
    the data needs (gated alpha > 0; the three layouts come from one
    binning that dropped no pair, so they hold the same pairs and the
    tile-grid layout's count is every row's) and the bytes each kernel
    must move (the pair rows it needs read once, per-pixel planes, every
    gradient row it writes)."""
    f = 4
    out, cov, dense = tilegrid_bounds(d, p, lay, instr_per_s)
    n_tiles, pp = lay.meta.shape[1], lay.n_tx * lay.n_ty * p
    ch = 7 + d
    out_bytes = pp * (d + 2) * f
    cot_bytes = out_bytes
    if slay is not None:
        cnt = lay.meta[1].long()
        used_slots = int(((cnt + CHUNK_ROWS - 1) // CHUNK_ROWS).sum())
        srow_bytes = used_slots * CHUNK_ROWS * ch * f
        out.update({
            ("stream_fwd", d): bounds_of("fwd", d, cov, dense, 16 * slay.meta.shape[1]
                                         + srow_bytes + out_bytes + pp * f, instr_per_s),
            ("stream_bwd", d): bounds_of("bwd", d, cov, dense, 16 * slay.meta.shape[1]
                                         + srow_bytes + pp * f + cot_bytes
                                         + slay.vals.numel() * f, instr_per_s),
        })
    wcnt = wlay.counts.long()
    t_rows = wlay.data.shape[0] * wlay.data.shape[1]
    need_rows = int(wcnt.sum()) * ch * f
    out.update({
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


def time_window_chunked(counts, data, bg2, ts, n_tx, dev):
    """Rows 6-7 (kernel ms, plain twin ms) on one gather window, with random
    cotangents of scale 1e-3 on the kernel's outputs (time_tilegrid's, on
    the same shapes); and the cull-off instances' ms."""
    import torch

    from egogaussian_tpu_torch.render import window_raster as wr

    out = wr.window_chunked_forward(counts, data, bg2, ts, n_tx)
    gen = torch.Generator(device=dev).manual_seed(1)
    cot = [torch.randn(x.shape, generator=gen, device=dev) * 1e-3 for x in out[:3]]
    times = {
        "window_chunked_fwd": (
            cuda_ms(lambda: wr.window_chunked_forward(counts, data, bg2, ts, n_tx)),
            cuda_ms(lambda: wr.composite_window_chunked_plain_fwd(counts, data, bg2, ts, n_tx),
                    iters=5, warmup=1)),
        "window_chunked_bwd": (
            cuda_ms(lambda: wr.window_chunked_backward(counts, data, bg2, out[3], *cot, ts,
                                                       n_tx)),
            cuda_ms(lambda: wr.composite_window_chunked_plain_bwd(counts, data, bg2, out[3],
                                                                  *cot, ts, n_tx),
                    iters=5, warmup=1))}
    nocull = {
        "window_chunked_fwd": cuda_ms(lambda: wr.window_chunked_forward_nocull(
            counts, data, bg2, ts, n_tx)),
        "window_chunked_bwd": cuda_ms(lambda: wr.window_chunked_backward_nocull(
            counts, data, bg2, out[3], *cot, ts, n_tx))}
    return times, nocull


def time_window_simple(parts, bg2, ts, n_tx, dev):
    """Rows 8-9 (kernel ms, plain twin ms) on one window's five inputs, with
    random cotangents of scale 1e-3 on the kernel's outputs
    (time_window_chunked's); and the cull-off instances' ms."""
    import torch

    from egogaussian_tpu_torch.render import window_raster as wr

    out = wr.window_forward(*parts, bg2, ts, n_tx)
    gen = torch.Generator(device=dev).manual_seed(1)
    cot = [torch.randn(x.shape, generator=gen, device=dev) * 1e-3 for x in out]
    times = {
        "window_fwd": (
            cuda_ms(lambda: wr.window_forward(*parts, bg2, ts, n_tx)),
            cuda_ms(lambda: wr.composite_window_plain_fwd(*parts, bg2, ts, n_tx, 16), iters=3,
                    warmup=1)),
        "window_bwd": (
            cuda_ms(lambda: wr.window_backward(*parts, bg2, *cot, ts, n_tx)),
            cuda_ms(lambda: wr.composite_window_plain_bwd(*parts, bg2, *cot, ts, n_tx, 16),
                    iters=3, warmup=1))}
    nocull = {
        "window_fwd": cuda_ms(lambda: wr.window_forward_nocull(*parts, bg2, ts, n_tx)),
        "window_bwd": cuda_ms(lambda: wr.window_backward_nocull(*parts, bg2, *cot, ts, n_tx))}
    return times, nocull


def time_stream(meta, vals, bg2, ts, n_tx, n_tiles, cot):
    """Rows 4-5 (kernel ms, plain twin ms) on one stream layout, with the
    cotangents cot (time_tilegrid's, on the same shapes); and the cull-off
    instances' ms."""
    from egogaussian_tpu_torch.render import stream_raster as sr

    out = sr.stream_forward(meta, vals, bg2, ts, n_tx, n_tiles)
    times = {
        "stream_fwd": (
            cuda_ms(lambda: sr.stream_forward(meta, vals, bg2, ts, n_tx, n_tiles)),
            cuda_ms(lambda: sr.composite_stream_plain_fwd(meta, vals, bg2, ts, n_tx, n_tiles),
                    iters=5, warmup=1)),
        "stream_bwd": (
            cuda_ms(lambda: sr.stream_backward(meta, vals, bg2, out[3], *cot, ts, n_tx)),
            cuda_ms(lambda: sr.composite_stream_plain_bwd(meta, vals, bg2, out[3], *cot, ts,
                                                          n_tx), iters=5, warmup=1))}
    nocull = {
        "stream_fwd": cuda_ms(lambda: sr.stream_forward_nocull(meta, vals, bg2, ts, n_tx,
                                                               n_tiles)),
        "stream_bwd": cuda_ms(lambda: sr.stream_backward_nocull(meta, vals, bg2, out[3], *cot,
                                                                ts, n_tx))}
    return times, nocull


def phase_timing(dev, vid, extent, errs, peak_gflops):
    """Kernel vs plain twin (CUDA events) on the kNN-initialized model of the
    slice (its heaviest, ~100k Gaussians, the state std mode starts from),
    D = 3 (image) and D = 1 (label), on frame 0 in three configurations:
      main:        640x480 with its auto tile config (ts 32): every kernel;
      eval_config: 640x480 with no tile config, as evaluation renders it
                   (ts 16, 1,200 tiles; path 4's window): rows 6-9;
      frame_1080:  1920x1080 (frame_1080) with its auto tile config, where
                   the grid fills the card: rows 1-9.
    Every layout is checked first (check_layout, check_window,
    check_stream), and the cull-off instances are timed beside rows 1-9. Each kernel's
    bound on the same inputs: on the covered evaluations (gated alpha > 0)
    at the published rate, on the dense count (pairs x pixels), and on
    the covered evaluations at the FMA rate this run measured. Returns the main configuration's times and bounds."""
    import torch

    from egogaussian_tpu_torch.render.project import project_gaussians
    from egogaussian_tpu_torch.render.tiled import stream_layout, tilegrid_layout, window_layout
    from egogaussian_tpu_torch.train.common import auto_tile_config, model_colors

    instr_per_s = peak_gflops * 1e9 / 2  # FMA = 2 flops, 1 instruction
    model = knn_model(dev, vid, extent)
    opac = torch.where(model.aux.alive, model.opacity, torch.zeros_like(model.opacity))
    times, bounds = {}, {}
    cam0, cam1080 = vid.cameras[0], frame_1080(vid.cameras[0])
    cases = (("main", cam0, auto_tile_config(model, cam0)), ("eval_config", cam0, None),
             ("frame_1080", cam1080, auto_tile_config(model, cam1080)))
    for kind, cam, cfg in cases:
        proj = project_gaussians(model.params.xyz, model.covariance(), cam.viewmat, cam.fx,
                                 cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                                 valid_mask=model.aux.alive)
        for d, cols, bg in ((3, model_colors(model), torch.zeros(3, device=dev)),
                            (1, model.params.label, torch.zeros(1, device=dev))):
            lay = tilegrid_layout(proj, cols, opac, cam.width, cam.height, cfg)
            wlay = window_layout(proj, cols, opac, cam.width, cam.height, cfg)
            if int(lay.dropped) or int(wlay.dropped):
                raise AssertionError(f"timing frame {cam.width}x{cam.height} {kind}: "
                                     "pairs dropped")
            meta, vals = lay.meta, lay.vals.detach().contiguous()
            ts, n_tx = lay.tile_size, lay.n_tx
            p, n_tiles = ts * ts, lay.n_tx * lay.n_ty
            case = f"timing_{cam.width}x{cam.height}_ts{ts}_d{d}"
            bg2 = bg[None].contiguous()
            t, nocull = {}, {}
            if kind != "eval_config":
                cots = check_layout(case, lay, d, bg, FWD_TOL, cam.width, cam.height, errs)
                with torch.no_grad():
                    t, nocull, _, cot = time_tilegrid(meta, vals, bg2, ts, n_tx, dev)
            check_window(case, wlay, bg, FWD_TOL, cam.width, cam.height, errs)
            counts_w, data = wlay.counts, wlay.data.detach().contiguous()
            with torch.no_grad():
                tw, nw = time_window_chunked(counts_w, data, bg2, ts, n_tx, dev)
            t.update(tw)
            nocull.update(nw)
            slay = None
            if kind != "eval_config":
                slay = stream_layout(proj, cols, opac, cam.width, cam.height,
                                     dataclasses.replace(cfg, compositor="stream"))
                if int(slay.dropped):
                    raise AssertionError(f"timing frame {case}: stream pairs dropped")
                check_stream(case, slay, cots, d, bg, FWD_TOL, errs)
                with torch.no_grad():
                    tst, nst = time_stream(slay.meta, slay.vals.detach().contiguous(), bg2, ts,
                                           n_tx, n_tiles, cot)
                t.update(tst)
                nocull.update(nst)
            with torch.no_grad():
                tsw, nsw = time_window_simple(split_window(wlay), bg2, ts, n_tx, dev)
            t.update(tsw)
            nocull.update(nsw)
            b, counts = kernel_bounds(d, p, lay, slay, wlay, instr_per_s)
            if kind == "main":
                times.update({(k, d): v for k, v in t.items()})
                bounds.update(b)
                # the scene axis at this frame: frames 0 and 1 in one launch
                # against two one-scene launches (checked, then timed)
                cam1 = vid.cameras[1]
                proj1 = project_gaussians(model.params.xyz, model.covariance(), cam1.viewmat,
                                          cam1.fx, cam1.fy, cam1.cx, cam1.cy, cam1.width,
                                          cam1.height, valid_mask=model.aux.alive)
                two = [(proj, cols, opac), (proj1, cols, opac)]
                cfgs = [cfg, auto_tile_config(model, cam1)]
                scene_axis_check(f"{case}_scenes2", two, cfgs, [bg, bg], cam.width, cam.height,
                                 dev, twins=False)
                for k, v in time_scene_axis(f"{case}_scenes2", two, cfgs, [bg, bg], cam.width,
                                            cam.height, dev).items():
                    times[("scenes2", k, d)] = v
            keys = [k for k in KERNELS if k in t]
            emit("timing", frame=f"{cam.width}x{cam.height}", config=kind, d=d, tile_size=ts,
                 gaussians=int(model.num_alive), tiles=n_tiles, deepest_tile=int(meta[1].max()),
                 pairs=int(meta[1].sum()), evaluations=counts,
                 measured_fp32_gflops=peak_gflops, slots=vals.shape[0],
                 window_rows=data.shape[1], dropped=0,
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


def device_rows(prof, n):
    """(device ms, calls, name) per device op of a torch.profiler run, each
    per unit of n (iterations or frames), largest first."""
    import torch

    rows = []
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith("ProfilerStep")):
            continue  # host-side ops; their device time is their kernels'
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        rows.append((dev_us / n / 1e3, e.count / n, e.key))
    return sorted(rows, reverse=True)


def profile_eval(cams, model, seq):
    """render_results on cams, timed unprofiled, then once under
    torch.profiler: (unprofiled ms/frame, profiled ms/frame, device rows,
    host rows), rows per frame (device_rows)."""
    import torch

    from egogaussian_tpu_torch.eval.render_results import render_results

    frames = len(cams)
    render_results(cams[:2], model, seq, backend="auto")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_results(cams, model, seq, backend="auto")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / frames
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        render_results(cams, model, seq, backend="auto")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    host = sorted(((e.self_cpu_time_total / frames / 1e3, e.count / frames, e.key)
                   for e in prof.key_averages() if e.self_cpu_time_total > 0), reverse=True)
    return plain_ms, wall_ms, device_rows(prof, frames), host


def phase_eval_profile(dev, vid, model, seq, out_dir, frames: int = 8):
    """Where stage 6 spends its time per frame: render_results (path 3(b)'s
    call: the tiled backend at 640x480 on the 102k kNN model) on the first
    `frames` frames (profile_eval), twice: "before", with bin_pairs' and the
    layouts' owner lookups swapped for their scan forms (owner_lookups
    "scan": the binning before the parallel lookup), and "after", the port
    as it is. Device time by op, the device's busy share of the profiled
    wall time, and the host ops by self CPU time; tables in
    out_dir/eval_profile.txt. The "after" profile must show no cummax, on
    the device or the host. A measurement only: nothing in the eval path
    changes."""
    cams = vid.cameras[:frames]
    with open(os.path.join(out_dir, "eval_profile.txt"), "w") as f:
        for label in ("before", "after"):
            if label == "before":
                with owner_lookups("scan"):
                    plain_ms, wall_ms, rows, host = profile_eval(cams, model, seq)
            else:
                plain_ms, wall_ms, rows, host = profile_eval(cams, model, seq)
            busy_ms = sum(r[0] for r in rows)
            # the host's aten::cummax and its device kernel (the cumsums' scans stay)
            scans = [r for r in rows + host
                     if "cummax" in r[2] or "tensor_kernel_scan_innermost_dim_with_indices" in r[2]]
            f.write(f"[{label}] render_results, {frames} frames at {cams[0].width}x"
                    f"{cams[0].height}, {int(model.num_alive)} Gaussians; wall {plain_ms:.3f} "
                    f"ms/frame unprofiled, {wall_ms:.3f} profiled; device busy {busy_ms:.3f} "
                    f"ms/frame\ndevice ops:\n")
            for ms, calls, name in rows:
                f.write(f"{ms:10.4f} ms/frame  {calls:7.2f} calls/frame  {name}\n")
            f.write("host ops by self CPU time:\n")
            for ms, calls, name in host[:40]:
                f.write(f"{ms:10.4f} ms/frame  {calls:7.2f} calls/frame  {name}\n")
            emit("eval_profile", owner_lookup="scan form" if label == "before" else "searchsorted",
                 label=label, frames=frames, wall_ms_per_frame=plain_ms,
                 profiled_wall_ms_per_frame=wall_ms, device_busy_ms_per_frame=busy_ms,
                 device_idle_share=1.0 - busy_ms / wall_ms,
                 scan_rows=[{"op": n[:80], "ms_per_frame": ms} for ms, _, n in scans],
                 top_device=[{"op": n[:80], "ms_per_frame": ms, "calls_per_frame": c}
                             for ms, c, n in rows[:12]],
                 top_host=[{"op": n[:80], "self_cpu_ms_per_frame": ms, "calls_per_frame": c}
                           for ms, c, n in host[:12]])
            if label == "after" and scans:
                raise AssertionError(f"a scan still runs in the eval frame: {scans}")


def phase_profile(dev, vid, extent, out_dir, iters: int = 25, skip: int = 5):
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
    rows = device_rows(prof, iters - skip)
    busy_ms = sum(r[0] for r in rows)
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        f.write(f"std-mode step, {iters - skip} profiled iterations; wall {wall_ms:.3f} ms/it, "
                f"device busy {busy_ms:.3f} ms/it\n")
        for ms, calls, name in rows:
            f.write(f"{ms:10.4f} ms/it  {calls:7.2f} calls/it  {name}\n")
    emit("profile", wall_ms_per_it=wall_ms, device_busy_ms_per_it=busy_ms,
         device_idle_share=1.0 - busy_ms / wall_ms,
         top=[{"op": n[:80], "ms_per_it": ms, "calls_per_it": c} for ms, c, n in rows[:15]])


# path 5's schedule, given to the training CLI as flags: stage 1.0 as path 1
# (both static phases), with the label rate raised so that the 100 label
# iterations segment the object (the reference's 0.001 is tuned for 30k; at
# 0.05 labels cross the 0.5 threshold, as tests/test_train.py:30-34
# argues); stage 1.2 the same std + entropy cut with the densify window
# inside it; stage 2 path 2's COARSE_SCHEDULE and COARSE_OPT; stage 3 cut
# from 70k to 400 per variant (reference: densify (500, 45k) every 50,
# object opacity reset every 3k, the pose live after 45k) keeping the
# window, one reset at 200 and 100 pose-live iterations; stage 5 cut from
# 40k to 400 (reference: clamp window (500, 5k), reset interval 3k)
# keeping the clamp window and one unclamped iteration inside it
PIPELINE_STATIC = dict(SLICE_SCHEDULE, label_lr=0.05)
PIPELINE_BG = dict(std_train_iter=300, entropy_reg_iter=100, densify_from_iter=50,
                   densify_until_iter=199)
PIPELINE_FINE = dict(total_num_iter=400, densify_from_iter=50, densify_until_iter=300,
                     densification_interval=50, opacity_reset_interval=200)
PIPELINE_FINE_ALL = dict(total_num_iter=400, densify_from_iter=50, densify_until_iter=150,
                         opacity_reset_interval=100)
PIPELINE_STAGES = ("static", "background", "coarse", "fine_obj/from-static",
                   "fine_obj/from-coarse", "interpolate", "fine_all", "eval")
PSNR_TOL, SSIM_TOL = 1e-4, 1e-6  # the eval CLI against the pipeline's own stage 6


def pipeline_flags():
    """Path 5's schedule as training-CLI flags."""
    flags = []
    for prefix, group in (("s_", PIPELINE_STATIC), ("b_", PIPELINE_BG), ("", SLICE_OPT),
                          ("c_", COARSE_SCHEDULE), ("", COARSE_OPT), ("f_", PIPELINE_FINE),
                          ("a_", PIPELINE_FINE_ALL)):
        for k, v in group.items():
            flags += [f"--{prefix}{k}", str(v)]
    return flags


def pipeline_artifacts(vid, src):
    """Every file of JAX's layout that path 5 must find, beside the
    evaluation PNGs: per static phase the full/object/background PLYs, a
    predicted mask per static training frame, and each later stage's
    files."""
    from egogaussian_tpu_torch.data.readers import read_split_file

    train = set(read_split_file(os.path.join(src, "split", "training_frames.txt")))
    files = ["background/static_bg.ply", "coarse/obj_pose_sequence.npz",
             "coarse/ply/gaussians_final.ply", "fine_all/gaussians_all.ply",
             "evaluation/results.txt", "cfg_args.json", "logs/metrics.jsonl",
             "input.ply", "cameras.json"]
    for p in range(len(vid.static_phases)):
        files += [f"static/ply/static_phase{p}{s}.ply" for s in ("", "_obj", "_bg")]
    files += [f"static/obj_masks/{n}.png" for n in vid.image_names if n in train
              and any(a <= int(n) <= b for a, b in vid.static_phases)]
    for variant in ("static", "coarse"):
        files += [f"fine_obj/from-{variant}/gaussians_fine.ply",
                  f"fine_obj/from-{variant}/obj_pose_sequence.npz",
                  f"interpolate_pose_{variant}/obj_pose_sequence.npz"]
    return files


def read_results_txt(path):
    """{bucket: {ssim, psnr, lpips}} from results.txt (check_results_txt's
    layout)."""
    lines = check_results_txt(path)
    return {lines[i]: {k: float(lines[i + 1 + j].split(":")[1])
                       for j, k in enumerate(("ssim", "psnr", "lpips"))} for i in (0, 4)}


def phase_pipeline(dev, vid, out_dir, flags=None):
    """Path 5: the training CLI (cli/train.py:main) over all six stages on
    the slice's video exported in the reference's dataset layout, with the
    cut schedule of pipeline_flags() and random LPIPS weights. Per stage
    wall time, iterations and it/s (stage 2's with its elided share) and
    the alive count at each handover, from the run's metrics.jsonl; stage
    6's metrics from results.txt. Checks: every artifact of JAX's layout,
    stage 2 handed at least MIN_OBJECT_GAUSSIANS object Gaussians by the
    label segmentation, every frame of each dynamic phase solved after
    stage 4, every logged loss finite, no stage ending with dropped pairs.
    Returns what the checks after the path's counts need."""
    import torch

    from egogaussian_tpu_torch.cli.train import main as train_main
    from egogaussian_tpu_torch.data.export_colmap import export_colmap_dataset
    from egogaussian_tpu_torch.eval.lpips import random_lpips_weights, save_lpips_weights
    from egogaussian_tpu_torch.models.pose import load_pose_sequence

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_pipeline")
    shutil.rmtree(root, ignore_errors=True)
    src = export_colmap_dataset(vid, os.path.join(root, "data"))
    weights = os.path.join(root, "lpips_random_weights.npz")
    save_lpips_weights(random_lpips_weights(0), weights)
    model_dir = os.path.join(root, "model")
    argv = (["-s", src, "-m", model_dir, "--device", str(dev), "--lpips_weights", weights]
            + (pipeline_flags() if flags is None else flags))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = train_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    missing = [f for f in pipeline_artifacts(vid, src)
               if not os.path.exists(os.path.join(model_dir, f))]
    with open(os.path.join(model_dir, "logs", "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    shutil.copy(os.path.join(model_dir, "logs", "metrics.jsonl"),
                os.path.join(out_dir, "pipeline_metrics.jsonl"))
    results_txt = os.path.join(model_dir, "evaluation", "results.txt")
    shutil.copy(results_txt, os.path.join(out_dir, "pipeline_results.txt"))
    stage6 = read_results_txt(results_txt)
    timed = {r["name"]: r for r in records if r.get("event") == "stage_time"}
    ends = {r["stage"]: r for r in records if r.get("event") == "stage_end"}
    coarse = ends["coarse"]
    stages = {}
    for name in PIPELINE_STAGES:
        r = timed[name]
        its = coarse["steps"] if name == "coarse" else r["iterations"]
        stages[name] = {"seconds": r["seconds"], "iterations": int(its),
                        "it_per_s": its / r["seconds"] if its else None,
                        "alive": int(r["alive"]) if "alive" in r else None}
    stages["coarse"]["elided"] = int(coarse["elided"])
    stages["coarse"]["elided_share"] = coarse["elided"] / (coarse["steps"] + coarse["elided"])
    handover = {"static_obj": ends["static"]["obj_alive"],
                "static_bg": ends["static"]["bg_alive"],
                **{k: stages[k]["alive"] for k in ("background", "coarse", "fine_obj/from-static",
                                                   "fine_obj/from-coarse", "fine_all")}}
    # one closing record per trainer run (stage 3 runs twice)
    dropped = [[r["stage"], int(r["dropped_pairs"])] for r in records
               if r.get("event") == "stage_end"]
    losses = [r["loss"] for r in records if "loss" in r]
    solved = {}
    for variant in ("static", "coarse"):
        seq, _ = load_pose_sequence(os.path.join(model_dir, f"interpolate_pose_{variant}",
                                                 "obj_pose_sequence.npz"))
        s = seq.solved.numpy()
        solved[variant] = all(bool(s[f]) for a, b in vid.dynamic_phases
                              for f in range(a, b + 1))
    emit("pipeline", schedule=pipeline_flags() if flags is None else flags,
         width=vid.cameras[0].width, height=vid.cameras[0].height, frames=len(vid.cameras),
         gaussians_init=len(vid.points), seconds=seconds, stages=stages, alive=handover,
         stage6=stage6, metrics=result.metrics,
         lpips_weights="random (random_lpips_weights(0)): LPIPS values are uncalibrated",
         dropped_pairs=dropped, losses_logged=len(losses),
         losses_finite=bool(np.isfinite(losses).all()), dynamic_phases_solved=solved,
         missing_artifacts=missing, max_memory_allocated=peak)
    if missing:
        raise AssertionError(f"pipeline artifacts missing: {missing}")
    if timed["static"]["alive"] < MIN_OBJECT_GAUSSIANS:
        raise AssertionError(f"stage 1.0's label segmentation gave stage 2 "
                             f"{timed['static']['alive']} object Gaussians")
    if not all(solved.values()):
        raise AssertionError(f"stage 4 left dynamic frames unsolved: {solved}")
    if not losses or not np.isfinite(losses).all():
        raise AssertionError("a logged loss is not finite")
    if len(dropped) != 6 or any(n for _, n in dropped):
        raise AssertionError(f"a stage ended with dropped pairs: {dropped}")
    if not all(np.isfinite(v) for m in result.metrics.values() for v in m.values()):
        raise AssertionError(f"stage 6 metrics not finite: {result.metrics}")
    return src, model_dir, weights, argv, result.metrics


def pipeline_frames(dev, src, model_dir):
    """Path 5's own render states, rebuilt from its files on the last
    dynamic training frame that stage 3 solved: stage 3's from-coarse
    model posed by its sequence in the crop window of the size its closing
    record reports, and stage 5's combined model at stage 4's interpolated
    sequence, full frame. Returns [(case prefix, model, state)] for
    phase_frame_kernels."""
    from types import SimpleNamespace

    from egogaussian_tpu_torch.config import Config
    from egogaussian_tpu_torch.data.readers import (
        load_colmap_scene,
        phase_membership_mask,
        read_phase_index,
        read_split_file,
        stack_cameras,
    )
    from egogaussian_tpu_torch.models.gaussians import load_ply
    from egogaussian_tpu_torch.models.pose import load_pose_sequence, pose_from_rt
    from egogaussian_tpu_torch.pipeline import _load_pred_masks, apply_predicted_masks
    from egogaussian_tpu_torch.train.coarse_pose import _accum_tables
    from egogaussian_tpu_torch.train.common import auto_tile_config

    cfg = Config()
    scene = load_colmap_scene(src, dev, cfg.model.images, cfg.model.resolution)
    cams = apply_predicted_masks(
        scene.cameras, _load_pred_masks(os.path.join(model_dir, "static", "obj_masks")))
    batch = stack_cameras(cams, dev)
    with open(os.path.join(model_dir, "logs", "metrics.jsonl")) as fh:
        ends = [r for r in map(json.loads, fh)
                if r.get("event") == "stage_end" and r["stage"] == "fine_obj"]
    if len(ends) != 2:
        raise AssertionError(f"expected two stage-3 runs in metrics.jsonl, found {len(ends)}")
    crop = ends[1]["crop_size"]  # from-coarse runs second
    train = set(read_split_file(os.path.join(src, "split", "training_frames.txt")))
    _, dynamic = read_phase_index(os.path.join(src, "split", "phase_frame_index.txt"))
    in_dynamic = phase_membership_mask(cams, dynamic)
    out = []
    for prefix, ply, npz, window in (
            ("stage3_", "fine_obj/from-coarse/gaussians_fine.ply",
             "fine_obj/from-coarse/obj_pose_sequence.npz", crop),
            ("stage5_", "fine_all/gaussians_all.ply",
             "interpolate_pose_coarse/obj_pose_sequence.npz", None)):
        seq, _ = load_pose_sequence(os.path.join(model_dir, npz), dev)
        model = load_ply(os.path.join(model_dir, ply), dev)
        solved = seq.solved.cpu().numpy()
        f = [i for i, c in enumerate(cams)
             if in_dynamic[i] and solved[i] and c.image_name in train][-1]
        table_T, table_R = _accum_tables(seq)
        out.append((prefix, model, SimpleNamespace(
            batch=batch, f=f, table_T=table_T, table_R=table_R,
            pose0=pose_from_rt(seq.rotations[f], seq.translations[f]),
            base=auto_tile_config(model, batch.camera(0), tile_size=cfg.render.tile_size),
            crop=None if window is None else tuple(window))))
    return out


def check_pipeline(dev, src, model_dir, weights, argv, metrics, errs):
    """After path 5's counts are read: the eval CLI on the training CLI's
    output directory against the pipeline's own stage 6 (PSNR within
    PSNR_TOL dB, SSIM within SSIM_TOL), then the training CLI again with
    --resume: every stage loads its files (no trainer logs a step), in
    seconds, with the same metrics. Then every kernel against its twin on
    path 5's own inputs (pipeline_frames: stage 3's crop window, stage 5's
    combined model and its gather windows). The run's directory is removed
    only when every check passed."""
    from egogaussian_tpu_torch.cli.eval import main as eval_main
    from egogaussian_tpu_torch.cli.train import main as train_main

    metrics_path = os.path.join(model_dir, "logs", "metrics.jsonl")
    t0 = time.perf_counter()
    ev = eval_main(["-s", src, "-m", model_dir, "--lpips_weights", weights,
                    "--device", str(dev)])
    eval_s = time.perf_counter() - t0
    def abs_diff(other):
        return {b: {k: abs(other[b][k] - m[k]) for k in ("psnr", "ssim")}
                for b, m in metrics.items()}

    def within(d):
        return all(v["psnr"] <= PSNR_TOL and v["ssim"] <= SSIM_TOL for v in d.values())

    diff = abs_diff(ev)
    with open(metrics_path) as fh:
        n_before = sum(1 for _ in fh)
    t0 = time.perf_counter()
    again = train_main(argv + ["--resume"])
    resume_s = time.perf_counter() - t0
    with open(metrics_path) as fh:
        later = [json.loads(line) for line in fh][n_before:]
    trained = sorted({r["stage"] for r in later} - {"pipeline"})
    resumed = {r["name"]: bool(r["resumed"]) for r in later if r.get("event") == "stage_time"}
    resume_diff = abs_diff(again.metrics)
    ok = (within(diff) and within(resume_diff) and not trained
          and all(resumed[k] for k in PIPELINE_STAGES if k not in ("interpolate", "eval")))
    emit("pipeline_checks", eval_cli_metrics=ev, eval_cli_abs_diff=diff,
         tol={"psnr_db": PSNR_TOL, "ssim": SSIM_TOL}, eval_cli_seconds=eval_s,
         resume_seconds=resume_s, resume_stages=resumed, resume_trained=trained,
         resume_metrics_abs_diff=resume_diff, ok=ok)
    if not ok:
        raise AssertionError(f"path 5 checks failed: eval CLI {diff}, resume trained {trained}, "
                             f"resumed {resumed}, resume metrics {resume_diff}")
    for prefix, model, fr in pipeline_frames(dev, src, model_dir):
        emit("pipeline_frame", case=prefix.rstrip("_"), frame=fr.f, crop=fr.crop,
             alive=int(model.num_alive), capacity=model.capacity,
             tile_config=dataclasses.asdict(fr.base))
        phase_frame_kernels(model, fr, errs, prefix=prefix)
    shutil.rmtree(os.path.dirname(model_dir))


# path 6: the training CLI with mid-stage checkpoints, SIGKILLed twice and
# restarted; stage 1.0 (500 iterations per phase) and stage 3 (400 per
# variant) each save at least twice
CKPT_EVERY = 100
# how far path 6's output may sit from path 5's, per compared quantity:
# the spread of two unbroken card runs of path 5's flags (PERF.md §5,
# chip_smoke.py --pipeline-only --repro)
PATH6_TOL = {"alive": 0, "solved": 0, "pose": 0.0, "ply": 0.0, "psnr": 0.0, "ssim": 0.0}
CHILD_TIMEOUT = 600  # seconds, per training-CLI child


# the child entry flags of this script and the CLI module each one runs
CHILD_CLIS = {"--train-child": "egogaussian_tpu_torch.cli.train",
              "--train-multi-child": "egogaussian_tpu_torch.cli.train_multi"}


def train_child(counts_path, argv, module=CHILD_CLIS["--train-child"]) -> int:
    """A training CLI's main (`module`) in a child process of paths 6, 8
    and 9d, with the launch counters flushed to counts_path every 0.1 s (a
    SIGKILLed child keeps what its last flush wrote) and at exit."""
    import importlib
    import threading

    train_main = importlib.import_module(module).main

    def flush():
        tmp = counts_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(launch_counts(), f)
        os.replace(tmp, counts_path)

    stop = threading.Event()

    def loop():
        while not stop.wait(0.1):
            flush()

    flusher = threading.Thread(target=loop, daemon=True)
    flusher.start()
    try:
        train_main(argv)
    finally:
        # the loop's flush and this one share the .tmp file: let it end first
        stop.set()
        flusher.join()
        flush()
    return 0


def run_child(argv, tag, out_dir, kill_when=(), flag="--train-child"):
    """A training CLI (CHILD_CLIS[flag]) with `argv` in a child process
    (train_child), its output in out_dir/<tag>.log; SIGKILLed as soon as
    one of the paths in kill_when exists. Returns (how it ended, seconds,
    launch counts)."""
    import signal

    counts = os.path.join(out_dir, f"{tag}_launches.json")
    cmd = [sys.executable, os.path.abspath(__file__), flag, counts, "--"] + argv
    t0 = time.perf_counter()
    with open(os.path.join(out_dir, f"{tag}.log"), "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            while proc.poll() is None:
                if any(os.path.exists(p) for p in kill_when):
                    proc.send_signal(signal.SIGKILL)
                    proc.wait()
                    break
                if time.perf_counter() - t0 > CHILD_TIMEOUT:
                    raise AssertionError(f"{tag}: the training CLI ran past {CHILD_TIMEOUT} s")
                time.sleep(0.02)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds = time.perf_counter() - t0
    ended = "killed" if proc.returncode == -signal.SIGKILL else f"exit {proc.returncode}"
    with open(counts) as f:
        launches = json.load(f)
    return ended, seconds, launches


def ckpt_iteration(path) -> int:
    """The iteration a checkpoint file of train/ckpt_hook.py holds."""
    import pickle

    with np.load(path) as data:
        return int(pickle.loads(data["__host__"].tobytes())["it"])


def pipeline_records(model_dir):
    with open(os.path.join(model_dir, "logs", "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


POSE_FILES = ("coarse", "fine_obj/from-static", "fine_obj/from-coarse",
              "interpolate_pose_static", "interpolate_pose_coarse")


def compare_runs(dir_a, dir_b):
    """How far two pipeline outputs sit apart: alive counts at every
    handover (the last stage_time record of each stage, stage 1.0's per
    phase object/background counts), solved frames and pose values of
    every pose file, gaussians_all.ply's properties (when the counts agree)
    and byte equality, stage 6's PSNR and SSIM."""
    from egogaussian_tpu_torch.utils.ply import read_ply

    def handover(d):
        recs = pipeline_records(d)
        out = {r["name"]: r.get("alive") for r in recs if r.get("event") == "stage_time"}
        static = [r for r in recs if r.get("event") == "stage_end" and r["stage"] == "static"][-1]
        out["static_obj"], out["static_bg"] = static["obj_alive"], static["bg_alive"]
        return out

    ha, hb = handover(dir_a), handover(dir_b)
    def count_diff(a, b):
        a, b = np.atleast_1d(a), np.atleast_1d(b)
        return int(np.abs(a - b).max()) if a.shape == b.shape else 1 << 30

    alive = max(count_diff(ha[k], hb[k]) for k in ha if ha[k] is not None)
    solved = pose = 0
    for name in POSE_FILES:
        a = np.load(os.path.join(dir_a, name, "obj_pose_sequence.npz"))
        b = np.load(os.path.join(dir_b, name, "obj_pose_sequence.npz"))
        solved += int(np.sum(a["solved"] != b["solved"]))
        for k in ("translations", "rotations"):
            pose = max(pose, float(np.abs(a[k].astype(np.float64) - b[k]).max()))
    ply = os.path.join("fine_all", "gaussians_all.ply")
    pa, na = read_ply(os.path.join(dir_a, ply))
    pb, nb = read_ply(os.path.join(dir_b, ply))
    ply_err = (max(float(np.abs(pa[k].astype(np.float64) - pb[k]).max()) for k in pa)
               if na == nb else float("inf"))
    with open(os.path.join(dir_a, ply), "rb") as fa, open(os.path.join(dir_b, ply), "rb") as fb:
        same_bytes = fa.read() == fb.read()
    ra = read_results_txt(os.path.join(dir_a, "evaluation", "results.txt"))
    rb = read_results_txt(os.path.join(dir_b, "evaluation", "results.txt"))
    return {"alive": alive, "solved": solved, "pose": pose, "ply": ply_err,
            "psnr": max(abs(ra[k]["psnr"] - rb[k]["psnr"]) for k in ra),
            "ssim": max(abs(ra[k]["ssim"] - rb[k]["ssim"]) for k in ra),
            "ply_vertices": [int(na), int(nb)], "ply_bytes_equal": same_bytes,
            "handover": {"a": ha, "b": hb}}


def phase_checkpoint(argv5, model_dir5, out_dir):
    """Path 6: the training CLI with path 5's flags and --checkpoint_every
    CKPT_EVERY in a fresh directory, as a child process: SIGKILLed as soon
    as static/ckpt_static_phase0.npz exists, restarted with the same
    command (stage 1.0 resumes mid-stage), SIGKILLed again as soon as a
    stage-3 ckpt_fine_obj.npz exists, restarted with --resume (stages
    1.0-2 load their files, stage 3 resumes mid-stage) and run to the end.
    Checks: each restart logged one mid-stage resume (event ckpt_resume)
    at the iteration its file held; the output against path 5's
    (compare_runs) within PATH6_TOL. Returns the child runs' launch
    counts summed."""
    model_dir = os.path.join(os.path.dirname(model_dir5), "model_ckpt")
    shutil.rmtree(model_dir, ignore_errors=True)
    argv = list(argv5)
    argv[argv.index("-m") + 1] = model_dir
    argv += ["--checkpoint_every", str(CKPT_EVERY)]
    static_ckpt = os.path.join(model_dir, "static", "ckpt_static_phase0.npz")
    fine_ckpts = [os.path.join(model_dir, "fine_obj", v, "ckpt_fine_obj.npz")
                  for v in ("from-static", "from-coarse")]
    t0 = time.perf_counter()
    runs = [run_child(argv, "ckpt_run1", out_dir, kill_when=[static_ckpt])]
    it1 = ckpt_iteration(static_ckpt)
    runs.append(run_child(argv, "ckpt_run2", out_dir, kill_when=fine_ckpts))
    fine = [p for p in fine_ckpts if os.path.exists(p)]
    it2 = ckpt_iteration(fine[0]) if fine else None
    runs.append(run_child(argv + ["--resume"], "ckpt_run3", out_dir))
    seconds = time.perf_counter() - t0
    resumes = [(r["stage"], r["step"], r["file"]) for r in pipeline_records(model_dir)
               if r.get("event") == "ckpt_resume"]
    want = [("static", it1, "ckpt_static_phase0.npz"), ("fine_obj", it2, "ckpt_fine_obj.npz")]
    diff = compare_runs(model_dir5, model_dir)
    within = all(diff[k] <= tol for k, tol in PATH6_TOL.items())
    launches = {k: sum(r[2][k] for r in runs) for k in runs[0][2]}
    ok = ([r[0] for r in runs] == ["killed", "killed", "exit 0"] and resumes == want
          and within and bool(fine))
    emit("checkpoint", every=CKPT_EVERY, seconds=seconds,
         runs=[{"ended": r[0], "seconds": r[1]} for r in runs],
         killed_at={"static_phase0": it1, "fine_obj": it2,
                    "fine_obj_variant": fine[0].split(os.sep)[-2] if fine else None},
         resumes_logged=resumes, vs_path5=diff, tol=PATH6_TOL, within_tol=within,
         launches={k: launches[k] for k in ("tilegrid_fwd_d3", "tilegrid_bwd_d3",
                                           "tilegrid_fwd_d1", "tilegrid_bwd_d1",
                                           "window_chunked_fwd_d3")},
         launches_note="summed over the three children; a killed child's counts are "
                       "its last flush (every 0.1 s) before the kill", ok=ok)
    if not ok:
        raise AssertionError(f"path 6 failed: runs {[r[0] for r in runs]}, resumes {resumes} "
                             f"(want {want}), against path 5 {diff} (tol {PATH6_TOL})")
    for name in ("tilegrid_fwd_d3", "tilegrid_bwd_d3", "window_chunked_fwd_d3"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on path 6")
    return model_dir, launches


def repro_run(argv5, model_dir5, out_dir):
    """Path 5's flags once more, unbroken, as a child process: the card's
    run-to-run spread that PATH6_TOL holds path 6 to."""
    model_dir = os.path.join(os.path.dirname(model_dir5), "model_repro")
    shutil.rmtree(model_dir, ignore_errors=True)
    argv = list(argv5)
    argv[argv.index("-m") + 1] = model_dir
    ended, seconds, _ = run_child(argv, "repro_run", out_dir)
    diff = compare_runs(model_dir5, model_dir)
    emit("pipeline_repro", ended=ended, seconds=seconds, vs_path5=diff)
    if ended != "exit 0":
        raise AssertionError(f"the repeated path-5 run ended with {ended}")
    shutil.rmtree(model_dir)


# path 8: the multi-video CLI over path 5's exported video and a second one,
# both in one lockstep; each lane is its own run bit for bit, so video 0's
# files are held to path 5's byte for byte (PATH6_TOL, the spread of two
# unbroken runs: 0) and video 1's to its own one-video run's
MULTI_SEED = 1  # the second video's make_synthetic_video seed
MULTI_STAGES = ("static", "background", "coarse", "fine_obj/from-static",
                "fine_obj/from-coarse", "fine_all", "eval")


def multi_inputs(dev, vid, src, model_dir5, weights):
    """Path 8's videos and command line: path 5's exported 640x480 video
    and a second one (make_synthetic_video seed MULTI_SEED, same sizes,
    other content and motion, exported the same way), each initialized at
    102,000 Gaussians; cli/train_multi.py's arguments (--mesh 1x1, --seed
    0) with path 5's flags and LPIPS weights."""
    from egogaussian_tpu_torch.data import make_synthetic_video
    from egogaussian_tpu_torch.data.export_colmap import export_colmap_dataset

    root = os.path.dirname(model_dir5)
    vid1 = make_synthetic_video(dev, seed=MULTI_SEED, **SLICE_VIDEO)
    src1 = export_colmap_dataset(vid1, os.path.join(root, "data_multi1"))
    outs = [os.path.join(root, f"multi{i}") for i in range(2)]
    flags = ["--device", str(dev), "--lpips_weights", weights] + pipeline_flags()
    argv = ["--videos", src, src1, "--outputs", *outs, "--mesh", "1x1", "--seed", "0"] + flags
    return dict(vids=[vid, vid1], srcs=[src, src1], outs=outs, argv=argv, flags=flags)


def phase_multi(multi, out_dir):
    """Path 8: cli/train_multi.py with multi_inputs' arguments (both videos
    in one lockstep), as a child process (train_child) whose launch counts
    are flushed to a file. Returns the launch counts; multi gains the
    run's seconds."""
    for o in multi["outs"]:
        shutil.rmtree(o, ignore_errors=True)
    ended, seconds, launches = run_child(multi["argv"], "multi_run", out_dir,
                                         flag="--train-multi-child")
    if ended != "exit 0":
        raise AssertionError(f"path 8: the multi-video CLI ended with {ended}")
    multi["seconds"] = seconds
    return launches


def phase_multi_single(multi, out_dir):
    """Video 1 of path 8 alone: `cli.train -s <video 1> --seed 1` with path
    8's flags, as a child process (its launches are its own, not path
    8's), the tree video 1's lane is held to. multi gains its output and
    seconds."""
    out = os.path.join(os.path.dirname(multi["outs"][1]), "single1")
    shutil.rmtree(out, ignore_errors=True)
    ended, seconds, _ = run_child(["-s", multi["srcs"][1], "-m", out, "--seed", "1"]
                                  + multi["flags"], "multi_single1", out_dir)
    if ended != "exit 0":
        raise AssertionError(f"path 8: video 1's own run ended with {ended}")
    multi["single1"], multi["single1_seconds"] = out, seconds


def expected_launches(vid, model_dir):
    """Tile-grid launches one video's training makes, by stage, from its
    run's records: a D = 3 forward and backward per training step of
    stages 1.0 (std and entropy), 1.2, 2 (real steps), 3 (both variants)
    and 5; a D = 1 pair per label step and a D = 1 forward per predicted
    mask."""
    recs = pipeline_records(model_dir)
    timed = {r["name"]: r for r in recs if r.get("event") == "stage_time"
             and not r["resumed"]}
    coarse = [r for r in recs if r.get("event") == "stage_end" and r["stage"] == "coarse"][0]
    s = PIPELINE_STATIC
    phases = len(vid.static_phases)
    d3 = {"static": phases * (s["std_train_iter"] + s["entropy_reg_iter"]),
          "coarse": int(coarse["steps"])}
    for k in ("background", "fine_obj/from-static", "fine_obj/from-coarse", "fine_all"):
        d3[k] = int(timed[k]["iterations"])
    masks = len(os.listdir(os.path.join(model_dir, "static", "obj_masks")))
    return {"d3": d3, "label": phases * s["label_train_iter"], "masks": masks}


def one_video_launches(e):
    """expected_launches' stages summed: one video's counts by kernel row."""
    d3 = sum(e["d3"].values())
    return {"tilegrid_fwd_d3": d3, "tilegrid_bwd_d3": d3,
            "tilegrid_fwd_d1": e["label"] + e["masks"], "tilegrid_bwd_d1": e["label"]}


def lockstep_launches(expect):
    """The tile-grid launches of the videos' lockstep (expected_launches
    of each), by kernel row, as (least, most): one launch for all lanes per
    step, so stages 1.0, 1.2, 3 and 5 and the label steps make the longest
    lane's count; stage 2 makes between the longest lane's and less than
    the lanes' sum of real steps where every lane has some (its lanes step
    together, each skipping its no-op frames); the predicted masks are
    per video. A loop of
    one-video runs makes the sum of every stage and falls above."""
    shared = sum(max(e["d3"][k] for e in expect) for k in expect[0]["d3"] if k != "coarse")
    coarse = [e["d3"]["coarse"] for e in expect]
    d3 = (shared + max(coarse), shared + (sum(coarse) - 1 if min(coarse) else max(coarse)))
    label = max(e["label"] for e in expect)
    fwd1 = label + sum(e["masks"] for e in expect)
    return {"tilegrid_fwd_d3": d3, "tilegrid_bwd_d3": d3, "tilegrid_fwd_d1": (fwd1, fwd1),
            "tilegrid_bwd_d1": (label, label)}


def check_multi(dev, multi, model_dir5, launches5, launches8, errs):
    """After path 8's counts are read: each lane against its own run, video
    0's output against path 5's and video 1's against its one-video run
    (phase_multi_single): compare_runs within PATH6_TOL, and every file
    (cfg_args.json and the metrics log aside) byte for byte, both ways;
    video 1's every artifact of JAX's layout, at least
    MIN_OBJECT_GAUSSIANS handed to stage 2, every dynamic frame solved
    after stage 4, finite losses, six stage ends without dropped pairs,
    stage 6's PSNR / SSIM finite; per-stage seconds of the lockstep beside
    path 5's and video 1's own run's; the launches against what the
    videos' records imply for a lockstep (lockstep_launches: one launch
    for both lanes per step, stage 2 below the lanes' sum, the masks and
    stage 6 per video), which a loop of one-video runs exceeds; the CLI
    again with
    --resume (no trainer logs a step, the same results.txt); then every
    kernel against its twin on video 1's own stage-3 and stage-5
    inputs."""
    from egogaussian_tpu_torch.cli.train_multi import main as multi_main
    from egogaussian_tpu_torch.models.pose import load_pose_sequence

    vids, srcs, outs = multi["vids"], multi["srcs"], multi["outs"]
    refs = [model_dir5, multi["single1"]]
    diffs = [{k: v for k, v in compare_runs(ref, out).items() if k != "handover"}
             for ref, out in zip(refs, outs)]
    exact = all(d[k] <= tol for d in diffs for k, tol in PATH6_TOL.items())
    differ = [sorted(set(differing_files(out, ref)) | set(differing_files(ref, out)))
              for ref, out in zip(refs, outs)]
    n_files = [len([f for d, _, fs in os.walk(out) for f in fs]) for out in outs]
    vid1, out1 = vids[1], outs[1]
    recs = pipeline_records(out1)
    missing = [f for f in pipeline_artifacts(vid1, srcs[1])
               if not os.path.exists(os.path.join(out1, f))]
    timed = [{r["name"]: r for r in pipeline_records(o) if r.get("event") == "stage_time"}
             for o in (model_dir5, multi["single1"], outs[0])]
    handover1 = {k: int({r["name"]: r for r in recs if r.get("event") == "stage_time"}[k]
                        ["alive"]) for k in MULTI_STAGES if k != "eval"}
    solved = {}
    for variant in ("static", "coarse"):
        seq, _ = load_pose_sequence(os.path.join(out1, f"interpolate_pose_{variant}",
                                                 "obj_pose_sequence.npz"))
        s = seq.solved.numpy()
        solved[variant] = all(bool(s[f]) for a, b in vid1.dynamic_phases
                              for f in range(a, b + 1))
    losses = [r["loss"] for r in recs if "loss" in r]
    dropped = [[r["stage"], int(r["dropped_pairs"])] for r in recs
               if r.get("event") == "stage_end"]
    stage6 = read_results_txt(os.path.join(out1, "evaluation", "results.txt"))
    # the lockstep's stage spans both videos (each tree records the same span)
    stages = {k: {"path5_s": timed[0][k]["seconds"], "video1_alone_s": timed[1][k]["seconds"],
                  "lockstep_s": timed[2][k]["seconds"]} for k in MULTI_STAGES}
    one_by_one = sum(timed[0][k]["seconds"] + timed[1][k]["seconds"] for k in MULTI_STAGES)
    lockstep = sum(timed[2][k]["seconds"] for k in MULTI_STAGES)
    rows = ("tilegrid_fwd_d3", "tilegrid_bwd_d3", "tilegrid_fwd_d1", "tilegrid_bwd_d1")
    expect = [expected_launches(v, o) for v, o in zip(vids, outs)]
    alone = [one_video_launches(e) for e in expect]
    span = lockstep_launches(expect)
    launches = {k: {"path8": launches8[k], "path5": launches5[k],
                    "expected_video0": alone[0][k], "expected_video1": alone[1][k],
                    "expected_lockstep": span[k]} for k in rows}
    launches["window_chunked_fwd_d3"] = {"path8": launches8["window_chunked_fwd_d3"],
                                         "path5": launches5["window_chunked_fwd_d3"]}
    launches["by_stage"] = [e["d3"] for e in expect]
    launches_ok = (all(span[k][0] <= launches8[k] <= span[k][1]
                       and alone[0][k] == launches5[k] for k in rows)
                   and launches8["window_chunked_fwd_d3"]
                   == 2 * launches5["window_chunked_fwd_d3"])

    n_before = [len(pipeline_records(o)) for o in outs]
    with open(os.path.join(out1, "evaluation", "results.txt")) as f:
        results1 = f.read()
    t0 = time.perf_counter()
    multi_main(multi["argv"] + ["--resume"])
    resume_s = time.perf_counter() - t0
    trained = sorted({r["stage"] for o, n in zip(outs, n_before)
                      for r in pipeline_records(o)[n:]} - {"pipeline"})
    with open(os.path.join(out1, "evaluation", "results.txt")) as f:
        resume_same = f.read() == results1

    ok = (exact and not any(differ) and all(n_files) and not missing
          and handover1["static"] >= MIN_OBJECT_GAUSSIANS
          and all(solved.values()) and bool(losses) and bool(np.isfinite(losses).all())
          and len(dropped) == 6 and not any(n for _, n in dropped)
          and all(np.isfinite(v) for m in stage6.values() for k, v in m.items() if k != "lpips")
          and launches_ok and not trained and resume_same)
    emit("multi", videos=2, seed=MULTI_SEED, seconds=multi["seconds"],
         video1_alone_seconds=multi["single1_seconds"], stages=stages,
         stage_seconds={"one_by_one": one_by_one, "lockstep": lockstep},
         speedup=one_by_one / lockstep, vs_own_runs=diffs, tol=PATH6_TOL, bit_for_bit=exact,
         files=n_files, files_differ=differ, video1_alive=handover1, video1_stage6=stage6,
         video1_missing_artifacts=missing, video1_solved=solved,
         video1_losses_logged=len(losses), video1_dropped_pairs=dropped, launches=launches,
         launches_as_expected=launches_ok, resume_seconds=resume_s, resume_trained=trained,
         resume_results_same=resume_same, ok=ok)
    if not ok:
        raise AssertionError(f"path 8 failed: against the own runs {diffs} (files "
                             f"differing {differ}), missing {missing}, alive {handover1}, solved "
                             f"{solved}, dropped {dropped}, launches {launches}, resume "
                             f"trained {trained}")
    for prefix, model, fr in pipeline_frames(dev, srcs[1], out1):
        emit("pipeline_frame", case="multi1_" + prefix.rstrip("_"), frame=fr.f, crop=fr.crop,
             alive=int(model.num_alive), capacity=model.capacity,
             tile_config=dataclasses.asdict(fr.base))
        phase_frame_kernels(model, fr, errs, prefix="multi1_" + prefix)


VIEW_FREE = 8  # render_freeview / render_multiview frames
VIEW_MULTI = 3  # render_multiview's fixed views


def phase_viewers(dev, src, model_dir, out_dir):
    """Path 7, on path 5's output at full width: render_trajectory over
    every frame (background PLY, stage 3's from-coarse object, stage 4's
    interpolated poses), render_double_trajectory (coarse against
    interpolated poses), render_freeview over the first VIEW_FREE frames on
    interpolate_cameras between the first and last training camera, and
    render_multiview on VIEW_MULTI of those views, all through the tiled
    backend; one SIBR round trip through serve(max_messages=1) in a thread
    at 640x480; ply_tools recolor (label, generation) and info on the final
    PLY; build_native and the native PLY read and write. Returns what the
    checks after the path's counts need."""
    import contextlib
    import io
    import socket
    import struct
    import threading

    import torch

    from egogaussian_tpu_torch.cli import ply_tools
    from egogaussian_tpu_torch.config import Config
    from egogaussian_tpu_torch.data.readers import load_colmap_scene, read_split_file
    from egogaussian_tpu_torch.eval import viewer
    from egogaussian_tpu_torch.eval.network_viewer import serve
    from egogaussian_tpu_torch.models.gaussians import load_ply
    from egogaussian_tpu_torch.models.pose import load_pose_sequence
    from egogaussian_tpu_torch.render.camera import focal_to_fov
    from egogaussian_tpu_torch.utils import native_io

    cfg = Config()
    cams = load_colmap_scene(src, dev, cfg.model.images, cfg.model.resolution).cameras
    train = set(read_split_file(os.path.join(src, "split", "training_frames.txt")))
    train_cams = [c for c in cams if c.image_name in train]
    files = {k: os.path.join(model_dir, v) for k, v in (
        ("bg", "background/static_bg.ply"), ("obj", "fine_obj/from-coarse/gaussians_fine.ply"),
        ("final", "fine_all/gaussians_all.ply"),
        ("interp", "interpolate_pose_coarse/obj_pose_sequence.npz"),
        ("coarse", "coarse/obj_pose_sequence.npz"))}
    bg = load_ply(files["bg"], dev, force_bg=True)
    obj = load_ply(files["obj"], dev, is_object=True)
    final = load_ply(files["final"], dev)
    interp, _ = load_pose_sequence(files["interp"], dev)
    coarse, _ = load_pose_sequence(files["coarse"], dev)
    out = os.path.join(os.path.dirname(model_dir), "viewers")
    shutil.rmtree(out, ignore_errors=True)
    renders = {}

    def hook(name):
        def on_render(model, cam, kwargs, res):
            renders.setdefault(name, []).append((model, cam, kwargs, res))
        return on_render

    # host seconds by part: the render call (synced), the PNG writes, the
    # trail's combine_models, the montages
    parts = {"render": 0.0, "png": 0.0, "combine": 0.0, "montage": 0.0}

    def timed(part, fn, sync=False):
        def wrapped(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            parts[part] += time.perf_counter() - t
            return out
        return wrapped

    originals = {k: getattr(viewer, k) for k in ("render_gaussians", "_save", "combine_models",
                                                 "make_montage")}
    viewer.render_gaussians = timed("render", originals["render_gaussians"], sync=True)
    viewer._save = timed("png", originals["_save"])
    viewer.combine_models = timed("combine", originals["combine_models"])
    viewer.make_montage = timed("montage", originals["make_montage"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    viewer.render_trajectory(cams, bg, obj, interp, save_dir=os.path.join(out, "trajectory"),
                             on_render=hook("trajectory"))
    viewer.render_double_trajectory(cams, bg, obj, coarse, interp,
                                    save_dir=os.path.join(out, "double_trajectory"),
                                    on_render=hook("double_trajectory"))
    free = viewer.render_freeview(cams[:VIEW_FREE], final, interp, train_cams[0],
                                  train_cams[-1], save_dir=os.path.join(out, "freeview"),
                                  on_render=hook("freeview"))
    views = viewer.interpolate_cameras(train_cams[0], train_cams[-1], VIEW_MULTI)
    viewer.render_multiview(cams[:VIEW_FREE], final, interp, views,
                            save_dir=os.path.join(out, "multiview"),
                            on_render=hook("multiview"))
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    for k, fn in originals.items():
        setattr(viewer, k, fn)
    n_frames = sum(len(v) for v in renders.values())

    # one SIBR round trip at the first training camera
    cam0 = train_cams[0]
    w, h = cam0.width, cam0.height
    msg = {"resolution_x": w, "resolution_y": h, "train": False,
           "fov_y": focal_to_fov(float(cam0.fy), h), "fov_x": focal_to_fov(float(cam0.fx), w),
           "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
           "keep_alive": False, "scaling_modifier": 1.0,
           "view_matrix": cam0.viewmat.cpu().numpy().T.ravel().tolist(),
           "view_projection_matrix": np.eye(4).ravel().tolist()}
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    served = {}
    th = threading.Thread(target=lambda: served.update(
        n=serve(final, port=port, max_messages=1)), daemon=True)
    th.start()
    deadline = time.time() + 60
    while True:
        try:
            cli = socket.create_connection(("127.0.0.1", port), timeout=60)
            break
        except ConnectionRefusedError:
            if time.time() > deadline:
                raise
            time.sleep(0.05)
    payload = json.dumps(msg).encode()
    cli.sendall(struct.pack("<I", len(payload)) + payload)
    wire = b""
    while True:
        chunk = cli.recv(1 << 20)
        if not chunk:
            break
        wire += chunk
    cli.close()
    th.join(timeout=60)

    # PLY tools on the final PLY
    info = io.StringIO()
    with contextlib.redirect_stdout(info):
        for by in ("label", "generation"):
            ply_tools.main(["recolor", files["final"], os.path.join(out, f"recolor_{by}.ply"),
                            "--by", by])
        ply_tools.main(["info", files["final"]])

    built = native_io.build_native(verbose=False)
    emit("viewers", frames={k: len(v) for k, v in renders.items()}, render_seconds=render_s,
         frames_per_second=n_frames / render_s, seconds_by_part=parts,
         alive={"bg": int(bg.num_alive), "obj": int(obj.num_alive),
                "final": int(final.num_alive)},
         width=w, height=h, served=served.get("n"),
         wire_bytes=len(wire), native_built=built, ply_tools_output=info.getvalue())
    return dict(renders=renders, free=free, msg=msg, wire=wire, served=served.get("n"),
                out=out, final=files["final"], built=built, info=info.getvalue())


def check_viewers(v):
    """After path 7's counts are read: every viewer render again through
    backend="cuda" with auto_tile_config, within DEEP_FWD_TOL, with 0
    dropped pairs in both; render_freeview's frames are its renders'
    images; the served bytes are send_image's conversion of
    render_gaussians at the message's camera, byte for byte; the recolored
    PLYs hold every Gaussian in palette colors and info printed its five
    lines; the native library built and loads, and its PLY read and write
    of the final PLY equal the numpy reader's values and writer's bytes."""
    import torch

    from egogaussian_tpu_torch.cli.ply_tools import _PALETTE
    from egogaussian_tpu_torch.eval.network_viewer import send_image
    from egogaussian_tpu_torch.models.gaussians import load_ply
    from egogaussian_tpu_torch.ops.sh import rgb_to_sh
    from egogaussian_tpu_torch.render.camera import Camera, fov_to_focal
    from egogaussian_tpu_torch.render.tiled import TileConfig
    from egogaussian_tpu_torch.train.common import auto_tile_config, render_gaussians
    from egogaussian_tpu_torch.utils import native_io
    from egogaussian_tpu_torch.utils.ply import read_ply, write_ply

    worst = {k: 0.0 for k in DEEP_FWD_TOL}
    dropped = {"tiled": 0, "cuda": 0}
    # at the tiled render's own tile size: a pair reaches the pixels of
    # the tiles its 3-sigma box touches (the reference's binning), so with
    # opaque Gaussians the image depends on the tile size by up to ~1e-2
    ts = TileConfig().tile_size
    with torch.no_grad():
        for name, rs in v["renders"].items():
            for model, cam, kwargs, res in rs:
                kw = dict(kwargs, backend="cuda",
                          tile_config=auto_tile_config(model, cam, tile_size=ts))
                rc = render_gaussians(model, cam, **kw)
                for k in worst:
                    worst[k] = max(worst[k], max_err(getattr(res, k), getattr(rc, k)))
                dropped["tiled"] += int(res.dropped_pairs)
                dropped["cuda"] += int(rc.dropped_pairs)
    frames_are_renders = all(np.array_equal(f, r[3].image.cpu().numpy())
                             for f, r in zip(v["free"], v["renders"]["freeview"]))

    msg = v["msg"]
    w, h = msg["resolution_x"], msg["resolution_y"]
    model = v["renders"]["freeview"][0][0]
    cam = Camera.from_viewmat(np.array(msg["view_matrix"], np.float32).reshape(4, 4).T,
                              fov_to_focal(msg["fov_x"], w), fov_to_focal(msg["fov_y"], h),
                              w, h, model.device)

    class Sink:
        data = b""

        def sendall(self, b):
            Sink.data += b

    with torch.no_grad():
        img = render_gaussians(model, cam, torch.zeros(3, device=model.device),
                               backend="tiled").image
    send_image(Sink(), img.cpu().numpy())
    wire_ok = v["served"] == 1 and Sink.data == v["wire"]

    def numpy_only(fn, *args):
        """fn with the native library hidden: the numpy reader and writer."""
        load = native_io.load_native
        native_io.load_native = lambda: None
        try:
            return fn(*args)
        finally:
            native_io.load_native = load

    n_final = numpy_only(read_ply, v["final"])[1]
    recolor_ok = True
    for by in ("label", "generation"):
        m = load_ply(os.path.join(v["out"], f"recolor_{by}.ply"), torch.device("cpu"))
        sh = rgb_to_sh(torch.as_tensor(_PALETTE))
        on_palette = (m.params.features_dc[m.aux.alive][:, 0, None, :] == sh[None]).all(-1)
        recolor_ok &= int(m.num_alive) == n_final and bool(on_palette.any(-1).all())
    info_ok = len(v["info"].strip().splitlines()) == 2 + 5

    native = {"built": v["built"], "loaded": native_io.load_native() is not None}
    if native["loaded"]:
        a, na = read_ply(v["final"])
        b, nb = numpy_only(read_ply, v["final"])
        native["read_equal"] = (na == nb and list(a) == list(b)
                                and all(np.array_equal(a[k], b[k]) for k in a))
        cols = np.stack([b[k] for k in b], axis=1)
        pn, pp = os.path.join(v["out"], "native.ply"), os.path.join(v["out"], "numpy.ply")
        write_ply(pn, list(b), cols)
        numpy_only(write_ply, pp, list(b), cols)
        with open(pn, "rb") as fa, open(pp, "rb") as fb:
            native["write_bytes_equal"] = fa.read() == fb.read()
    native_ok = all(native.values()) and len(native) == 4
    ok = (all(worst[k] <= DEEP_FWD_TOL[k] for k in worst) and not any(dropped.values())
          and frames_are_renders and wire_ok and recolor_ok and info_ok and native_ok)
    emit("viewers_checks", frames=sum(len(r) for r in v["renders"].values()),
         max_abs_err_vs_cuda=worst, tol=DEEP_FWD_TOL, tile_size=ts, dropped_pairs=dropped,
         freeview_frames_are_renders=frames_are_renders, wire_equal=wire_ok,
         recolor_ok=recolor_ok, info_ok=info_ok, native_io=native, ok=ok)
    if not ok:
        raise AssertionError(f"path 7 checks failed: {worst} {dropped} frames "
                             f"{frames_are_renders} wire {wire_ok} recolor {recolor_ok} "
                             f"info {info_ok} native {native}")
    shutil.rmtree(v["out"])


# path 9: the distributed layer on the one card. NCCL takes one GPU per
# rank, so the multi-rank runs are gloo ranks sharing the card (their
# collectives staged through host memory); the one-rank case is NCCL.
DIST_FB = 2  # path 9a's frames per step: one per rank
# path 9a's stage-1.0 schedule, path 1's cut to 80 steps for the time
# limit: one densify (iteration 50) and no opacity reset, so that after
# 60 std steps opacities pass the entropy-end prune (0.5); the label phase
DIST_SCHEDULE = dict(std_train_iter=60, entropy_reg_iter=10, label_train_iter=10,
                     densify_from_iter=40, densify_until_iter=50)
DIST_STEPS = 20  # path 9b's steps
GATHER_REPS = 10  # gloo all_gathers timed at the step's buffer size


PARAM_KEYS = ("xyz", "features_dc", "features_rest", "log_scales", "quats", "opacity_logit",
              "label")


def _host_state(model):
    """Every parameter and statistic of a model as numpy (for comparisons
    across processes)."""
    return {k: v.detach().cpu().numpy()
            for k, v in {**model.params.as_dict(), **model.aux.as_dict()}.items()}


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dist_static_cfg(sizes):
    from egogaussian_tpu_torch.config import Config

    cfg = Config()
    cfg.static = dataclasses.replace(cfg.static, frame_batch=DIST_FB, **sizes["schedule"])
    cfg.opt = dataclasses.replace(cfg.opt, **sizes["opt"])
    return cfg


def dist_sizes():
    """Path 9's schedule and rates, handed to its ranks (which import this
    script afresh)."""
    return dict(schedule=DIST_SCHEDULE, opt=SLICE_OPT, skip=STEADY_SKIP)


def dist_static_run(dev, vid, out, sizes, mesh=None):
    """train_static on path 1's video `vid` (first phase, seed 0) at frame
    batch DIST_FB and DIST_SCHEDULE, on `mesh` or in this process: the
    final model, std-mode steady it/s (host clock between syncs, the first
    sizes["skip"] iterations left out), the losses and the PLYs this
    process wrote."""
    from egogaussian_tpu_torch.data import split_viewpoints_by_phase
    from egogaussian_tpu_torch.parallel import scene_trainer
    from egogaussian_tpu_torch.train import static

    groups = split_viewpoints_by_phase(vid.cameras, vid.static_phases)
    cfg = _dist_static_cfg(sizes)
    losses, clock, plys = [], {}, []
    skip = sizes["skip"]

    def on_step(it, mode, loss):
        losses.append(loss)
        if it in (skip, cfg.static.std_train_iter):
            _sync(dev)
            clock[it] = time.perf_counter()

    # the stage loop is the one-scene case of the lockstep driver, which saves
    save_ply = scene_trainer.save_ply
    scene_trainer.save_ply = lambda model, path: (plys.append(path), save_ply(model, path))
    try:
        res = static.train_static(vid.cameras, vid.points, vid.colors, cfg, groups,
                                  nerfpp_radius(vid.cameras), save_dir=out, seed=0,
                                  first_phase_only=True, device=dev, mesh=mesh,
                                  on_step=on_step)[0]
    finally:
        scene_trainer.save_ply = save_ply
    it_s = ((cfg.static.std_train_iter - skip)
            / (clock[cfg.static.std_train_iter] - clock[skip]))
    return dict(state=_host_state(res.model), alive=int(res.model.num_alive),
                it_s=it_s, losses=[float(x) for x in losses], plys=plys,
                dropped_pairs=res.dropped_pairs)


def dist_static_rank(mesh, vid, outs, sizes):
    """One gloo rank of path 9a on path 1's video (`vid` on the host): one
    run into each of `outs` (a repeat in the same processes), then
    GATHER_REPS all_gathers of the step's reduced buffer (parameter
    gradients, loss, three per-Gaussian statistics, the drop count) timed
    alone. Returns each run with its seconds, and the gather's ms and
    bytes."""
    import torch

    from egogaussian_tpu_torch.parallel.mesh import gather_blocks, tree_map

    vid = tree_map(lambda t: t.to(mesh.device), vid)
    runs = []
    for out in outs:
        t0 = time.perf_counter()
        runs.append(dist_static_run(mesh.device, vid, out, sizes, mesh))
        runs[-1]["seconds"] = time.perf_counter() - t0
    run = runs[0]
    n = sum(v.size for k, v in run["state"].items() if k in PARAM_KEYS) + 2 + 3 * len(
        run["state"]["alive"])
    buf = torch.zeros(n, device=mesh.device)
    gather_blocks(mesh, buf)
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(GATHER_REPS):
        gather_blocks(mesh, buf)
    _sync(mesh.device)
    return dict(runs=runs, gather_ms=(time.perf_counter() - t0) / GATHER_REPS * 1e3,
                gather_bytes=4 * n)


def states_equal(a, b) -> bool:
    """Whether two host states (_host_state) agree bit for bit."""
    return all(np.array_equal(a[k], b[k]) for k in a)


def phase_dist_static(dev, vid, out_dir):
    """Path 9a: train_static on path 1's video at frame batch DIST_FB in this
    process, then twice on a 2-rank gloo mesh sharing the card (one frame
    per rank, the gradients reduced in rank order; the video handed to the
    ranks through host memory). Returns what check_dist_static needs."""
    from egogaussian_tpu_torch.parallel.launch import spawn
    from egogaussian_tpu_torch.parallel.mesh import tree_map

    root = os.path.join("build", "dist_static")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    single = dist_static_run(dev, vid, os.path.join(root, "single"), dist_sizes())
    single_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = spawn(dist_static_rank, 1, 2, "gloo", dev,
                  args=(tree_map(lambda t: t.cpu(), vid),
                        [os.path.join(root, f"mesh{i}") for i in range(2)], dist_sizes()))
    return dict(root=root, single=single, single_s=single_s, ranks=ranks,
                spawn_s=time.perf_counter() - t0)


def check_dist_static(d):
    """Both ranks' final models bit for bit, in both mesh runs; the PLYs
    written by rank 0 alone; the second mesh run equal to the first bit for
    bit; the mesh run against the single process within DIST_STATIC_TOL;
    step rates of both."""
    single = d["single"]
    runs = [[r["runs"][i] for r in d["ranks"]] for i in range(2)]  # [run][rank]
    ranks_same = all(states_equal(r[0]["state"], r[1]["state"]) for r in runs)
    repeat_same = states_equal(runs[0][0]["state"], runs[1][0]["state"])
    plys = [[len(r["plys"]) for r in run] for run in runs]
    files = sorted(os.listdir(os.path.join(d["root"], "mesh0", "ply")))
    a, b = single["state"], runs[0][0]["state"]
    both = a["alive"] & b["alive"]
    loss_s = np.mean(single["losses"][-10:])
    loss_m = np.mean(runs[0][0]["losses"][-10:])
    dist = {"alive_rel": abs(single["alive"] - runs[0][0]["alive"]) / max(single["alive"], 1),
            "last10_loss_rel": abs(loss_m - loss_s) / loss_s}
    # reported beside the bounds: the parameters of the rows alive in both
    common = {k: float(np.abs(a[k][both].astype(np.float64) - b[k][both]).max(initial=0.0))
              for k in PARAM_KEYS}
    ok = (ranks_same and repeat_same and plys == [[3, 0], [3, 0]] and len(files) == 3
          and single["alive"] > 0
          and all(dist[k] <= tol for k, tol in DIST_STATIC_TOL.items())
          and single["dropped_pairs"] == runs[0][0]["dropped_pairs"] == 0)
    if ok:
        shutil.rmtree(d["root"])
    emit("dist_static", frame_batch=DIST_FB, ranks=2, backend="gloo",
         single_it_s=single["it_s"], mesh_it_s=[r[0]["it_s"] for r in runs],
         single_step_ms=1e3 / single["it_s"], mesh_step_ms=[1e3 / r[0]["it_s"] for r in runs],
         single_seconds=d["single_s"], mesh_seconds=[r[0]["seconds"] for r in runs],
         spawn_seconds=d["spawn_s"], gather_ms=[r["gather_ms"] for r in d["ranks"]],
         gather_bytes=d["ranks"][0]["gather_bytes"],
         alive=[single["alive"], runs[0][0]["alive"]], vs_single=dist, tol=DIST_STATIC_TOL,
         param_max_abs_alive_in_both=common, first_loss_differing=next(
             (i for i, (x, y) in enumerate(zip(single["losses"], runs[0][0]["losses"]))
              if x != y), None),
         ranks_bit_identical=ranks_same, repeat_bit_identical=repeat_same, plys_written=plys,
         ply_files=files, ok=ok)
    if not ok:
        raise AssertionError(f"path 9a failed: ranks {ranks_same}, repeat {repeat_same}, "
                             f"PLY writes {plys}, against the single run {dist}")


# path 9a against the single process at the same frames: the ranks' mean
# of means reassociates the frame sum, and a prune threshold can flip for
# a few Gaussians. At 140 steps the card measured 1 alive Gaussian of
# 5,207 and equal last-ten losses, at 80 steps equal alive counts and
# 8.6e-9 (PERF.md §6)
DIST_STATIC_TOL = {"alive_rel": 5e-3, "last10_loss_rel": 1e-4}


def phase_dist_one_rank(dev, vid, extent):
    """Path 9b: _dp_static_step on a one-rank NCCL group against
    _static_step, DIST_STEPS steps each from path 1's initial model on
    phase 0's frames (the same frame and background draws), every step's
    loss, drop count and model bit for bit."""
    import tempfile

    import torch
    import torch.distributed as tdist

    from egogaussian_tpu_torch.data import split_viewpoints_by_phase, stack_cameras
    from egogaussian_tpu_torch.models.gaussians import from_points
    from egogaussian_tpu_torch.models.optim import adam_init
    from egogaussian_tpu_torch.parallel.mesh import make_mesh
    from egogaussian_tpu_torch.train.common import auto_tile_config
    from egogaussian_tpu_torch.train.static import _dp_static_step, _static_step

    cfg = _dist_static_cfg(dist_sizes())
    frames = split_viewpoints_by_phase(vid.cameras, vid.static_phases)[0]
    batch = stack_cameras([vid.cameras[i] for i in frames], dev)
    model0 = from_points(vid.points, vid.colors, dev, spatial_lr_scale=extent, seed=0)
    tile_cfg = auto_tile_config(model0, batch.camera(0))
    with tempfile.TemporaryDirectory() as tmp:
        tdist.init_process_group("nccl", store=tdist.FileStore(os.path.join(tmp, "s"), 1),
                                 rank=0, world_size=1)
        try:
            mesh = make_mesh(n_data=1, device=dev)
            states = []
            for step in (_static_step, lambda *a, **k: _dp_static_step(*a, mesh=mesh, **k)):
                rng = np.random.RandomState(0)
                model, opt = model0, adam_init(model0.params)
                drop = torch.zeros((), dtype=torch.int64, device=dev)
                trace = []
                for it in range(1, DIST_STEPS + 1):
                    fidxs = [int(rng.randint(len(frames)))]
                    bg = rng.rand(3).astype(np.float32)
                    model, opt, loss, _, drop = step(
                        model, opt, batch, fidxs, batch.hand_masks, it, drop, mode="std",
                        backend="cuda", tile_config=tile_cfg, bg_color=bg, opt_cfg=cfg.opt)
                    trace.append((loss, drop))
                _sync(dev)
                states.append((_host_state(model),
                               [(float(l), int(d)) for l, d in trace],
                               _host_state(dataclasses.replace(model0, params=opt.mu))))
        finally:
            tdist.destroy_process_group()
    same_steps = states[0][1] == states[1][1]
    same_model = states_equal(states[0][0], states[1][0])
    same_moments = states_equal(states[0][2], states[1][2])
    ok = same_steps and same_model and same_moments
    emit("dist_one_rank", backend="nccl", steps=DIST_STEPS, losses_and_drops_equal=same_steps,
         model_bit_identical=same_model, adam_moments_bit_identical=same_moments,
         last_loss=states[0][1][-1][0], ok=ok)
    if not ok:
        raise AssertionError("path 9b: the one-rank NCCL step differs from _static_step")


def dist_render_rank(mesh, cam, scene, tile_cfg):
    """One gloo rank of path 9c: both sharded renders under both backends
    (the memory-sharded one on this rank's block of rows)."""
    import torch

    from egogaussian_tpu_torch.parallel import (
        make_memory_sharded_render,
        make_sharded_render,
        shard_batch,
    )
    from egogaussian_tpu_torch.parallel.mesh import tree_map

    dev = mesh.device
    cam = tree_map(lambda t: t.to(dev), cam)
    scene = [torch.as_tensor(x, device=dev) for x in scene]
    out = {}
    for backend in ("cuda", "tiled"):
        t0 = time.perf_counter()
        rep = make_sharded_render(mesh, cam, backend=backend, tile_config=tile_cfg)(*scene)
        _sync(dev)
        t1 = time.perf_counter()
        mem, dropped = make_memory_sharded_render(mesh, cam, backend=backend,
                                                  tile_config=tile_cfg)(
            *shard_batch(mesh, tuple(scene)))
        _sync(dev)
        out[backend] = dict(
            replicated=[x.cpu().numpy() for x in (rep.image, rep.alpha, rep.depth)],
            memory=[x.cpu().numpy() for x in (mem.image, mem.alpha, mem.depth)],
            dropped=int(dropped), dropped_pairs=[int(rep.dropped_pairs), int(mem.dropped_pairs)],
            seconds=[t1 - t0, time.perf_counter() - t1])
    return out


def phase_dist_render(dev, vid, eval_model):
    """Path 9c: make_sharded_render and make_memory_sharded_render on 2
    gloo ranks sharing the card, path 3's ~102k-Gaussian kNN model at frame
    0 (640x480), backends "cuda" (rows 1-2 per slab) and "tiled" (row 6),
    with auto_tile_config of the whole model."""
    from egogaussian_tpu_torch.parallel.launch import spawn
    from egogaussian_tpu_torch.parallel.mesh import tree_map
    from egogaussian_tpu_torch.train.common import auto_tile_config, model_colors

    cam = vid.cameras[0]
    m = eval_model
    scene = [x.detach().cpu().numpy() for x in (m.params.xyz, m.covariance(), model_colors(m),
                                                m.opacity, m.aux.alive)]
    tile_cfg = auto_tile_config(m, cam)
    t0 = time.perf_counter()
    ranks = spawn(dist_render_rank, 1, 2, "gloo", dev,
                  args=(tree_map(lambda t: t.cpu(), cam), scene, tile_cfg))
    return dict(ranks=ranks, tile_cfg=tile_cfg, seconds=time.perf_counter() - t0)


def check_dist_render(dev, vid, eval_model, d, errs):
    """After path 9's counts are read: every rank's merged images equal
    rank 0's bit for bit; each against the single render of the same
    backend and tile config within DEEP_FWD_TOL; the memory-sharded
    render drops no Gaussian and no slab drops pairs; rows 1-2 against
    their twins (check_layout) on slab 0's tile-grid layout."""
    import torch

    from egogaussian_tpu_torch.parallel.shard_render import depth_slab
    from egogaussian_tpu_torch.render.api import render
    from egogaussian_tpu_torch.render.project import project_gaussians
    from egogaussian_tpu_torch.render.tiled import tilegrid_layout
    from egogaussian_tpu_torch.train.common import model_colors

    cam, m, cfg = vid.cameras[0], eval_model, d["tile_cfg"]
    bg = torch.zeros(3, device=dev)
    cols = model_colors(m)
    worst, same, dropped = {}, True, []
    with torch.no_grad():
        for backend in ("cuda", "tiled"):
            ref = render(cam, m.params.xyz, m.covariance(), m.opacity, bg, colors_precomp=cols,
                         valid_mask=m.aux.alive, backend=backend, tile_config=cfg)
            ref = [x.cpu().numpy() for x in (ref.image, ref.alpha, ref.depth)]
            for kind in ("replicated", "memory"):
                r0 = d["ranks"][0][backend][kind]
                same &= all(np.array_equal(a, b) for a, b in zip(r0, d["ranks"][1][backend][kind]))
                worst[f"{backend}_{kind}"] = {
                    k: float(np.abs(a - b).max()) for k, a, b in zip(DEEP_FWD_TOL, r0, ref)}
            dropped.append([backend, d["ranks"][0][backend]["dropped"],
                            d["ranks"][0][backend]["dropped_pairs"]])
        def project(valid):
            return project_gaussians(m.params.xyz, m.covariance(), cam.viewmat, cam.fx,
                                     cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                                     valid_mask=valid)

        # slab 0's projection, as its render in make_sharded_render makes it
        slab = depth_slab(project(m.aux.alive), 0, 2)
        lay = tilegrid_layout(project(slab), cols, m.opacity, cam.width, cam.height, cfg)
        if int(lay.dropped):
            raise AssertionError("path 9c: slab 0's layout dropped pairs")
    with torch.enable_grad():
        check_layout(f"slab0_of_2_{cam.width}x{cam.height}", lay, 3, bg, DEEP_FWD_TOL,
                     cam.width, cam.height, errs)
    ok = (same and all(v[k] <= DEEP_FWD_TOL[k] for v in worst.values() for k in v)
          and not any(n or any(p) for _, n, p in dropped))
    emit("dist_render", ranks=2, backend="gloo", frame=0, width=cam.width, height=cam.height,
         gaussians=int(m.num_alive), vs_single=worst, tol=DEEP_FWD_TOL, ranks_bit_identical=same,
         dropped=dropped, seconds=d["seconds"],
         per_render_seconds={b: d["ranks"][0][b]["seconds"] for b in ("cuda", "tiled")},
         slab0_gaussians=int(slab.sum()), ok=ok)
    if not ok:
        raise AssertionError(f"path 9c failed: {worst}, dropped {dropped}, same {same}")


def phase_dist_multi(dev, multi, out_dir):
    """Path 9d: cli/train_multi.py --mesh 2x1 --dist_backend gloo
    --stage1_only over path 8's two videos and flags, as a child process
    (its ranks' launch counts come back through parallel/launch.py)."""
    root = os.path.dirname(multi["outs"][0])
    outs = [os.path.join(root, f"dist_multi{i}") for i in range(2)]
    for o in outs:
        shutil.rmtree(o, ignore_errors=True)
    argv = list(multi["argv"])
    argv[argv.index("--outputs") + 1:argv.index("--outputs") + 3] = outs
    argv[argv.index("--mesh") + 1] = "2x1"
    argv += ["--dist_backend", "gloo", "--stage1_only"]
    ended, seconds, launches = run_child(argv, "dist_multi_run", out_dir,
                                         flag="--train-multi-child")
    if ended != "exit 0":
        raise AssertionError(f"path 9d: the multi-video CLI ended with {ended}")
    return dict(outs=outs, seconds=seconds), launches


def check_dist_multi(multi, d):
    """Every file of stages 1.0 and 1.2 (static/, background/) of each
    video against path 8's, byte for byte."""
    differ, n = [], 0
    for a, b in zip(multi["outs"], d["outs"]):
        for sub in ("static", "background"):
            for dirpath, _, fs in os.walk(os.path.join(a, sub)):
                for f in fs:
                    rel = os.path.relpath(os.path.join(dirpath, f), a)
                    n += 1
                    if not (os.path.exists(os.path.join(b, rel))
                            and filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                                            shallow=False)):
                        differ.append(rel)
    stage_s = [{r["name"]: r["seconds"] for r in pipeline_records(o)
                if r.get("event") == "stage_time"} for o in d["outs"]]
    ok = n > 0 and not differ
    emit("dist_multi", mesh="2x1", backend="gloo", seconds=d["seconds"], ran_beside="path 6",
         stage_seconds=stage_s, files=n, files_differ=differ, ok=ok)
    if not ok:
        raise AssertionError(f"path 9d: stage-1 files differ from path 8's: {differ[:10]}")


def phase_dist_dryrun():
    """Path 9e: dryrun_multichip(2): with one card, two gloo CPU ranks; the
    frame-data-parallel checks, then the scene-axis checks on a 2x1 grid."""
    from egogaussian_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    lines = dryrun_multichip(2)
    ok = len(lines) == 6 and all(line.endswith("OK") for line in lines)
    emit("dist_dryrun", lines=lines, seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise AssertionError(f"path 9e: {lines}")


def path_9_beside_6(dev, vid, eval_model, multi, out_dir):
    """Paths 9c-9e, run in a thread beside path 6 (paths_5_to_8), each with
    the launch counters set to 0 just before it and read just after (the
    ranks' counts folded in by parallel/launch.py; path 6's runs are child
    processes with counts of their own, so they launch nothing here).
    Returns (what check_path_9 needs of them, launch counts)."""
    launches = {}
    reset_launch_counts()
    render = phase_dist_render(dev, vid, eval_model)
    launches["dist_render"] = launch_counts()
    reset_launch_counts()
    dmulti, launches["dist_multi"] = phase_dist_multi(dev, multi, out_dir)
    reset_launch_counts()
    phase_dist_dryrun()
    launches["dist_dryrun"] = launch_counts()
    return dict(render=render, multi=dmulti), launches


def path_9(dev, vid, extent, beside, out_dir):
    """Paths 9a and 9b (timed, so alone on the card), each with the launch
    counters set to 0 just before it and read just after, beside what
    path_9_beside_6 returned for 9c-9e."""
    p9, launches = beside
    reset_launch_counts()
    static = phase_dist_static(dev, vid, out_dir)
    launches["dist_static"] = launch_counts()
    reset_launch_counts()
    phase_dist_one_rank(dev, vid, extent)
    launches["dist_one_rank"] = launch_counts()
    emit("dist_launches", **{p: {k: n for k, n in c.items() if n} for p, c in launches.items()})
    need = {"dist_static": ("tilegrid_fwd_d3", "tilegrid_bwd_d3", "tilegrid_fwd_d1",
                            "tilegrid_bwd_d1"),
            "dist_one_rank": ("tilegrid_fwd_d3", "tilegrid_bwd_d3"),
            "dist_render": ("tilegrid_fwd_d3", "window_chunked_fwd_d3"),
            "dist_multi": ("tilegrid_fwd_d3", "tilegrid_bwd_d3", "tilegrid_fwd_d1",
                           "tilegrid_bwd_d1")}
    missing = [(p, k) for p, ks in need.items() for k in ks if launches[p][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on path 9: {missing}")
    return dict(p9, static=static), launches


def check_path_9(dev, vid, eval_model, multi, p9, errs):
    check_dist_static(p9["static"])
    check_dist_render(dev, vid, eval_model, p9["render"], errs)
    check_dist_multi(multi, p9["multi"])


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



# ---------------------------------------------------------------------------
# The lockstep's steps (path 8's, launches per iteration) and the pose probe
# ---------------------------------------------------------------------------

def differing_files(dir_a, dir_b):
    """Files of dir_a (cfg_args.json and the metrics log aside) that dir_b
    lacks or holds with other bytes."""
    files = sorted(os.path.relpath(os.path.join(d, f), dir_a)
                   for d, _, fs in os.walk(dir_a) for f in fs)
    files = [f for f in files if f != "cfg_args.json" and not f.startswith("logs")]
    return [f for f in files if not os.path.exists(os.path.join(dir_b, f))
            or not filecmp.cmp(os.path.join(dir_a, f), os.path.join(dir_b, f), shallow=False)]


def coarse_start(dev, model_dir5):
    """Path 5's stage-3 from-coarse start: its COLMAP scene's frames, the
    coarse object model and pose sequence, a solved dynamic frame f past
    the first and its stored pose, the auto tile config."""
    import dataclasses as dc

    from egogaussian_tpu_torch.data.readers import load_colmap_scene, stack_cameras
    from egogaussian_tpu_torch.models.gaussians import load_ply
    from egogaussian_tpu_torch.models.pose import identity_pose, load_pose_sequence
    from egogaussian_tpu_torch.train.common import auto_tile_config

    scene = load_colmap_scene(os.path.join(os.path.dirname(model_dir5), "data"), dev)
    batch = stack_cameras(scene.cameras, dev)
    model = load_ply(os.path.join(model_dir5, "coarse", "ply", "gaussians_final.ply"), dev,
                     is_object=True)
    seq, _ = load_pose_sequence(os.path.join(model_dir5, "coarse", "obj_pose_sequence.npz"), dev)
    dyn = [i for i in range(seq.num_frames) if bool(seq.solved[i]) and i > 0]
    f = dyn[len(dyn) // 2]
    pose = dc.replace(identity_pose(dev), translation=seq.translations[f],
                      rot6d=seq.rotations[f][:, :2])
    return dict(batch=batch, model=model, seq=seq, f=f, pose=pose,
                tcfg=auto_tile_config(model, batch.camera(0)))


def step_launches(dev, step, iters):
    """Per iteration of step(it) (after three warm-up calls): the CUDA
    kernels the card ran (CUPTI activity, memcpy and memset aside), the
    runtime launch calls, the ATen ops, the compositor's own counters and
    the wall ms, under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for it in range(1, 4):  # warm-up: allocator, library, cuDNN plans
        step(it)
    _sync(dev)
    reset_launch_counts()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for it in range(4, 4 + iters):
            step(it)
        _sync(dev)
        wall = (time.perf_counter() - t0) / iters
    own = {k: n / iters for k, n in launch_counts().items() if n}
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith(("Memcpy", "Memset"))]
    runtime = [e for e in events if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                               "cuLaunchKernel", "cuLaunchKernelEx",
                                               "cudaLaunchKernelEx")]
    aten = [e for e in events if e.name.startswith("aten::")]
    return {"device_kernels_per_iteration": len(device) / iters,
            "runtime_launches_per_iteration": len(runtime) / iters,
            "aten_ops_per_iteration": len(aten) / iters,
            "wall_ms_per_iteration": wall * 1e3,
            "compositor_launches_per_iteration": own}


def phase_lockstep_launches(dev, vid, model_dir5, iters=3):
    """Launches per iteration of the lockstep's steps at S = 1 and at S = 2
    (the same scene twice), step_launches each: stage 1.0's static step
    (std mode, path 1's video and 102,000-Gaussian initial model, a
    six-frame batch), and on path 5's stage-3 start (coarse_start) the
    stage-2 and stage-3 pose steps as their drivers call them (crop
    windows of pose_crop_size, the pose trained) and the stage-5 step on
    path 5's final model. Emits each step's rows and S = 2 over S = 1."""
    import torch

    from egogaussian_tpu_torch.config import Config
    from egogaussian_tpu_torch.data import stack_cameras
    from egogaussian_tpu_torch.models import adam_init, from_points
    from egogaussian_tpu_torch.models.gaussians import load_ply
    from egogaussian_tpu_torch.models.pose import identity_pose
    from egogaussian_tpu_torch.parallel.multi_scene import multi_scene_static_step, stack_scenes
    from egogaussian_tpu_torch.render.tiled import scene_caps
    from egogaussian_tpu_torch.train.coarse_pose import _accum_tables, coarse_scenes_step
    from egogaussian_tpu_torch.train.common import auto_tile_config, pose_crop_size
    from egogaussian_tpu_torch.train.fine_all import fine_all_scenes_step
    from egogaussian_tpu_torch.train.fine_obj import accum_tables, fine_scenes_step

    cfg = Config()
    init = from_points(vid.points, vid.colors, dev, spatial_lr_scale=nerfpp_radius(vid.cameras),
                       seed=0)
    b6 = stack_cameras(vid.cameras[:6], dev)
    t6 = auto_tile_config(init, b6.camera(0))
    p = coarse_start(dev, model_dir5)
    batch, obj, seq, f = p["batch"], p["model"], p["seq"], p["f"]
    full = load_ply(os.path.join(model_dir5, "fine_all", "gaussians_all.ply"), dev)
    t_full = auto_tile_config(full, batch.camera(0))
    size = (batch.width, batch.height)

    def zeros(s_n, *shape, dtype=torch.int64):
        return torch.zeros((s_n,) + shape, dtype=dtype, device=dev)

    def static_step(s_n):
        models, opts = stack_scenes([init] * s_n), stack_scenes([adam_init(init.params)] * s_n)
        batches, masks = stack_scenes([b6] * s_n), stack_scenes([b6.hand_masks] * s_n)
        caps = scene_caps([t6] * s_n, [(b6.width, b6.height)] * s_n, dev, init.capacity)
        return lambda it: multi_scene_static_step(
            models, opts, batches, torch.tensor([[(it + s) % 6] for s in range(s_n)]), masks,
            it, zeros(s_n), mode="std", backend="cuda", tile_config=caps, opt_cfg=cfg.opt)

    def pose_caps(s_n, stage, model):
        crop = pose_crop_size(batch, cfg, stage)
        return crop is not None, scene_caps([p["tcfg"]] * s_n, [crop or size] * s_n, dev,
                                            model.capacity)

    def coarse_step(s_n):
        crop, caps = pose_caps(s_n, "coarse", obj)
        t_T, t_R = (stack_scenes([t] * s_n) for t in _accum_tables(seq))
        args = (stack_scenes([obj] * s_n), stack_scenes([adam_init(obj.params)] * s_n),
                stack_scenes([p["pose"]] * s_n),
                stack_scenes([adam_init(identity_pose(dev))] * s_n), stack_scenes([batch] * s_n))
        return lambda it: coarse_scenes_step(
            *args, [f] * s_n, t_T, t_R, [f - 1] * s_n, cfg.coarse.warm_up_iter + it,
            zeros(s_n), [True] * s_n, [False] * s_n, True, opt_cfg=cfg.opt,
            coarse_cfg=cfg.coarse, backend="cuda", tile_config=caps, crop=crop,
            crop_maxes=zeros(s_n, 3, dtype=torch.int32) if crop else None)

    def fine_step(s_n):
        crop, caps = pose_caps(s_n, "fine_obj", obj)
        seqs = stack_scenes([seq] * s_n)
        args = (stack_scenes([obj] * s_n), stack_scenes([adam_init(obj.params)] * s_n), seqs,
                stack_scenes([adam_init(identity_pose(dev))] * s_n), stack_scenes([batch] * s_n))
        accums = accum_tables(seqs)
        return lambda it: fine_scenes_step(
            *args, [f] * s_n, cfg.fine.densify_until_iter + it, zeros(s_n), [True] * s_n,
            opt_cfg=cfg.opt, fine_cfg=cfg.fine, backend="cuda", tile_config=caps, crop=crop,
            crop_maxes=zeros(s_n, 3, dtype=torch.int32) if crop else None, accums=accums)

    def fine_all_step(s_n):
        caps = scene_caps([t_full] * s_n, [size] * s_n, dev, full.capacity)
        acc_T = torch.stack([seq.accum_T()] * s_n)
        acc_R = torch.stack([seq.accum_R()] * s_n)
        models = stack_scenes([full] * s_n)
        opts = stack_scenes([adam_init(full.params)] * s_n)
        return lambda it: fine_all_scenes_step(
            models, opts, stack_scenes([batch] * s_n), [f] * s_n, acc_T, acc_R, it, False,
            zeros(s_n), lambda_dssim=cfg.fine_all.lambda_dssim, backend="cuda",
            tile_config=caps, opt_cfg=cfg.opt)

    out = {}
    for name, make in (("static std", static_step), ("coarse", coarse_step),
                       ("fine_obj", fine_step), ("fine_all", fine_all_step)):
        rows = {s_n: step_launches(dev, make(s_n), iters) for s_n in (1, 2)}
        key = ("device_kernels_per_iteration" if dev.type == "cuda"
               else "aten_ops_per_iteration")
        ratio = rows[2][key] / max(rows[1][key], 1.0)
        out[name] = dict(scenes=rows, s2_over_s1=ratio, within_10_percent=ratio <= 1.10)
    emit("lockstep_launches", steps=out)
    return out


def phase_pose_probe(dev, model_dir5):
    """The stage-3 pose gradient of path 5's from-coarse start
    (coarse_start: a dynamic frame with the pose trained) against the same
    gradient under (a) doubled binning capacities (max_pairs,
    max_per_tile, max_slots), (b) the model padded with dead rows to twice
    its capacity in the scene stack (its own rows stay its capacity, as a
    lockstep lane below the stack's capacity), (c) the lockstep at S = 2
    beside a second lane of twice the capacity, and (d) a model whose own
    capacity is twice as large (another run: its sums take more rows):
    per case the largest difference of the loss, the pose gradient and
    the parameter gradients (0 = bit for bit). Raises unless (a)-(c) are
    0."""
    import dataclasses as dc

    import torch

    from egogaussian_tpu_torch.config import Config
    from egogaussian_tpu_torch.models.gaussians import ensure_capacity
    from egogaussian_tpu_torch.models.optim import adam_init
    from egogaussian_tpu_torch.parallel.multi_scene import stack_scenes
    from egogaussian_tpu_torch.render.tiled import scene_caps
    from egogaussian_tpu_torch.train.coarse_pose import pose_loss_grads_scenes

    p = coarse_start(dev, model_dir5)
    batch, model, seq, f, tcfg = p["batch"], p["model"], p["seq"], p["f"], p["tcfg"]
    acc_T, acc_R = seq.accum_T(), seq.accum_R()
    lam = Config().fine

    def grads(models, caps, lanes=1):
        return pose_loss_grads_scenes(
            models, stack_scenes([p["pose"]] * lanes), stack_scenes([batch] * lanes),
            torch.tensor([f] * lanes, device=dev), acc_T[f - 1][None].expand(lanes, 4, 4),
            acc_R[f - 1][None].expand(lanes, 3, 3), [True] * lanes,
            lambda_image=lam.lambda_Ll1_image, lambda_dssim=lam.lambda_dssim,
            lambda_l1_alpha=lam.lambda_Ll1_alpha, lambda_l2_alpha=lam.lambda_Ll2_alpha,
            backend="cuda", caps=caps)

    size = [(batch.width, batch.height)]
    c = model.capacity
    base = grads(stack_scenes([model]), scene_caps([tcfg], size, dev, c))
    double = dc.replace(tcfg, max_pairs=2 * tcfg.max_pairs, max_per_tile=2 * tcfg.max_per_tile,
                        max_slots=2 * (tcfg.max_slots or tcfg.max_pairs))
    padded, _, _ = ensure_capacity(model, adam_init(model.params), min_free=c + 1)
    cases = {
        "binning_capacities_x2": grads(stack_scenes([model]),
                                       scene_caps([double], size, dev, c)),
        "stack_padded_x2": grads(dc.replace(stack_scenes([padded]), scene_rows=(c,)),
                                 scene_caps([tcfg], size, dev, padded.capacity)),
        "lockstep_s2_beside_x2_lane": grads(stack_scenes([model, padded]),
                                            scene_caps([tcfg, tcfg], size * 2, dev,
                                                       padded.capacity), lanes=2),
        "own_capacity_x2": grads(stack_scenes([padded]),
                                 scene_caps([tcfg], size, dev, padded.capacity)),
    }
    out = {}
    for name, g in cases.items():
        out[name] = {
            "loss": float((g.loss[0] - base.loss[0]).abs()),
            "pose_translation": float((g.pose.translation[0] - base.pose.translation[0])
                                      .abs().max()),
            "pose_rot6d": float((g.pose.rot6d[0] - base.pose.rot6d[0]).abs().max()),
            "params": max(max_err(getattr(g.params, k)[0][:c], getattr(base.params, k)[0])
                          for k in base.params.as_dict()),
            "probe": float((g.probe[0][:c] - base.probe[0]).abs().max()),
        }
    exact = [k for k in cases if k != "own_capacity_x2"]
    ok = all(v == 0.0 for k in exact for v in out[k].values())
    emit("pose_probe", frame=f, gaussians=int(model.num_alive), capacity=c,
         pose_grad_scale=float(base.pose.rot6d.abs().max()), cases=out, bit_for_bit=exact,
         ok=ok)
    if not ok:
        raise AssertionError(f"pose probe: a padded capacity moved the pose gradient {out}")
    return out


def paths_5_to_8(dev, vid, out_dir, repro=False, beside_6=None):
    """Paths 5, 6, 7 and 8, each with the launch counters set to 0 just
    before it and read just after (paths 6's and 8's from their child
    processes). beside_6(multi), where given, runs in a thread while
    path 6 runs: path 6's three runs are child processes checked by their
    files alone, so no time of theirs is compared. Returns (what the checks
    need, {path: launch counts}, what beside_6 returned)."""
    launches = {}
    reset_launch_counts()
    pipe = phase_pipeline(dev, vid, out_dir)
    launches["pipeline"] = launch_counts()
    emit("pipeline_launches", **{k: n for k, n in launches["pipeline"].items() if n})
    for name in ("tilegrid_fwd_d3", "tilegrid_bwd_d3", "window_chunked_fwd_d3"):
        if launches["pipeline"][name] <= 0:
            raise AssertionError(f"{name} never launched on the pipeline path")
    src, model_dir, weights, argv, _ = pipe
    if repro:
        repro_run(argv, model_dir, out_dir)
    multi = multi_inputs(dev, vid, src, model_dir, weights)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        side = pool.submit(beside_6, multi) if beside_6 else None
        _, launches["checkpoint"] = phase_checkpoint(argv, model_dir, out_dir)
        side = side.result() if side else None
    reset_launch_counts()
    views = phase_viewers(dev, src, model_dir, out_dir)
    launches["viewers"] = launch_counts()
    emit("viewers_launches", **{k: n for k, n in launches["viewers"].items() if n})
    if launches["viewers"]["window_chunked_fwd_d3"] <= 0:
        raise AssertionError("window_chunked_fwd_d3 never launched on the viewer path")
    launches["multi"] = phase_multi(multi, out_dir)
    emit("multi_launches", **{k: n for k, n in launches["multi"].items() if n})
    for name in ("tilegrid_fwd_d3", "tilegrid_bwd_d3", "tilegrid_fwd_d1", "tilegrid_bwd_d1",
                 "window_chunked_fwd_d3"):
        if launches["multi"][name] <= 0:
            raise AssertionError(f"{name} never launched on the multi path")
    # video 1's own run, the tree its lane is held to (a child: its
    # launches are not path 8's)
    phase_multi_single(multi, out_dir)
    # per-iteration launches of the lockstep's steps at S = 1 and 2 (after
    # every path's counts are read)
    phase_lockstep_launches(dev, vid, model_dir)
    return (pipe, views, multi, launches), launches, side


def check_paths_5_to_8(dev, pipe, errs):
    pipe, views, multi, launches = pipe
    check_viewers(views)
    phase_pose_probe(dev, pipe[1])
    check_multi(dev, multi, pipe[1], launches["pipeline"], launches["multi"], errs)
    check_pipeline(dev, *pipe, errs)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the kernel checks (no slice, no result line)")
    parser.add_argument("--pipeline-only", action="store_true",
                        help="paths 5-8 and their checks only (no result line)")
    parser.add_argument("--repro", action="store_true",
                        help="with --pipeline-only: run path 5's flags once more, unbroken, "
                             "and print the spread against path 5")
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
    # nvcc runs on the host's cores while the card renders path 1's video
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        build = pool.submit(cr.build_library)
        vid = None if args.kernels_only else slice_video(dev)
        path, log = build.result()
    cr.kernel_library()
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        f.write(log)
    emit("build", seconds=time.time() - t0, library=os.path.relpath(path),
         ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln])

    errs = {}
    if args.pipeline_only:
        pipe, path_launches, _ = paths_5_to_8(dev, vid, out_dir, args.repro)
        check_paths_5_to_8(dev, pipe, errs)
        emit("launches", **path_launches)
        return 0
    phase_kernels(dev, errs)
    if args.kernels_only:
        return 0

    # path 1: stage-1.0 static training
    reset_launch_counts()
    vid, extent, _, slice_model = phase_slice(dev, vid, out_dir)
    path_launches = {"slice": launch_counts()}
    # path 2: stage-2 coarse pose, then its step under each flavor
    reset_launch_counts()
    seq, model, dyn, ccfg = phase_coarse(dev, vid, extent, object_handover(slice_model, vid),
                                         out_dir)
    fr = flavor_frame(dev, vid, seq, model, dyn, ccfg)
    phase_flavors(model, ccfg, fr)
    phase_stream_lockstep(model, ccfg, fr, dyn, seq)
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
    # paths 5-8: the six-stage pipeline through the training CLI, the same
    # run killed and resumed from its checkpoints, the viewers and tools,
    # the multi-video CLI over path 5's video and a second one in lockstep,
    # with path 9's sharded
    # renders, multi-video CLI's scene axis and dry run beside path 6
    pipe, launches5, beside = paths_5_to_8(
        dev, vid, out_dir,
        beside_6=lambda multi: path_9_beside_6(dev, vid, eval_model, multi, out_dir))
    path_launches.update(launches5)
    # path 9: the distributed layer (gloo ranks sharing the card, a
    # one-rank NCCL group; 9c-9e ran beside path 6)
    p9, launches9 = path_9(dev, vid, extent, beside, out_dir)
    path_launches.update(launches9)
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
    check_path_9(dev, vid, eval_model, pipe[2], p9, errs)  # before path 5's tree goes
    check_paths_5_to_8(dev, pipe, errs)
    check_entry(entry, vid.cameras[0], errs)
    phase_frame_kernels(model, fr, errs)
    ms, plain_ms, b = check_peak(dev, errs, peak_gflops)
    times, bounds = phase_timing(dev, vid, extent, errs, peak_gflops)
    times[("fma_peak", None)] = (ms, plain_ms)
    bounds[("fma_peak", None)] = (b[0], b[1], b[0], None)
    phase_profile(dev, vid, extent, out_dir)
    phase_eval_profile(dev, vid, eval_model, eval_seq, out_dir)

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
                # rows 1-3 and 6-7: frames 0 and 1 in one launch (the scene
                # axis) beside the two one-scene launches' sum
                **({"ms_scenes2": times[("scenes2", key, d)][0],
                    "ms_scenes1_sum": times[("scenes2", key, d)][1]}
                   if ("scenes2", key, d) in times else {}),
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
    if sys.argv[1:2] and sys.argv[1] in CHILD_CLIS:  # paths 6 and 8: counts file, "--", args
        sys.exit(train_child(sys.argv[2], sys.argv[4:], CHILD_CLIS[sys.argv[1]]))
    sys.exit(main())
