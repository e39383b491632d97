#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (one JSON line each; any failure raises, so the exit code is
nonzero and no result line is printed):
  1. device:  requires CUDA; prints the card (nvidia-smi name, power limit)
  2. build:   compiles the tile-grid kernels from egogaussian_tpu_torch/csrc
  3. kernels: each kernel against its plain PyTorch twin on the card, at
              D = 3 and 1, tile sizes 16 and 32, on three scenes (60
              Gaussians at 48x32, 2k at 256x192, a kNN-init deep-tile scene
              at 320x240), plus the cuda render against the oracle
  4. slice:   stage-1.0 static training (train_static) on a 640x480
              synthetic video with ~100k Gaussians, shortened schedule;
              launch counters must show every kernel ran; PLY round trip
  5. timing:  kernel vs plain twin (CUDA events) at the slice's shapes
  6. profile: torch.profiler over std-mode steps at the slice's size:
              device time by kernel and the device's busy share
              (table in chiprun_out/chip_smoke/profile.txt)
Then the kernel table, the nvidia-smi line, and the result line
{"ok": true, "device": {...}}.

Imports no JAX. Writes its outputs under chiprun_out/chip_smoke/.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    fit = int(meta[2, 0])
    k_d, p_d = k_d[:fit], p_d[:fit]
    excess = float(((k_d - p_d).abs() - (GRAD_ATOL + GRAD_RTOL * p_d.abs())).max()) if fit else -1.0
    grad_err = float((k_d - p_d).abs().max()) if fit else 0.0
    ok = all(fwd_err[k] <= tol[k] for k in tol) and excess <= 0.0
    depth_max = int(meta[1].max())
    emit("kernel_check", case=name, d=d, tile_size=ts, fwd_err=fwd_err,
         grad_max_abs_err=grad_err, grad_scale=float(p_d.abs().max()) if fit else 0.0,
         deepest_tile=depth_max, ok=ok)
    if not ok:
        raise AssertionError(f"kernel vs twin out of tolerance: {name} d={d} ts={ts}")
    errs.setdefault(("fwd", d), []).append(max(fwd_err.values()))
    errs.setdefault(("bwd", d), []).append(grad_err)


def phase_kernels(dev, errs):
    import torch

    from egogaussian_tpu_torch.data.synthetic import make_synthetic_video
    from egogaussian_tpu_torch.models.gaussians import from_points
    from egogaussian_tpu_torch.render.api import render
    from egogaussian_tpu_torch.render.project import project_gaussians
    from egogaussian_tpu_torch.render.tiled import TileConfig, tilegrid_layout
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
                if int(lay.dropped):
                    raise AssertionError(f"{name}: pairs dropped in the check scene")
                check_layout(name, lay, d, bg, tol, cam.width, cam.height, errs)

    # 1) 60 Gaussians at 48x32 (tests/test_pallas_raster.py:23-36)
    cam = look_at_camera(48, 32, dev)
    means, cov3d, colors, ops = random_scene(60, 11, dev)
    small_cfg = lambda ts: TileConfig(max_per_tile=256, max_pairs=8192, tile_size=ts)  # noqa: E731
    scene_cases("random60_48x32", cam, means, cov3d, colors, ops, small_cfg, FWD_TOL)
    # the cuda render against the port's oracle on the same scene
    bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
    with torch.no_grad():
        a = render(cam, means, cov3d, ops, bg, colors_precomp=colors, backend="oracle")
        b = render(cam, means, cov3d, ops, bg, colors_precomp=colors, backend="cuda",
                   tile_config=small_cfg(16))
    oracle_err = {k: float((getattr(a, k) - getattr(b, k)).abs().max())
                  for k in ("image", "alpha", "depth")}
    ok = all(oracle_err[k] <= FWD_TOL[k] for k in FWD_TOL)
    emit("kernel_vs_oracle", case="random60_48x32", err=oracle_err, ok=ok)
    if not ok:
        raise AssertionError("cuda render vs oracle out of tolerance")

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
    return vid, extent, launches


def phase_timing(dev, vid, extent, errs):
    """Kernel vs plain twin at the slice's shapes: the kNN-initialized model
    of the slice (its heaviest, ~100k Gaussians, the state std mode starts
    from) on frame 0 at 640x480; D = 3 (image) and D = 1 (label)."""
    import torch

    from egogaussian_tpu_torch.models.gaussians import from_points
    from egogaussian_tpu_torch.render import cuda_raster as cr
    from egogaussian_tpu_torch.render.project import project_gaussians
    from egogaussian_tpu_torch.render.tiled import tilegrid_layout
    from egogaussian_tpu_torch.train.common import auto_tile_config, model_colors

    model = from_points(vid.points, vid.colors, dev, spatial_lr_scale=extent, seed=0)
    cam = vid.cameras[0]
    cfg = auto_tile_config(model, cam)
    times = {}
    proj = project_gaussians(model.params.xyz, model.covariance(), cam.viewmat, cam.fx,
                             cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                             valid_mask=model.aux.alive)
    opac = torch.where(model.aux.alive, model.opacity, torch.zeros_like(model.opacity))
    for d, cols, bg in ((3, model_colors(model), torch.zeros(3, device=dev)),
                        (1, model.params.label, torch.zeros(1, device=dev))):
        lay = tilegrid_layout(proj, cols, opac, cam.width, cam.height, cfg)
        check_layout(f"slice_{cam.width}x{cam.height}_d{d}", lay, d, bg, FWD_TOL,
                     cam.width, cam.height, errs)
        meta, vals = lay.meta, lay.vals.detach().contiguous()
        ts, n_tx = lay.tile_size, lay.n_tx
        bg2 = bg[None].contiguous()
        with torch.no_grad():
            out = cr.tilegrid_forward(meta, vals, bg2, ts, n_tx)
            gen = torch.Generator(device=dev).manual_seed(1)
            cot = [torch.randn(x.shape, generator=gen, device=dev) * 1e-3 for x in out]
            times[("fwd", d)] = (
                cuda_ms(lambda: cr.tilegrid_forward(meta, vals, bg2, ts, n_tx)),
                cuda_ms(lambda: cr.composite_tilegrid_plain_fwd(meta, vals, bg2, ts, n_tx),
                        iters=5, warmup=1))
            times[("bwd", d)] = (
                cuda_ms(lambda: cr.tilegrid_backward(meta, vals, bg2, *out, *cot, ts, n_tx)),
                cuda_ms(lambda: cr.composite_tilegrid_plain_bwd(meta, vals, bg2, *out, *cot,
                                                                ts, n_tx),
                        iters=5, warmup=1))
        emit("timing", d=d, tile_size=ts, gaussians=int(model.num_alive),
             tiles=meta.shape[1], slots=vals.shape[0], deepest_tile=int(meta[1].max()),
             pairs=int(meta[1].sum()), dropped=int(lay.dropped),
             fwd_ms=times[("fwd", d)][0], fwd_plain_ms=times[("fwd", d)][1],
             bwd_ms=times[("bwd", d)][0], bwd_plain_ms=times[("bwd", d)][1])
    return times


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


KERNELS = {
    "fwd": ("egogaussian_tpu_torch/csrc/tilegrid_fwd.cu",
            "egogaussian_tpu/render/pallas_raster.py:890"),
    "bwd": ("egogaussian_tpu_torch/csrc/tilegrid_bwd.cu",
            "egogaussian_tpu/render/pallas_raster.py:984"),
}


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
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.time()
    path, log = cr.build_library()
    cr.kernel_library()
    emit("build", seconds=time.time() - t0, library=os.path.relpath(path),
         ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln])

    errs = {}
    phase_kernels(dev, errs)
    if args.kernels_only:
        return 0

    out_dir = os.path.join("chiprun_out", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    vid, extent, launches = phase_slice(dev, out_dir)
    times = phase_timing(dev, vid, extent, errs)
    phase_profile(dev, vid, extent, out_dir)

    table = []
    for kind in ("fwd", "bwd"):
        for d in (3, 1):
            src, replaces = KERNELS[kind]
            table.append({
                "name": f"tilegrid_{kind}_d{d}", "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[kind][d],
                "max_abs_err": max(errs[(kind, d)]),
                "ms": times[(kind, d)][0], "plain_ms": times[(kind, d)][1],
            })
    print(json.dumps({"kernels": table}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
