"""Entry: stage 1.0 (std mode) through `train/static.py:train_static`, the
first static phase of one video, frame batch 1, the trainer's own loop.

Set-up makes the video and the point cloud from the seed, and the trainer
builds its model from them; its first steps run through the same loop the
window times. Two wrappers copy the program's state out, each taken off
after use: around the step (steps 1-3 at the step's return) and around
the densification (its input and output at the first densify interval,
which warm-up passes). After the window they are checked against the
reference: the initialisation (against the reference's own from the same
points), each step's loss, the first gradient (Adam's first moment after
step 1), the parameters' change after step 3, the screen-space gradient
statistic, the frames drawn, and the first densification (the reference's
clone, split and prune of the program's state before it, against the
program's state after it, compared as sets of rows).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.core import compare, program
from benchmark.core.window import StopWindow
from benchmark.core.workcount import frame_work, mean_work
from benchmark.inputs import egovideo
from benchmark.reference import densify as D
from benchmark.reference import render as R
from benchmark.reference import train as ref

CHECKED_STEPS = 3
B1 = 0.9
# rows are matched by the fields that densification copies exactly, first
ROW_ORDER = ("features_dc", "opacity_logit", "quats", "log_scales", "xyz")


def program_config(c: dict):
    from egogaussian_tpu_torch.config import Config

    cfg = Config()
    opt_keys = ("position_lr_init", "position_lr_final", "position_lr_max_steps", "feature_lr",
                "opacity_lr", "scaling_lr", "rotation_lr", "percent_dense", "lambda_dssim",
                "densification_interval", "opacity_reset_interval", "densify_grad_threshold")
    cfg.opt = dataclasses.replace(cfg.opt, **{k: c[k] for k in opt_keys})
    cfg.static = dataclasses.replace(cfg.static, std_train_iter=c["std_train_iter"],
                                     densify_from_iter=c["densify_from_iter"],
                                     densify_until_iter=c["densify_until_iter"],
                                     frame_batch=c["frame_batch"])
    cfg.model = dataclasses.replace(cfg.model, sh_degree=c["sh_degree"])
    cfg.render = dataclasses.replace(cfg.render, tile_size=c["tile_size"])
    return cfg


def first_densify(c: dict) -> int:
    """The first iteration after which the trainer densifies."""
    k = c["densification_interval"]
    return (c["densify_from_iter"] // k + 1) * k


def prepare(ctx):
    """One scene for every seed (the traffic's `scene_seed`), its point cloud
    in an order drawn from the seed; the seed also seeds the trainer, which
    draws the frames and the densify noise. Every seed then trains the
    same set of points on the same frames in another order: a scene drawn
    afresh per seed moved the rate by ~9% between seeds against ~2% between
    two runs of one seed."""
    c, t = ctx.config, ctx.traffic
    if t["warmup_steps"] <= first_densify(c):
        raise ValueError(f"warm-up ({t['warmup_steps']} steps) has to pass the first "
                         f"densification (iteration {first_densify(c)})")
    video = egovideo.make_video(t["scene_seed"], 0, c["frames"], c["width"], c["height"],
                                t.get("dynamic") or [], c["gt_scene"], ctx.device)
    points, colors = egovideo.init_point_cloud(t["scene_seed"], c["gaussians"], c["object_share"],
                                               ctx.device)
    order = torch.randperm(c["gaussians"], generator=egovideo.generator(ctx.seed, 500, ctx.device),
                           device=ctx.device)
    return dict(video=video, points=points[order].contiguous(),
                colors=colors[order].contiguous(), prog_seed=ctx.seed % (2 ** 31))


def drive(ctx, state):
    import egogaussian_tpu_torch.parallel.scene_trainer as st
    from egogaussian_tpu_torch.train import static

    c = ctx.config
    n = c["gaussians"]
    video = state["video"]
    snaps = []
    orig = st.multi_scene_static_step

    def spy(model, opt, batches, fidxs, *a, **k):
        if not snaps:
            snaps.append(dict(params=program.rows(model.params, n, 0)))
        out = orig(model, opt, batches, fidxs, *a, **k)
        snap = dict(loss=float(out[2][0]), frame=int(fidxs.reshape(-1)[0]))
        if len(snaps) == 1:
            snap["mu"] = program.rows(out[1].mu, n, 0)
        if len(snaps) == CHECKED_STEPS:
            snap["params"] = program.rows(out[0].params, n, 0)
            snap["accum"] = out[0].aux.xyz_gradient_accum[0, :n].detach().cpu()
            st.multi_scene_static_step = orig
        snaps.append(snap)
        return out

    dens = {}
    orig_dens = st.densify_and_prune

    def dens_spy(model, opt, *a, **k):
        dens["before"] = state_of(model)
        res = orig_dens(model, opt, *a, **k)
        dens["after"] = state_of(res.model)
        st.densify_and_prune = orig_dens
        return res

    def on_step(it, mode, loss):
        ctx.window.step(1)

    st.multi_scene_static_step = spy
    st.densify_and_prune = dens_spy
    try:
        static.train_static(program.cameras(video), program.host(state["points"]),
                            program.host(state["colors"]), program_config(c),
                            [list(range(c["frames"]))], video.extent, save_dir=None,
                            seed=state["prog_seed"], backend="auto", first_phase_only=True,
                            device=ctx.device, on_step=on_step)
    except StopWindow:
        pass
    finally:
        st.multi_scene_static_step = orig
        st.densify_and_prune = orig_dens
    return program_readings(snaps, dens)


def state_of(model) -> dict:
    """Every slot of a one-scene GaussianModel: its fields, and alive and
    the densification statistic, on the host."""
    cap = model.params.xyz.shape[-2]
    out = program.rows(model.params, cap, 0 if model.params.xyz.dim() == 3 else None)
    aux = model.aux
    for k in ("alive", "xyz_gradient_accum", "denom"):
        v = getattr(aux, k)
        out[k] = (v[0] if v.dim() == 2 else v).detach().cpu().clone()
    return out


def program_readings(snaps, dens):
    p0, s1, s3 = snaps[0]["params"], snaps[1], snaps[CHECKED_STEPS]
    return dict(
        densify=dens,
        init={k: p0[k] for k in ref.FIELDS},
        losses=[s["loss"] for s in snaps[1:]],
        frames=[s["frame"] for s in snaps[1:]],
        grad1={k: s1["mu"][k] / (1 - B1) for k in ref.FIELDS},
        change={k: s3["params"][k] - p0[k] for k in ref.FIELDS},
        accum=s3["accum"])


def reference(ctx, state, tf32: bool = False, init=None, unchanged: bool = False):
    """The reference's readings: 3 steps from `init` (the program's
    initialisation, see check), or from its own when None. `unchanged`
    plants a fault: every step returns its state unchanged."""
    c = ctx.config
    video = state["video"]
    ref.set_precision(tf32)
    if init is None:
        init = {k: v.detach().cpu() for k, v in
                ref.init_from_points(state["points"], state["colors"], exact=True).items()}
    p = {k: v.to(ctx.device) for k, v in init.items()}
    rng = np.random.RandomState(state["prog_seed"])
    opt = {k: c[k] for k in ("position_lr_init", "position_lr_final", "position_lr_max_steps",
                             "feature_lr", "opacity_lr", "scaling_lr", "rotation_lr")}
    adam_state, losses, frames, grad1 = None, [], [], None
    ndc = torch.tensor([video.width * 0.5, video.height * 0.5], device=ctx.device)
    accum = torch.zeros(c["gaussians"], device=ctx.device)
    for it in range(1, CHECKED_STEPS + 1):
        f = int(rng.randint(c["frames"]))
        loss, grads, g2d, vis = ref.static_loss_grads(
            p, video.camera(f), video.gt[f], video.hand[f], c["lambda_dssim"], c["tile_size"])
        accum = accum + torch.where(vis, torch.linalg.vector_norm(g2d * ndc, dim=-1),
                                    torch.zeros_like(accum))
        if it == 1:
            grad1 = {k: g.detach().cpu() for k, g in grads.items()}
            seen = {k: g.detach().abs() for k, g in grads.items()}
        else:
            seen = {k: torch.maximum(seen[k], g.detach().abs()) for k, g in grads.items()}
        if unchanged:
            accum = torch.zeros_like(accum)
            grad1 = {k: torch.zeros_like(g) for k, g in grad1.items()}
        else:
            p, adam_state = ref.adam(p, grads, adam_state, ref.static_lrs(it, opt, video.extent))
        losses.append(float(loss))
        frames.append(f)
    ref.set_precision(False)
    return dict(init=init, losses=losses, frames=frames, grad1=grad1,
                change={k: p[k].detach().cpu() - init[k] for k in init}, accum=accum.cpu(),
                active=compare.active_elements({k: v.cpu() for k, v in seen.items()}))


def init_gap(prog_init, ref_init):
    """Worst leaf's largest difference over its largest value."""
    return max(float((prog_init[k] - ref_init[k]).abs().max())
               / max(float(ref_init[k].abs().max()), 1e-30) for k in ref_init)


def numbers(prog, refr):
    leaves = compare.counted_leaves(refr["grad1"])
    return dict(
        frames_differ=float(sum(a != b for a, b in zip(prog["frames"], refr["frames"]))),
        loss_gap=max(compare.rel_gap(a, b) for a, b in zip(prog["losses"], refr["losses"])),
        grad_gap=compare.worst_norm_gap(prog["grad1"], refr["grad1"], leaves),
        change_gap=compare.worst_norm_gap(compare.masked(prog["change"], refr["active"]),
                                          compare.masked(refr["change"], refr["active"]),
                                          leaves),
        stat_gap=compare.rel_gap(compare.norm(prog["accum"]), compare.norm(refr["accum"])))


def exact_init(ctx, state, k: int = 3):
    p = ref.init_from_points(state["points"], state["colors"], exact=True, k=k)
    return {f: v.detach().cpu() for f, v in p.items()}


def densify_reference(ctx, state, before):
    """The reference's densification of the program's state `before`, with
    the configuration's thresholds and the draws of the trainer's seed.
    Returns (rows alive after, counts)."""
    c = ctx.config
    dev = ctx.device
    p = {k: before[k].to(dev) for k in D.FIELDS}
    alive = before["alive"].to(dev)
    rows, counts = D.densify(p, alive, before["xyz_gradient_accum"].to(dev),
                             before["denom"].to(dev), c["densify_grad_threshold"],
                             state["video"].extent, c["percent_dense"],
                             D.split_seed(state["prog_seed"]))
    return {k: v.cpu() for k, v in rows.items()}, counts


def densify_numbers(after, ref_rows) -> dict:
    """The program's rows alive after its first densification against the
    reference's: the difference in their number, and the rows as sets."""
    alive = after["alive"]
    prog_rows = {k: after[k][alive] for k in D.FIELDS}
    return dict(densify_count_gap=float(abs(int(alive.sum()) - ref_rows["xyz"].shape[0])),
                densify_row_gap=compare.row_gap(prog_rows, ref_rows, ROW_ORDER))


def check(ctx, state, readings):
    """The initialisation is compared with the reference's own from the same
    points. Steps 1-3 start from the program's initialisation: its kNN
    scales come from a |p|^2 - 2 p.q + |q|^2 expansion whose rounding at
    this scene's scale moves them by up to ~1% from the exact distances, and
    a reference from its own init would carry that into every step number.
    The densification starts from the program's state before it, which
    only the program's 100 steps reach; the steps and the statistic that
    lead there are checked above."""
    out = numbers(readings, reference(ctx, state, init=readings["init"]))
    out["init_gap"] = init_gap(readings["init"], exact_init(ctx, state))
    ref_rows, _ = densify_reference(ctx, state, readings["densify"]["before"])
    out.update(densify_numbers(readings["densify"]["after"], ref_rows))
    return out


def densify_counts(ctx, state, readings) -> dict:
    """What the reference's densification of the checked state does: rows
    cloned, split and pruned (for the record; not compared)."""
    return densify_reference(ctx, state, readings["densify"]["before"])[1]


def control(ctx, state):
    """The reference in TF32 in the program's place (steps 1-3)."""
    ctl = reference(ctx, state, tf32=True)
    return numbers(ctl, reference(ctx, state, init=ctl["init"]))


def fault_unchanged(ctx, state):
    """The reference with every step returning its state unchanged, in the
    program's place."""
    bad = reference(ctx, state, unchanged=True)
    return numbers(bad, reference(ctx, state, init=bad["init"]))


def fault_init_knn1(ctx, state):
    """The reference's initialisation from 1 nearest neighbour, not 3, in
    the program's place."""
    return dict(init_gap=init_gap(exact_init(ctx, state, k=1), exact_init(ctx, state)))


def _noop_densify(model, opt, *a, **k):
    from egogaussian_tpu_torch.models.densify import DensifyResult

    zero = torch.zeros((), dtype=torch.int64, device=model.params.xyz.device)
    return DensifyResult(model, opt, zero, zero, zero, zero)


def _other_split_draws(orig):
    def densify(model, opt, seed, *a, **k):
        return orig(model, opt, seed + 1, *a, **k)
    return densify


PLANTED = {"densify_noop": ("egogaussian_tpu_torch.parallel.scene_trainer",
                            "densify_and_prune", lambda orig: _noop_densify),
           "split_draws_altered": ("egogaussian_tpu_torch.parallel.scene_trainer",
                                   "densify_and_prune", _other_split_draws)}
FAULTS = {"unchanged": fault_unchanged, "init_knn1": fault_init_knn1}


def work(ctx, state):
    """Per iteration: the mean over the frames of one training step on the
    3DGS initialisation of the cell's point cloud."""
    c = ctx.config
    video = state["video"]
    ref.set_precision(False)
    with torch.no_grad():
        p = ref.init_from_points(state["points"], state["colors"], exact=False)
        cov = R.covariance(p["log_scales"], p["quats"])
        op = torch.sigmoid(p["opacity_logit"][:, 0])
        works = []
        for f in range(c["frames"]):
            cam = video.camera(f)
            proj = R.project(p["xyz"], cov, cam)
            bins = R.bin_tiles(proj, cam.width, cam.height, c["tile_size"])
            evals, pairs = R.covered_evaluations(proj, op, bins, cam.width, cam.height)
            works.append(frame_work(evals, pairs, cam.width * cam.height, c["gaussians"], True))
    return mean_work(works)
