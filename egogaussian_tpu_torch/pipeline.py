"""The six-stage pipeline, stages 1.0 to 6.

Port of `egogaussian_tpu/pipeline.py` (the twin of reference
`train.py:67-187`):

  1.0 train_static        -> static/ply/static_phase{p}{,_obj,_bg}.ply + obj_masks/
  1.1 complete the dataset's object masks with the predicted ones
  1.2 train_background    -> background/static_bg.ply
  2   coarse pose         -> coarse/obj_pose_sequence.npz + ply/gaussians_final.ply
  3   fine-tune object    -> fine_obj/{from-static,from-coarse}/...
  4   interpolate poses   -> interpolate_pose_{static,coarse}/obj_pose_sequence.npz
  5   fine-tune all       -> fine_all/gaussians_all.ply
  6   eval                -> evaluation/results.txt

The stages write the same files as the JAX package and hand each model and
pose sequence on as its file holds it (a PLY keeps no densification
statistics and packs the alive Gaussians), so a run resumed from a
stage's files continues exactly as the unbroken run did. With
`resume=True` each stage whose files exist loads them instead of
training; with `checkpoint_every` > 0 each trainer also saves its state
mid-stage and resumes from it (train/ckpt_hook.py), with or without
`resume`. A finished stage's checkpoint file stays. Metrics go to
<save_dir>/logs/metrics.jsonl; each stage closes with a record
stage="pipeline", event="stage_time": its wall-clock seconds, iterations
and alive count, and whether it was resumed.

On a mesh (parallel/mesh.py) stages 1.0 and 1.2 run frame-data-parallel
on every data rank of the scene row; the pose stages 2-6 chain each
frame's pose off the previous one and run on the row's first rank alone,
which writes every file and the metrics log, while the other ranks wait
at a barrier and return None.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from egogaussian_tpu_torch.config import Config
from egogaussian_tpu_torch.data.readers import (
    SceneData,
    phase_membership_mask,
    split_viewpoints_by_phase,
)
from egogaussian_tpu_torch.eval.render_results import calculate_metric, render_results
from egogaussian_tpu_torch.models.gaussians import GaussianModel, load_ply
from egogaussian_tpu_torch.models.pose import (
    PoseSequence,
    interpolate_pose_sequence,
    load_pose_sequence,
    save_pose_sequence,
)
from egogaussian_tpu_torch.train.coarse_pose import estimate_coarse_obj_pose
from egogaussian_tpu_torch.train.fine_all import fine_tune_all
from egogaussian_tpu_torch.train.fine_obj import fine_tune_obj
from egogaussian_tpu_torch.train.static import train_background, train_static
from egogaussian_tpu_torch.utils.console import CONSOLE
from egogaussian_tpu_torch.utils.logging import MetricsLogger, active_logger, log_metrics

# run_pipeline's stop_after: None runs all six stages
STOP_AFTER = (None, "background", "coarse")


@dataclasses.dataclass
class PipelineResult:
    final_model: GaussianModel
    pose_seq: PoseSequence
    metrics: Dict[str, Dict[str, float]]


def apply_predicted_masks(cameras, pred_masks: Dict[str, np.ndarray]):
    """Stage 1.1: complete the object masks with the static stage's
    predictions (reference train.py:80-90 copies the predicted PNGs into
    the dataset). Only frames whose mask file is absent (obj_mask None) are
    completed: a shipped all-zero mask (the object absent or occluded) is
    ground truth and survives."""
    out = []
    for cam in cameras:
        if cam.obj_mask is None and cam.image_name in pred_masks:
            mask = torch.as_tensor(pred_masks[cam.image_name][None], device=cam.device)
            cam = dataclasses.replace(cam, obj_mask=mask)
        out.append(cam)
    return out


def run_pipeline(
    scene: SceneData,
    cfg: Config,
    save_dir: str,
    training_frames: Optional[Sequence[str]] = None,
    dynamic_eval_frames: Optional[Sequence[str]] = None,
    static_eval_frames: Optional[Sequence[str]] = None,
    static_phases: Optional[List] = None,
    dynamic_phases: Optional[List] = None,
    seed: int = 0,
    backend: str = "auto",
    resume: bool = False,
    lpips_fn=None,
    fine_variant: str = "from-coarse",
    checkpoint_every: int = 0,
    mesh=None,
    device: Optional[torch.device] = None,
    stop_after: Optional[str] = None,
) -> Optional[PipelineResult]:
    """All six stages on `scene`, whose cameras live on `device`: where
    every stage trains and evaluates; None means the card (`cuda`).
    `checkpoint_every` goes to every trainer (stage 2 saves per solved
    frame whatever its value). `stop_after="background"` ends the run after
    stage 1.2 and `"coarse"` after stage 2, returning None (the
    multi-video CLI's --stage1_only and --through_coarse). `mesh`: stages
    1.0 and 1.2 frame-data-parallel over its data axis, the rest on rank
    (s, 0), which alone returns the result; `device` then defaults to
    mesh.device."""
    if device is None:
        device = mesh.device if mesh is not None else torch.device("cuda")
    if stop_after not in STOP_AFTER:
        raise ValueError(f"stop_after={stop_after!r}: expected one of {STOP_AFTER}")
    cameras = scene.cameras
    static_groups = split_viewpoints_by_phase(cameras, static_phases, training_frames)
    dynamic_groups = split_viewpoints_by_phase(cameras, dynamic_phases, training_frames)
    os.makedirs(save_dir, exist_ok=True)
    logger = MetricsLogger(
        log_dir=os.path.join(save_dir, "logs") if mesh is None or mesh.writes else None,
        use_wandb=cfg.log.use_wandb,
        project=cfg.log.wandb_project,
        run_name=os.path.basename(os.path.normpath(save_dir)),
    )
    with active_logger(logger):
        return _run_pipeline_stages(
            scene, cfg, save_dir, cameras, static_groups, dynamic_groups, training_frames,
            dynamic_eval_frames, static_eval_frames, dynamic_phases, seed, backend, resume,
            lpips_fn, fine_variant, checkpoint_every, device, stop_after, mesh)


def _log_stage_time(name: str, t0: float, iterations: int, resumed: bool, alive=None):
    """The stage_time record of a stage begun at perf_counter() t0. The
    stages end in a host copy (a PLY or npz write), so the host clock spans
    the device work."""
    extra = {} if alive is None else {"alive": int(alive)}
    log_metrics("pipeline", 0, event="stage_time", name=name,
                seconds=time.perf_counter() - t0, iterations=iterations, resumed=resumed,
                **extra)


def _run_pipeline_stages(scene, cfg, save_dir, cameras, static_groups, dynamic_groups,
                         training_frames, dynamic_eval_frames, static_eval_frames,
                         dynamic_phases, seed, backend, resume, lpips_fn, fine_variant,
                         checkpoint_every, device, stop_after, mesh) -> Optional[PipelineResult]:
    extent = scene.cameras_extent
    kw = dict(seed=seed, backend=backend, device=device, checkpoint_every=checkpoint_every)
    sh = cfg.model.sh_degree

    # ---- Stage 1.0: every static phase, each from the point cloud; the
    # object model handed on is phase 0's, the predicted masks all phases'
    t0 = time.perf_counter()
    static_dir = os.path.join(save_dir, "static")
    obj_ply = os.path.join(static_dir, "ply", "static_phase0_obj.ply")
    last_ply = os.path.join(static_dir, "ply", f"static_phase{len(static_groups) - 1}.ply")
    resumed = resume and os.path.exists(obj_ply) and os.path.exists(last_ply)
    if resumed:
        CONSOLE.log("[pipeline] resume: static stage artifacts found")
        pred_masks = _load_pred_masks(os.path.join(static_dir, "obj_masks"))
    else:
        static_results = train_static(
            cameras, scene.points, scene.colors, cfg, static_groups, extent,
            save_dir=static_dir, mesh=mesh, **kw)
        pred_masks = {}
        for r in static_results:
            pred_masks.update(r.pred_masks)
        log_metrics("static", 0, event="stage_end",
                    dropped_pairs=max(r.dropped_pairs for r in static_results),
                    obj_alive=[int(r.obj_model.num_alive) for r in static_results],
                    bg_alive=[int(r.bg_model.num_alive) for r in static_results])
    # handed on as its file holds it, trained or resumed alike
    obj_model = load_ply(obj_ply, device, is_object=True, spatial_lr_scale=extent,
                         sh_degree=sh)
    sp = cfg.static
    iters = len(static_groups) * (sp.std_train_iter + sp.entropy_reg_iter + sp.label_train_iter)
    _log_stage_time("static", t0, 0 if resumed else iters, resumed, obj_model.num_alive)

    # ---- Stage 1.1: complete the object masks. Every static training
    # frame must now carry a shipped or a predicted mask (reference
    # train.py:90 asserts it): an all-zero mask on a static frame would
    # make stage 2's next-static anchor train against gt * 0.
    cameras = apply_predicted_masks(cameras, pred_masks)
    missing = [
        cameras[i].image_name
        for g in static_groups
        for i in g
        if cameras[i].image_name not in pred_masks
        and (cameras[i].obj_mask is None or float(cameras[i].obj_mask.sum()) == 0)
    ]
    if missing:
        raise AssertionError(f"stage 1.1: {len(missing)} static frames have no object mask "
                             f"(shipped or predicted): {missing[:5]}")

    # ---- Stage 1.2: background
    t0 = time.perf_counter()
    bg_dir = os.path.join(save_dir, "background")
    bg_ply = os.path.join(bg_dir, "static_bg.ply")
    all_train_idx = sorted({i for g in static_groups + dynamic_groups for i in g})
    resumed = resume and os.path.exists(bg_ply)
    if resumed:
        CONSOLE.log("[pipeline] resume: background artifacts found")
    else:
        train_background(cameras, scene.points, scene.colors, cfg, all_train_idx, extent,
                         save_dir=bg_dir, mesh=mesh, **kw)
    bg_model = load_ply(bg_ply, device, force_bg=True, spatial_lr_scale=extent, sh_degree=sh)
    iters = cfg.static_bg.std_train_iter + cfg.static_bg.entropy_reg_iter
    _log_stage_time("background", t0, 0 if resumed else iters, resumed, bg_model.num_alive)
    if stop_after == "background":
        return None
    if mesh is not None and not mesh.writes:
        mesh.barrier()  # stages 2-6 run on rank (s, 0)
        return None

    # ---- Stage 2: coarse object pose
    t0 = time.perf_counter()
    coarse_dir = os.path.join(save_dir, "coarse")
    coarse_pose_path = os.path.join(coarse_dir, "obj_pose_sequence.npz")
    coarse_ply = os.path.join(coarse_dir, "ply", "gaussians_final.ply")
    resumed = resume and os.path.exists(coarse_pose_path) and os.path.exists(coarse_ply)
    if resumed:
        CONSOLE.log("[pipeline] resume: coarse artifacts found")
    else:
        estimate_coarse_obj_pose(cameras, obj_model, cfg, static_groups, dynamic_groups,
                                 extent, save_dir=coarse_dir, **kw)
    pose_seq, _ = load_pose_sequence(coarse_pose_path, device)
    coarse_model = load_ply(coarse_ply, device, is_object=True, spatial_lr_scale=extent,
                            sh_degree=sh)
    # every dynamic training frame and each phase's next-static anchor
    iters = sum(len(g) + 1 for g in dynamic_groups) * cfg.coarse.total_num_iter
    _log_stage_time("coarse", t0, 0 if resumed else iters, resumed, coarse_model.num_alive)
    if stop_after == "coarse":
        return _row_done(mesh, None)

    # ---- Stage 3: fine-tune the object, both variants like the reference
    fine_results = {}
    for variant, base_model in (("from-static", obj_model), ("from-coarse", coarse_model)):
        t0 = time.perf_counter()
        fdir = os.path.join(save_dir, "fine_obj", variant)
        fply = os.path.join(fdir, "gaussians_fine.ply")
        fpose = os.path.join(fdir, "obj_pose_sequence.npz")
        resumed = resume and os.path.exists(fply) and os.path.exists(fpose)
        if resumed:
            CONSOLE.log(f"[pipeline] resume: fine_obj {variant} found")
        else:
            fine_tune_obj(cameras, base_model, pose_seq, cfg, static_groups, dynamic_groups,
                          extent, save_dir=fdir, **kw)
        seq_v, _ = load_pose_sequence(fpose, device)
        model_v = load_ply(fply, device, is_object=True, spatial_lr_scale=extent,
                           sh_degree=sh)
        fine_results[variant] = (seq_v, model_v)
        _log_stage_time(f"fine_obj/{variant}", t0, 0 if resumed else cfg.fine.total_num_iter,
                        resumed, model_v.num_alive)

    # ---- Stage 4: fill the unsolved frames of every dynamic phase range
    # (held-out frames and phase ends included, reference
    # interpolate_pose.py:92-99) and keep the solved next-static anchors
    t0 = time.perf_counter()
    interp: Dict[str, PoseSequence] = {}
    for variant, (seq_v, _) in fine_results.items():
        dyn_mask = phase_membership_mask(cameras, dynamic_phases)
        dyn_mask |= seq_v.solved.cpu().numpy()
        interp[variant] = interpolate_pose_sequence(seq_v, dyn_mask)
        save_pose_sequence(
            os.path.join(save_dir, f"interpolate_pose_{variant.replace('from-', '')}",
                         "obj_pose_sequence.npz"),
            interp[variant], [c.image_name for c in cameras])
    _log_stage_time("interpolate", t0, 0, False)

    # ---- Stage 5: fine-tune everything
    t0 = time.perf_counter()
    seq_final = interp[fine_variant]
    obj_final = fine_results[fine_variant][1]
    final_ply = os.path.join(save_dir, "fine_all", "gaussians_all.ply")
    resumed = resume and os.path.exists(final_ply)
    if resumed:
        CONSOLE.log("[pipeline] resume: fine_all artifacts found")
    else:
        fine_tune_all(cameras, obj_final, bg_model, seq_final, cfg, static_groups,
                      dynamic_groups, save_dir=os.path.join(save_dir, "fine_all"), **kw)
    final_model = load_ply(final_ply, device, spatial_lr_scale=extent, sh_degree=sh)
    _log_stage_time("fine_all", t0, 0 if resumed else cfg.fine_all.total_num_iter, resumed,
                    final_model.num_alive)

    # ---- Stage 6: evaluation
    t0 = time.perf_counter()
    eval_dir = os.path.join(save_dir, "evaluation")
    buckets = render_results(
        cameras, final_model, seq_final,
        training_frames=training_frames,
        dynamic_eval_frames=dynamic_eval_frames,
        static_eval_frames=static_eval_frames,
        save_dir=eval_dir, backend=backend,
    )
    metrics = calculate_metric(buckets, save_dir=eval_dir, lpips_fn=lpips_fn, device=device)
    _log_stage_time("eval", t0, 0, False)
    return _row_done(mesh, PipelineResult(final_model=final_model, pose_seq=seq_final,
                                          metrics=metrics))


def _row_done(mesh, result):
    """Release the scene row's ranks waiting after stage 1.2."""
    if mesh is not None:
        mesh.barrier()
    return result


def _load_pred_masks(mask_dir: str) -> Dict[str, np.ndarray]:
    """Stage 1.0's predicted masks back from its PNGs (resume)."""
    masks = {}
    if not os.path.isdir(mask_dir):
        return masks
    from PIL import Image

    for fname in os.listdir(mask_dir):
        if fname.endswith(".png"):
            with Image.open(os.path.join(mask_dir, fname)) as im:
                masks[fname[:-4]] = (np.asarray(im, np.float32) / 255.0 > 0.5).astype(np.float32)
    return masks
