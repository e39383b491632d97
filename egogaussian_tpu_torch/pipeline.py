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

`run_pipeline_scenes` runs V videos through the stages in lockstep: each
training stage is its lockstep driver over the videos
(parallel/scene_trainer.py, one batched step per iteration for all of
them), and every video writes the tree and metrics log its own
run_pipeline writes; `run_pipeline` is its one-video case.

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
from egogaussian_tpu_torch.utils.console import CONSOLE
from egogaussian_tpu_torch.utils.logging import MetricsLogger, log_metrics, use_logger

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


@dataclasses.dataclass(eq=False)
class VideoRun:
    """One video of run_pipeline_scenes: run_pipeline's per-video
    arguments."""

    scene: SceneData
    save_dir: str
    training_frames: Optional[Sequence[str]] = None
    dynamic_eval_frames: Optional[Sequence[str]] = None
    static_eval_frames: Optional[Sequence[str]] = None
    static_phases: Optional[List] = None
    dynamic_phases: Optional[List] = None
    seed: int = 0
    lpips_fn: object = None


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
    mesh.device. The one-video case of run_pipeline_scenes."""
    video = VideoRun(scene, save_dir, training_frames, dynamic_eval_frames, static_eval_frames,
                     static_phases, dynamic_phases, seed, lpips_fn)
    return run_pipeline_scenes([video], cfg, backend=backend, resume=resume,
                               fine_variant=fine_variant, checkpoint_every=checkpoint_every,
                               mesh=mesh, device=device, stop_after=stop_after)[0]


def run_pipeline_scenes(
    videos: Sequence[VideoRun],
    cfg: Config,
    backend: str = "auto",
    resume: bool = False,
    fine_variant: str = "from-coarse",
    checkpoint_every: int = 0,
    mesh=None,
    device: Optional[torch.device] = None,
    stop_after: Optional[str] = None,
) -> List[Optional[PipelineResult]]:
    """The six stages for V videos in lockstep: each training stage runs its
    lockstep driver (parallel/scene_trainer.py) over the videos that have
    not finished it, one batched step per iteration for all of them; stage
    3 runs each variant as one lockstep pass over the videos; stages 1.1,
    4 and 6 run per video. Every video writes the tree and metrics log its
    run_pipeline run writes, and the stages hand on through the files as
    there. Returns one result per video (None as run_pipeline returns
    it)."""
    if device is None:
        device = mesh.device if mesh is not None else torch.device("cuda")
    if stop_after not in STOP_AFTER:
        raise ValueError(f"stop_after={stop_after!r}: expected one of {STOP_AFTER}")
    runs = []
    for v in videos:
        os.makedirs(v.save_dir, exist_ok=True)
        logger = MetricsLogger(
            log_dir=os.path.join(v.save_dir, "logs") if mesh is None or mesh.writes else None,
            use_wandb=cfg.log.use_wandb,
            project=cfg.log.wandb_project,
            run_name=os.path.basename(os.path.normpath(v.save_dir)),
        )
        cams = v.scene.cameras
        runs.append(_Run(v, logger, cams,
                         split_viewpoints_by_phase(cams, v.static_phases, v.training_frames),
                         split_viewpoints_by_phase(cams, v.dynamic_phases, v.training_frames)))
    try:
        return _run_pipeline_stages(runs, cfg, backend, resume, fine_variant, checkpoint_every,
                                    device, stop_after, mesh)
    finally:
        for r in runs:
            r.logger.close()


@dataclasses.dataclass(eq=False)
class _Run:
    """One video's state between the stages of run_pipeline_scenes (compared
    by identity: it holds tensors)."""

    video: VideoRun
    logger: MetricsLogger
    cameras: list
    static_groups: list
    dynamic_groups: list
    obj_model: Optional[GaussianModel] = None
    bg_model: Optional[GaussianModel] = None
    pose_seq: Optional[PoseSequence] = None
    coarse_model: Optional[GaussianModel] = None

    def path(self, *parts) -> str:
        return os.path.join(self.video.save_dir, *parts)

    @property
    def extent(self) -> float:
        return self.video.scene.cameras_extent


def _log_stage_time(name: str, t0: float, iterations: int, resumed: bool, alive=None):
    """The stage_time record of a stage begun at perf_counter() t0. The
    stages end in a host copy (a PLY or npz write), so the host clock spans
    the device work."""
    extra = {} if alive is None else {"alive": int(alive)}
    log_metrics("pipeline", 0, event="stage_time", name=name,
                seconds=time.perf_counter() - t0, iterations=iterations, resumed=resumed,
                **extra)


def _run_pipeline_stages(runs: List[_Run], cfg, backend, resume, fine_variant, checkpoint_every,
                         device, stop_after, mesh) -> List[Optional[PipelineResult]]:
    from egogaussian_tpu_torch.parallel.scene_trainer import (
        CoarseSceneInput,
        FineAllSceneInput,
        FineSceneInput,
        SceneInput,
        train_background_scenes,
        train_coarse_scenes,
        train_fine_all_scenes,
        train_fine_scenes,
        train_static_scenes,
    )

    kw = dict(backend=backend, device=device, checkpoint_every=checkpoint_every)
    sh = cfg.model.sh_degree
    none = [None] * len(runs)

    # ---- Stage 1.0: every static phase, each from the point cloud; the
    # object model handed on is phase 0's, the predicted masks all phases'
    t0 = time.perf_counter()
    todo, pred = [], {}
    for r in runs:
        obj_ply = r.path("static", "ply", "static_phase0_obj.ply")
        last_ply = r.path("static", "ply", f"static_phase{len(r.static_groups) - 1}.ply")
        if resume and os.path.exists(obj_ply) and os.path.exists(last_ply):
            CONSOLE.log("[pipeline] resume: static stage artifacts found")
            pred[id(r)] = _load_pred_masks(r.path("static", "obj_masks"))
        else:
            todo.append(r)
    if todo:
        results = train_static_scenes(
            [SceneInput(r.cameras, r.video.scene.points, r.video.scene.colors, r.static_groups,
                        r.extent, save_dir=r.path("static"), seed=r.video.seed,
                        logger=r.logger) for r in todo], cfg, mesh=mesh, **kw)
        for r, res in zip(todo, results):
            pred[id(r)] = {}
            for phase in res:
                pred[id(r)].update(phase.pred_masks)
            with use_logger(r.logger):
                log_metrics("static", 0, event="stage_end",
                            dropped_pairs=max(x.dropped_pairs for x in res),
                            obj_alive=[int(x.obj_model.num_alive) for x in res],
                            bg_alive=[int(x.bg_model.num_alive) for x in res])
    sp = cfg.static
    for r in runs:
        # handed on as its file holds it, trained or resumed alike
        r.obj_model = load_ply(r.path("static", "ply", "static_phase0_obj.ply"), device,
                               is_object=True, spatial_lr_scale=r.extent, sh_degree=sh)
        iters = len(r.static_groups) * (sp.std_train_iter + sp.entropy_reg_iter
                                        + sp.label_train_iter)
        with use_logger(r.logger):
            _log_stage_time("static", t0, iters if r in todo else 0, r not in todo,
                            r.obj_model.num_alive)

        # ---- Stage 1.1: complete the object masks. Every static training
        # frame must now carry a shipped or a predicted mask (reference
        # train.py:90 asserts it): an all-zero mask on a static frame would
        # make stage 2's next-static anchor train against gt * 0.
        pred_masks = pred[id(r)]
        r.cameras = apply_predicted_masks(r.cameras, pred_masks)
        missing = [
            r.cameras[i].image_name
            for g in r.static_groups
            for i in g
            if r.cameras[i].image_name not in pred_masks
            and (r.cameras[i].obj_mask is None or float(r.cameras[i].obj_mask.sum()) == 0)
        ]
        if missing:
            raise AssertionError(f"stage 1.1: {len(missing)} static frames have no object "
                                 f"mask (shipped or predicted): {missing[:5]}")

    # ---- Stage 1.2: background
    t0 = time.perf_counter()
    todo = []
    for r in runs:
        if resume and os.path.exists(r.path("background", "static_bg.ply")):
            CONSOLE.log("[pipeline] resume: background artifacts found")
        else:
            todo.append(r)
    if todo:
        train_background_scenes(
            [SceneInput(r.cameras, r.video.scene.points, r.video.scene.colors, [], r.extent,
                        save_dir=r.path("background"), seed=r.video.seed, logger=r.logger,
                        train_frame_idxs=sorted({i for g in r.static_groups + r.dynamic_groups
                                                 for i in g}))
             for r in todo], cfg, mesh=mesh, **kw)
    iters = cfg.static_bg.std_train_iter + cfg.static_bg.entropy_reg_iter
    for r in runs:
        r.bg_model = load_ply(r.path("background", "static_bg.ply"), device, force_bg=True,
                              spatial_lr_scale=r.extent, sh_degree=sh)
        with use_logger(r.logger):
            _log_stage_time("background", t0, iters if r in todo else 0, r not in todo,
                            r.bg_model.num_alive)
    if stop_after == "background":
        return none
    if mesh is not None and not mesh.writes:
        mesh.barrier()  # stages 2-6 run on rank (s, 0)
        return none

    # ---- Stage 2: coarse object pose
    t0 = time.perf_counter()
    todo = []
    for r in runs:
        if (resume and os.path.exists(r.path("coarse", "obj_pose_sequence.npz"))
                and os.path.exists(r.path("coarse", "ply", "gaussians_final.ply"))):
            CONSOLE.log("[pipeline] resume: coarse artifacts found")
        else:
            todo.append(r)
    if todo:
        train_coarse_scenes(
            [CoarseSceneInput(r.cameras, r.obj_model, r.static_groups, r.dynamic_groups,
                              r.extent, save_dir=r.path("coarse"), seed=r.video.seed,
                              logger=r.logger) for r in todo], cfg, **kw)
    for r in runs:
        r.pose_seq, _ = load_pose_sequence(r.path("coarse", "obj_pose_sequence.npz"), device)
        r.coarse_model = load_ply(r.path("coarse", "ply", "gaussians_final.ply"), device,
                                  is_object=True, spatial_lr_scale=r.extent, sh_degree=sh)
        # every dynamic training frame and each phase's next-static anchor
        iters = sum(len(g) + 1 for g in r.dynamic_groups) * cfg.coarse.total_num_iter
        with use_logger(r.logger):
            _log_stage_time("coarse", t0, iters if r in todo else 0, r not in todo,
                            r.coarse_model.num_alive)
    if stop_after == "coarse":
        return _row_done(mesh, none)

    # ---- Stage 3: fine-tune the object, both variants like the reference,
    # each variant one lockstep pass over the videos
    fine_results = [{} for _ in runs]
    for variant in ("from-static", "from-coarse"):
        t0 = time.perf_counter()
        todo = []
        for r in runs:
            fdir = r.path("fine_obj", variant)
            if (resume and os.path.exists(os.path.join(fdir, "gaussians_fine.ply"))
                    and os.path.exists(os.path.join(fdir, "obj_pose_sequence.npz"))):
                CONSOLE.log(f"[pipeline] resume: fine_obj {variant} found")
            else:
                todo.append(r)
        if todo:
            train_fine_scenes(
                [FineSceneInput(r.cameras,
                                r.obj_model if variant == "from-static" else r.coarse_model,
                                r.pose_seq, r.static_groups, r.dynamic_groups, r.extent,
                                save_dir=r.path("fine_obj", variant), seed=r.video.seed,
                                logger=r.logger) for r in todo], cfg, **kw)
        for r, res in zip(runs, fine_results):
            fdir = r.path("fine_obj", variant)
            seq_v, _ = load_pose_sequence(os.path.join(fdir, "obj_pose_sequence.npz"), device)
            model_v = load_ply(os.path.join(fdir, "gaussians_fine.ply"), device, is_object=True,
                               spatial_lr_scale=r.extent, sh_degree=sh)
            res[variant] = (seq_v, model_v)
            with use_logger(r.logger):
                _log_stage_time(f"fine_obj/{variant}", t0,
                                cfg.fine.total_num_iter if r in todo else 0, r not in todo,
                                model_v.num_alive)

    # ---- Stage 4: fill the unsolved frames of every dynamic phase range
    # (held-out frames and phase ends included, reference
    # interpolate_pose.py:92-99) and keep the solved next-static anchors
    interps = []
    for r, res in zip(runs, fine_results):
        t0 = time.perf_counter()
        interp: Dict[str, PoseSequence] = {}
        for variant, (seq_v, _) in res.items():
            dyn_mask = phase_membership_mask(r.cameras, r.video.dynamic_phases)
            dyn_mask |= seq_v.solved.cpu().numpy()
            interp[variant] = interpolate_pose_sequence(seq_v, dyn_mask)
            save_pose_sequence(
                r.path(f"interpolate_pose_{variant.replace('from-', '')}",
                       "obj_pose_sequence.npz"),
                interp[variant], [c.image_name for c in r.cameras])
        with use_logger(r.logger):
            _log_stage_time("interpolate", t0, 0, False)
        interps.append(interp)

    # ---- Stage 5: fine-tune everything
    t0 = time.perf_counter()
    todo = []
    for r in runs:
        if resume and os.path.exists(r.path("fine_all", "gaussians_all.ply")):
            CONSOLE.log("[pipeline] resume: fine_all artifacts found")
        else:
            todo.append(r)
    if todo:
        train_fine_all_scenes(
            [FineAllSceneInput(r.cameras, fine_results[runs.index(r)][fine_variant][1],
                               r.bg_model, interps[runs.index(r)][fine_variant],
                               r.static_groups, r.dynamic_groups,
                               save_dir=r.path("fine_all"), seed=r.video.seed,
                               logger=r.logger) for r in todo], cfg, **kw)
    out = []
    for r, interp in zip(runs, interps):
        final_model = load_ply(r.path("fine_all", "gaussians_all.ply"), device,
                               spatial_lr_scale=r.extent, sh_degree=sh)
        with use_logger(r.logger):
            _log_stage_time("fine_all", t0, cfg.fine_all.total_num_iter if r in todo else 0,
                            r not in todo, final_model.num_alive)

            # ---- Stage 6: evaluation
            t6 = time.perf_counter()
            eval_dir = r.path("evaluation")
            buckets = render_results(
                r.cameras, final_model, interp[fine_variant],
                training_frames=r.video.training_frames,
                dynamic_eval_frames=r.video.dynamic_eval_frames,
                static_eval_frames=r.video.static_eval_frames,
                save_dir=eval_dir, backend=backend,
            )
            metrics = calculate_metric(buckets, save_dir=eval_dir, lpips_fn=r.video.lpips_fn,
                                       device=device)
            _log_stage_time("eval", t6, 0, False)
        out.append(PipelineResult(final_model=final_model, pose_seq=interp[fine_variant],
                                  metrics=metrics))
    return _row_done(mesh, out)


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
