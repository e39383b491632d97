"""Stage 3: joint fine-tuning of the object's shape and per-frame pose.

Port of `egogaussian_tpu/train/fine_obj.py` (the twin of reference
`trainers/fine_obj.py:27-237`), run twice: from the static-phase object
PLY and from the coarse-stage PLY.

  Every iteration samples a frame, dynamic frames weighted 5:1. A static
  frame trains the shape only; a dynamic frame loads its stored pose delta
  into the trainable pose, trains it, and writes the delta back. One pose
  Adam state serves every frame, so its moments carry from frame to frame.
  The pose learning rates are 0 until densify_until_iter and the full
  obj_*_lr after it (train_fine_obj_setup zeroes them; the reference's
  dividers are commented out), so the pose trains only in the last
  (total - densify_until) iterations.
  Gaussian learning rates are /5, opacity not divided, xyz on the expon
  schedule; object densify/prune (which_object=1) every
  densification_interval in (densify_from, densify_until), object opacity
  resets. Loss: 0.8 L1 + 0.2 (1 - SSIM) on gt * obj_mask + 0.2 L2(obj_mask,
  alpha), hand-mask gated on image and alpha, through the pose stages'
  shared step (train/coarse_pose.py:pose_step).

The accumulated-transform tables are rebuilt only after a write-back (the
values JAX recomputes every step), so the loop reads nothing back from the
device between densify intervals.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from egogaussian_tpu_torch.config import Config
from egogaussian_tpu_torch.data.readers import stack_cameras
from egogaussian_tpu_torch.models.densify import densify_and_prune, reset_opacity
from egogaussian_tpu_torch.models.gaussians import (
    PARAM_FIELDS,
    GaussianModel,
    ensure_capacity,
    save_ply,
)
from egogaussian_tpu_torch.models.optim import adam_init, expon_lr
from egogaussian_tpu_torch.models.pose import (
    PoseSequence,
    identity_pose,
    pose_from_rt,
    save_pose_sequence,
)
from egogaussian_tpu_torch.train.ckpt_hook import (
    StageCheckpointer,
    grow_to_capacity,
    restore_loop,
)
from egogaussian_tpu_torch.train.coarse_pose import _f32, pose_step
from egogaussian_tpu_torch.train.common import (
    auto_tile_config,
    crop_escape_count,
    maybe_grow_crop,
    maybe_regrow_tile_config,
    pick_backend,
    pose_crop_size,
)
from egogaussian_tpu_torch.train.static import _log_dropped_pairs
from egogaussian_tpu_torch.utils.console import CONSOLE
from egogaussian_tpu_torch.utils.logging import log_metrics


def _fine_lr_tree(model: GaussianModel, it: int, opt, divide_3dgs: float = 5.0
                  ) -> Dict[str, float]:
    """Gaussian learning rates of stage 3: /5 dividers, opacity not
    divided, xyz on the expon schedule (train_fine_obj_setup); with
    divide_3dgs=1 those of stage 5 (train_fine_all_setup). float32 values,
    as the JAX package computes them."""
    spatial = model.spatial_lr_scale
    lrs = dict(
        xyz=expon_lr(it, opt.position_lr_init * spatial / divide_3dgs,
                     opt.position_lr_final * spatial / divide_3dgs,
                     lr_delay_mult=opt.position_lr_delay_mult,
                     max_steps=opt.position_lr_max_steps),
        features_dc=_f32(opt.feature_lr / divide_3dgs),
        features_rest=_f32(opt.feature_lr / 20.0 / divide_3dgs),
        log_scales=_f32(opt.scaling_lr / divide_3dgs),
        quats=_f32(opt.rotation_lr / divide_3dgs),
        opacity_logit=_f32(opt.opacity_lr),
        label=0.0,
    )
    return {k: lrs[k] for k in PARAM_FIELDS}


def _fine_obj_step(model, opt_state, pose_seq: PoseSequence, accum, pose_opt, batch,
                   cam_idx: int, it: int, drop_max, train_pose: bool, opt_cfg, fine_cfg,
                   backend: str, tile_config, crop_size, crop_max):
    """One stage-3 iteration. A trained frame renders at pose @
    accum[cam_idx - 1] (the identity prefix at frame 0) with the frame's
    stored delta as the pose; another frame at accum[cam_idx]. The delta is
    written back once the pose learning rate is live. `accum`: the
    sequence's (accum_T, accum_R). Returns (model, opt_state, pose_seq,
    pose_opt, loss, drop_max, crop_max)."""
    fp = fine_cfg
    accum_T, accum_R = accum
    dev = model.device
    if train_pose:
        pose = pose_from_rt(pose_seq.rotations[cam_idx], pose_seq.translations[cam_idx])
        if cam_idx > 0:
            fixed_T, fixed_R = accum_T[cam_idx - 1], accum_R[cam_idx - 1]
        else:
            fixed_T = torch.eye(4, dtype=accum_T.dtype, device=dev)
            fixed_R = torch.eye(3, dtype=accum_R.dtype, device=dev)
    else:
        pose = identity_pose(dev)
        fixed_T, fixed_R = accum_T[cam_idx], accum_R[cam_idx]
    pose_live = it >= fp.densify_until_iter
    plr_t = _f32(opt_cfg.obj_translation_lr) if pose_live else 0.0
    plr_r = _f32(opt_cfg.obj_rotation_lr) if pose_live else 0.0
    model, opt_state, pose, pose_opt, loss, _, drop_max, crop_max = pose_step(
        model, opt_state, pose, pose_opt, batch, cam_idx, fixed_T, fixed_R,
        _fine_lr_tree(model, it, opt_cfg), plr_t, plr_r, True, drop_max,
        train_pose=train_pose,
        lambda_image=fp.lambda_Ll1_image,
        lambda_dssim=fp.lambda_dssim,
        lambda_l1_alpha=fp.lambda_Ll1_alpha,
        lambda_l2_alpha=fp.lambda_Ll2_alpha,
        backend=backend,
        tile_config=tile_config,
        crop_size=crop_size,
        crop_max=crop_max,
    )
    if train_pose and pose_live and opt_cfg.obj_translation_lr > 0:
        pose_seq = pose_seq.update_frame(cam_idx, pose)
    return model, opt_state, pose_seq, pose_opt, loss, drop_max, crop_max


def fine_tune_obj(
    cameras: Sequence,
    obj_model: GaussianModel,
    pose_seq: PoseSequence,
    cfg: Config,
    static_phase_frames: List[List[int]],
    dynamic_phase_frames: List[List[int]],
    cameras_extent: float,
    save_dir: Optional[str] = None,
    seed: int = 0,
    backend: str = "auto",
    checkpoint_every: int = 0,
    device: Optional[torch.device] = None,
    on_step: Optional[Callable[[int, int, torch.Tensor], None]] = None,
    densify_noise: Optional[Callable[[int], torch.Tensor]] = None,
) -> Tuple[PoseSequence, GaussianModel]:
    """Stage 3 for one object PLY variant. Returns (pose sequence, model);
    writes obj_pose_sequence.npz and gaussians_fine.ply under save_dir.

    `device`: None means the card (`cuda`). `on_step(frame, it, loss)`:
    optional observer after every step. `densify_noise(capacity)`: optional
    [2, C, 3] split noise for each densify call, in order (tests inject the
    JAX draw); by default the port's split_noise with seeds from a
    generator seeded `seed`. Ends with a metrics record event="stage_end"
    (steps, crop_size, crop_escapes, dropped_pairs). `checkpoint_every` > 0
    (with save_dir): the state (model, Adam state, pose Adam state, pose
    sequence, split generator) goes to save_dir/ckpt_fine_obj.npz every
    that many iterations, and a run whose file exists resumes from it."""
    if device is None:
        device = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    rng = np.random.RandomState(seed)
    fp = cfg.fine
    model = obj_model
    batch = stack_cameras(list(cameras), device)
    pose_seq = PoseSequence(translations=pose_seq.translations.to(device),
                            rotations=pose_seq.rotations.to(device),
                            solved=pose_seq.solved.to(device))

    solved = pose_seq.solved.cpu().numpy()
    static_list = [f for ph in static_phase_frames for f in ph]
    dynamic_list = [f for ph in dynamic_phase_frames for f in ph if solved[f]]
    dynamic_set = set(dynamic_list)
    frames = static_list + dynamic_list
    weights = np.array([1.0] * len(static_list) + [5.0] * len(dynamic_list))
    weights = weights / weights.sum()
    CONSOLE.log(f"[fine_obj] {len(static_list)} static + {len(dynamic_list)} dynamic "
                f"frames, {fp.total_num_iter} iters")

    opt_state = adam_init(model.params)
    tile_cfg = auto_tile_config(model, batch.camera(0), tile_size=cfg.render.tile_size)
    backend = pick_backend(tile_cfg, backend)
    crop_size = pose_crop_size(batch, cfg, "fine_obj")
    pose_opt = adam_init(identity_pose(device))  # shared by every frame
    gen = torch.Generator().manual_seed(seed)  # densify split seeds

    def zero_crop_stat():
        return (torch.zeros((3,), dtype=torch.int32, device=device) if crop_size is not None
                else torch.zeros((), dtype=torch.int32, device=device))

    drop_max = torch.zeros((), dtype=torch.int64, device=device)
    last_drop = 0
    crop_max = zero_crop_stat()
    last_crop = 0

    ckpt = StageCheckpointer(
        os.path.join(save_dir, "ckpt_fine_obj.npz") if save_dir and checkpoint_every else None,
        checkpoint_every)
    start_it = 0
    if ckpt.exists():
        model, opt_state = grow_to_capacity(model, opt_state, ckpt.peek_capacity())
        (model, opt_state, pose_opt, pose_seq), start_it = ckpt.try_restore(
            (model, opt_state, pose_opt, pose_seq), rng, gen, "fine_obj")
        loop = restore_loop(ckpt.extra, device)
        tile_cfg, drop_max, last_drop = loop["tile_cfg"], loop["drop_max"], loop["last_drop"]
        crop_size, crop_max, last_crop = loop["crop_size"], loop["crop_max"], loop["last_crop"]
        backend = pick_backend(tile_cfg, backend)

    accum = (pose_seq.accum_T(), pose_seq.accum_R())
    for it in range(start_it + 1, fp.total_num_iter + 1):
        if it == 1:
            cam_idx, train_p = static_phase_frames[0][0], False
        else:
            cam_idx = int(frames[rng.choice(len(frames), p=weights)])
            train_p = cam_idx in dynamic_set
        before = pose_seq
        (model, opt_state, pose_seq, pose_opt, loss, drop_max, crop_max) = _fine_obj_step(
            model, opt_state, pose_seq, accum, pose_opt, batch, cam_idx, it, drop_max,
            train_p, cfg.opt, fp, backend, tile_cfg, crop_size, crop_max)
        if pose_seq is not before:  # a written-back delta moves later frames
            accum = (pose_seq.accum_T(), pose_seq.accum_R())
        if on_step is not None:
            on_step(cam_idx, it, loss)

        if it % fp.densification_interval == 0:
            tile_cfg, last_drop, changed = maybe_regrow_tile_config(
                model, batch.camera(0), tile_cfg, drop_max, last_drop, "fine_obj")
            if changed:
                drop_max, last_drop = torch.zeros_like(drop_max), 0
            crop_size, last_crop, cchanged = maybe_grow_crop(
                crop_size, crop_max, last_crop, batch, "fine_obj")
            if cchanged:
                crop_max = zero_crop_stat()
            log_metrics("fine_obj", it, loss=loss, alive=model.num_alive,
                        capacity=model.capacity, dropped_pairs=drop_max,
                        crop_escapes=crop_escape_count(crop_max))
        if fp.densify_from_iter < it < fp.densify_until_iter:
            if it % fp.densification_interval == 0:
                size_threshold = 20.0 if it > fp.opacity_reset_interval else None
                noise = None if densify_noise is None else densify_noise(model.capacity)
                sub_seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
                res = densify_and_prune(
                    model, opt_state, sub_seed,
                    max_grad=fp.densify_grad_threshold,
                    min_opacity=fp.min_opacity,
                    extent=cameras_extent,
                    max_screen_size=size_threshold,
                    percent_dense=cfg.opt.percent_dense,
                    which_object=1,
                    noise=noise,
                )
                model, opt_state = res.model, res.opt_state
                overflow = int(res.overflow)
                if overflow:
                    CONSOLE.log(f"[fine_obj] it {it}: densify overflow — {overflow} "
                                "candidates dropped")
                model, opt_state, grew = ensure_capacity(model, opt_state)
                if grew:
                    tile_cfg = auto_tile_config(model, batch.camera(0),
                                                tile_size=cfg.render.tile_size)
            if it % fp.opacity_reset_interval == 0:
                model, opt_state = reset_opacity(model, opt_state, which_object=1)
        ckpt.maybe_save(it, (model, opt_state, pose_opt, pose_seq), rng, gen, extra=dict(
            tile_cfg=tile_cfg, drop_max=drop_max, last_drop=last_drop, crop_size=crop_size,
            crop_max=crop_max, last_crop=last_crop))

    _log_dropped_pairs("fine_obj", None, drop_max)
    log_metrics("fine_obj", fp.total_num_iter, event="stage_end", steps=fp.total_num_iter,
                crop_size=crop_size, dropped_pairs=drop_max,
                crop_escapes=crop_escape_count(crop_max) if crop_size is not None else 0)
    if save_dir:
        save_pose_sequence(os.path.join(save_dir, "obj_pose_sequence.npz"), pose_seq,
                           [c.image_name for c in cameras])
        save_ply(model, os.path.join(save_dir, "gaussians_fine.ply"))
    return pose_seq, model
