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

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from egogaussian_tpu_torch.config import Config
from egogaussian_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from egogaussian_tpu_torch.models.optim import expon_lr
from egogaussian_tpu_torch.models.pose import ObjectPose, PoseSequence, identity_pose
from egogaussian_tpu_torch.ops.rotation6d import rotmat_to_rot6d
from egogaussian_tpu_torch.train.coarse_pose import _f32


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


def accum_tables(pose_seqs: PoseSequence):
    """(accum_T [S, F, 4, 4], accum_R [S, F, 3, 3]) of a scene-stacked
    PoseSequence: PoseSequence.accum_T / accum_R of each scene, the
    unbatched running products of its own run (frames past a scene's own
    count are unsolved: identities times its last product)."""
    seqs = [PoseSequence(pose_seqs.translations[s], pose_seqs.rotations[s],
                         pose_seqs.solved[s]) for s in range(pose_seqs.translations.shape[0])]
    return (torch.stack([q.accum_T() for q in seqs]),
            torch.stack([q.accum_R() for q in seqs]))


def fine_scenes_step(models, opt_states, pose_seqs, pose_opt_states, batches, cam_idxs,
                     it: int, drop_maxes, train_poses, xyz_lr_mult=None, opt_cfg=None,
                     fine_cfg=None, backend: str = "cuda", tile_config=None, crop: bool = False,
                     crop_maxes=None, accums=None, scenes=None):
    """One stage-3 iteration for S lanes at once (JAX's one_lane vmapped):
    lane s renders frame cam_idxs[s]; where train_poses[s] is set it loads
    the frame's stored delta as the pose, at accum[cam - 1] (the identity
    prefix at frame 0), else the identity pose at accum[cam]; each lane's
    learning rates from its own spatial_lr_scale (times xyz_lr_mult); the
    trained delta is written back once the pose rate is live.
    `accums` (accum_tables of pose_seqs) saves recomputing them. Returns
    (models, opt_states, pose_seqs, pose_opt_states, loss [S], drop_maxes,
    crop_maxes, wrote) with wrote True when a delta was written back."""
    from egogaussian_tpu_torch.parallel.multi_scene import place_lrs, scene_lrs
    from egogaussian_tpu_torch.train.coarse_pose import _scene_flags, pose_scenes_step

    fp = fine_cfg
    s_n = models.params.xyz.shape[0]
    dev = models.device
    tp = _scene_flags(train_poses, s_n)
    cams = [int(c) for c in cam_idxs]
    acc_T, acc_R = accum_tables(pose_seqs) if accums is None else accums
    s_idx = torch.arange(s_n, device=dev)
    cam = torch.as_tensor(cams, dtype=torch.int64, device=dev)
    prev = torch.as_tensor([max(c - 1, 0) for c in cams], dtype=torch.int64, device=dev)
    if all(tp):
        poses = ObjectPose(translation=pose_seqs.translations[s_idx, cam],
                           rot6d=rotmat_to_rot6d(pose_seqs.rotations[s_idx, cam]))
    elif not any(tp):
        poses = _identity_poses(s_n, dev)
    else:
        sel = torch.as_tensor(tp, device=dev)
        ident = _identity_poses(s_n, dev)
        poses = ObjectPose(
            translation=torch.where(sel[:, None], pose_seqs.translations[s_idx, cam],
                                    ident.translation),
            rot6d=torch.where(sel[:, None, None],
                              rotmat_to_rot6d(pose_seqs.rotations[s_idx, cam]), ident.rot6d))
    eye4 = torch.eye(4, dtype=acc_T.dtype, device=dev).expand(s_n, 4, 4)
    eye3 = torch.eye(3, dtype=acc_R.dtype, device=dev).expand(s_n, 3, 3)
    first = torch.as_tensor([c == 0 for c in cams], device=dev)[:, None, None]
    pre_T = torch.where(first, eye4, acc_T[s_idx, prev])
    pre_R = torch.where(first, eye3, acc_R[s_idx, prev])
    sel = torch.as_tensor(tp, device=dev)[:, None, None]
    fixed_T = torch.where(sel, pre_T, acc_T[s_idx, cam])
    fixed_R = torch.where(sel, pre_R, acc_R[s_idx, cam])
    pose_live = it >= fp.densify_until_iter
    plr_t = _f32(opt_cfg.obj_translation_lr) if pose_live else 0.0
    plr_r = _f32(opt_cfg.obj_rotation_lr) if pose_live else 0.0
    scales = models.spatial_lr_scale
    scales = scales if isinstance(scales, tuple) else (scales,) * s_n
    lr_tree = place_lrs(scene_lrs([
        _fine_lr_tree(dataclasses.replace(models, spatial_lr_scale=sc), it, opt_cfg)
        for sc in scales]), dev)
    if xyz_lr_mult is not None:
        lr_tree["xyz"] = lr_tree["xyz"] * torch.as_tensor(xyz_lr_mult, dtype=torch.float32,
                                                          device=dev)
    models, opt_states, poses, pose_opt_states, loss, _, drop_maxes, crop_maxes = \
        pose_scenes_step(models, opt_states, poses, pose_opt_states, batches, cam, fixed_T,
                         fixed_R, lr_tree, plr_t, plr_r, True, drop_maxes, tp,
                         lambda_image=fp.lambda_Ll1_image, lambda_dssim=fp.lambda_dssim,
                         lambda_l1_alpha=fp.lambda_Ll1_alpha,
                         lambda_l2_alpha=fp.lambda_Ll2_alpha, backend=backend,
                         caps=tile_config, crop=crop,
                         crop_max=crop_maxes if crop_maxes is not None else 0, scenes=scenes)
    write = [t and pose_live and opt_cfg.obj_translation_lr > 0 for t in tp]
    if any(write):
        rows = torch.as_tensor([s for s in range(s_n) if write[s]], device=dev)
        at = cam[rows]
        tr, rot, solved = (pose_seqs.translations.clone(), pose_seqs.rotations.clone(),
                           pose_seqs.solved.clone())
        tr[rows, at] = poses.translation[rows].detach()
        rot[rows, at] = poses.rotation[rows].detach()
        solved[rows, at] = True
        pose_seqs = PoseSequence(translations=tr, rotations=rot, solved=solved)
    return (models, opt_states, pose_seqs, pose_opt_states, loss, drop_maxes, crop_maxes,
            any(write))


def _identity_poses(s_n: int, dev) -> ObjectPose:
    one = identity_pose(dev)
    return ObjectPose(translation=one.translation.expand(s_n, 3).contiguous(),
                      rot6d=one.rot6d.expand(s_n, 3, 2).contiguous())


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
    from egogaussian_tpu_torch.parallel.scene_trainer import FineSceneInput, train_fine_scenes

    scene = FineSceneInput(cameras, obj_model, pose_seq, static_phase_frames,
                           dynamic_phase_frames, cameras_extent, save_dir=save_dir, seed=seed,
                           densify_noise=densify_noise)
    hook = None if on_step is None else (lambda s, f, it, loss: on_step(f, it, loss))
    return train_fine_scenes([scene], cfg, backend=backend, checkpoint_every=checkpoint_every,
                             device=device, on_step=hook)[0]
