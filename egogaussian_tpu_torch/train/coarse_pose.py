"""Stage 2: coarse per-frame object-pose estimation.

Port of `egogaussian_tpu/train/coarse_pose.py` (the twin of reference
`trainers/coarse_obj_pose.py:88-369`):

  * Object Gaussians render from `where(is_object, T_pose @ T_prev (xyz),
    xyz)` with their covariance rotated by the same rotation; nothing is
    mutated and reversed.
  * The pose sequence is a dense PoseSequence; the accumulated transforms
    of already-solved frames come from identity-prefixed tables built once
    per solved frame.
  * The warm-up / densify-window / restore learning-rate choreography
    (coarse_obj_pose.py:178-193) is computed on the host per iteration
    into per-field learning rates handed to the step.

Schedule per dynamic frame (CoarseParams):
  it < warm_up:            pose only (Gaussian LRs zero unless first frame
                           of the phase, which trains shape at /10 LRs)
  warm_up..densify_from:   Gaussians at /10 LRs, xyz at /100
  densify window:          pose frozen, xyz back to /10 on the expon
                           schedule, densify/prune which_object=1, object
                           opacity reset
  after:                   pose LR restored
Frame selection: with p = curr_vpt_prob the current frame (pose trainable;
the last dynamic frame trains against the next static phase's frames),
else a weighted previous frame (static 1x, solved dynamic 2x) with a
nonempty object mask; iteration 1 always uses the very first static frame.
Loss: 1.0*[0.9*L1 + 0.1*(1-SSIM)](gt*obj_mask, render) + 0.5*L2(obj_mask,
alpha), hand-mask gradient gating on image and alpha.

The loop reads nothing back from the device between densify intervals:
the loss, dropped-pair and crop-escape maxima stay device tensors.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from egogaussian_tpu_torch.config import Config
from egogaussian_tpu_torch.data.readers import FrameBatch, stack_cameras
from egogaussian_tpu_torch.models.densify import (
    add_densification_stats,
    densify_and_prune,
    reset_opacity,
)
from egogaussian_tpu_torch.models.gaussians import (
    PARAM_FIELDS,
    GaussianModel,
    GaussianParams,
    ensure_capacity,
    save_ply,
)
from egogaussian_tpu_torch.models.optim import (
    AdamState,
    adam_advance,
    adam_init,
    adam_update,
    expon_lr,
)
from egogaussian_tpu_torch.models.pose import (
    ObjectPose,
    PoseSequence,
    empty_pose_sequence,
    identity_pose,
    pose_to_se3,
    save_pose_sequence,
)
from egogaussian_tpu_torch.ops.losses import l1_loss, l2_loss
from egogaussian_tpu_torch.train.ckpt_hook import (
    StageCheckpointer,
    grow_to_capacity,
    restore_loop,
)
from egogaussian_tpu_torch.train.common import (
    auto_tile_config,
    crop_escape_count,
    image_loss,
    mask_grad,
    maybe_grow_crop,
    maybe_regrow_tile_config,
    pick_backend,
    pose_crop_size,
    render_gaussians,
)
from egogaussian_tpu_torch.train.static import _log_dropped_pairs
from egogaussian_tpu_torch.utils.console import CONSOLE
from egogaussian_tpu_torch.utils.logging import log_metrics


def _f32(x) -> float:
    return float(np.float32(x))


class PoseGrads(NamedTuple):
    loss: torch.Tensor
    params: GaussianParams  # zeros when grad_params is False
    pose: Optional[ObjectPose]  # None when train_pose is False
    probe: torch.Tensor  # [C, 2] screen-space gradient (densify statistics)
    radii: torch.Tensor
    dropped: torch.Tensor
    crop_outside: object


def pose_loss_grads(
    model: GaussianModel,
    pose: ObjectPose,
    batch: FrameBatch,
    cam_idx: int,
    fixed_T: torch.Tensor,
    fixed_R: torch.Tensor,
    train_pose: bool,
    lambda_image: float = 1.0,
    lambda_dssim: float = 0.1,
    lambda_l1_alpha: float = 0.0,
    lambda_l2_alpha: float = 0.5,
    backend: str = "tiled",
    tile_config=None,
    grad_params: bool = True,
    crop_size=None,
) -> PoseGrads:
    """The pose stages' loss on frame cam_idx and its gradients: the object
    Gaussians rendered at pose @ fixed_T (fixed_T alone when train_pose is
    False) against gt * obj_mask, plus the L1 / L2 alpha terms, hand-mask
    gated. With crop_size, crop sums are normalized by the full frame's
    pixel count. grad_params=False builds no parameter backward."""
    dev = model.device
    cam, gt, hand, obj_mask = batch.frame(cam_idx)
    bg = torch.zeros(3, device=dev)
    if crop_size is not None:
        from egogaussian_tpu_torch.render.crop import crop_plane, mask_rect

        cw, ch = int(crop_size[0]), int(crop_size[1])
        rect = mask_rect(obj_mask)
        # sums over the crop / full-frame count == the full-frame means
        # (every pixel outside is exactly 0 in prediction and target)
        loss_scale = (cw * ch) / float(batch.width * batch.height)

    leaves = {k: v.detach().requires_grad_(grad_params)
              for k, v in model.params.as_dict().items()}
    m = dataclasses.replace(model, params=GaussianParams(**leaves))
    pose_p = ObjectPose(translation=pose.translation.detach().requires_grad_(train_pose),
                        rot6d=pose.rot6d.detach().requires_grad_(train_pose))
    probe = torch.zeros((model.capacity, 2), device=dev, requires_grad=True)
    if train_pose:
        T = pose_to_se3(pose_p) @ fixed_T
        R_extra = pose_p.rotation @ fixed_R
    else:
        T, R_extra = fixed_T, fixed_R
    res = render_gaussians(
        m, cam, bg, pose_T=T, extra_rot=R_extra, means2d_probe=probe,
        backend=backend, tile_config=tile_config, crop_size=crop_size,
        crop_rect=rect if crop_size is not None else None,
    )
    if crop_size is not None:
        ox, oy = res.crop_offset[0], res.crop_offset[1]
        gt_c = crop_plane(gt, ox, oy, cw, ch)
        hand_c = crop_plane(hand, ox, oy, cw, ch)
        mask_c = crop_plane(obj_mask, ox, oy, cw, ch)
    else:
        gt_c, hand_c, mask_c = gt, hand, obj_mask
    img = mask_grad(res.image, hand_c)
    alpha = mask_grad(res.alpha, hand_c)
    loss = lambda_image * image_loss(img, gt_c * mask_c, lambda_dssim)
    loss = loss + lambda_l1_alpha * l1_loss(mask_c, alpha)
    loss = loss + lambda_l2_alpha * l2_loss(mask_c, alpha)
    if crop_size is not None:
        loss = loss * loss_scale

    inputs = [probe]
    if train_pose:
        inputs += [pose_p.translation, pose_p.rot6d]
    if grad_params:
        inputs += list(leaves.values())
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
    if grad_params:
        param_grads = GaussianParams(**dict(zip(leaves, grads[-len(leaves):])))
    else:
        param_grads = model.params.map(torch.zeros_like)
    pose_grads = ObjectPose(translation=grads[1], rot6d=grads[2]) if train_pose else None
    return PoseGrads(loss.detach(), param_grads, pose_grads, grads[0], res.radii,
                     res.dropped_pairs, res.crop_outside)


def pose_step(
    model: GaussianModel,
    opt_state: AdamState,
    pose: ObjectPose,
    pose_opt_state: AdamState,
    batch: FrameBatch,
    cam_idx: int,
    fixed_T: torch.Tensor,
    fixed_R: torch.Tensor,
    lr_tree: Dict[str, float],
    pose_lr_t: float,
    pose_lr_r: float,
    record_stats: bool,
    drop_max: torch.Tensor,
    train_pose: bool,
    lambda_image: float = 1.0,
    lambda_dssim: float = 0.1,
    lambda_l1_alpha: float = 0.0,
    lambda_l2_alpha: float = 0.5,
    backend: str = "tiled",
    tile_config=None,
    grad_params: bool = True,
    param_grad_gate: Optional[float] = None,
    crop_size=None,
    crop_max=0,
):
    """One pose-optimization iteration (the shared core of stages 2 and 3;
    port of `_pose_core` / `pose_step`): pose_loss_grads, then Adam on the
    parameters and, when train_pose, on the pose. The caller's
    `tile_config` goes to the kernels as given, flavor fields included.

    `crop_size` (crop_w, crop_h): the full-frame loss and gradients
    whenever the returned escape count is 0 (render/crop.py).
    `grad_params=False` builds no parameter backward (warm-up trains the
    pose only); the parameters get a zero-gradient Adam update.
    `param_grad_gate` (0/1) multiplies the parameter gradients before the
    update. `train_pose=False` leaves the pose and its Adam state
    untouched (a zero-gradient update would still decay the moments).
    `record_stats` adds the screen-space gradient statistics.

    Returns (model, opt_state, pose, pose_opt_state, loss, radii, drop_max,
    crop_max), all device tensors."""
    g = pose_loss_grads(
        model, pose, batch, cam_idx, fixed_T, fixed_R, train_pose,
        lambda_image=lambda_image, lambda_dssim=lambda_dssim,
        lambda_l1_alpha=lambda_l1_alpha, lambda_l2_alpha=lambda_l2_alpha,
        backend=backend, tile_config=tile_config, grad_params=grad_params,
        crop_size=crop_size)
    dev = model.device
    with torch.no_grad():
        param_grads = g.params
        if param_grad_gate is not None:
            param_grads = param_grads.map(lambda x: x * float(param_grad_gate))
        if record_stats:
            # densification statistics after warm-up only
            # (coarse_obj_pose.py:283-287), in NDC units like the reference
            ndc_scale = torch.tensor([batch.width * 0.5, batch.height * 0.5], device=dev)
            model = add_densification_stats(model, g.probe * ndc_scale, g.radii)
        new_params, opt_state = adam_update(model.params, param_grads, opt_state, lr_tree)
        model = dataclasses.replace(model, params=new_params)
        if train_pose:
            pose, pose_opt_state = adam_update(
                pose, g.pose, pose_opt_state, {"translation": pose_lr_t, "rot6d": pose_lr_r})
        drop_max = torch.maximum(drop_max, g.dropped.to(drop_max.dtype))
        crop_max = torch.maximum(
            torch.as_tensor(crop_max, dtype=torch.int32, device=dev),
            torch.as_tensor(g.crop_outside, dtype=torch.int32, device=dev))
    return (model, opt_state, pose, pose_opt_state, g.loss, g.radii, drop_max, crop_max)


def _coarse_lr_tree(model, it: int, opt, cp, first_frame: bool) -> Dict[str, float]:
    """Gaussian-field learning rates of the coarse stage: /10 dividers,
    opacity not divided (train_coarse_obj_setup, gaussian_model.py:810-849);
    zero during warm-up unless it is the phase's first frame; the xyz
    choreography of coarse_obj_pose.py:178-196. float32 values, as the
    JAX package computes them."""
    spatial = model.spatial_lr_scale
    base = opt.position_lr_init * spatial / 10.0
    if it < cp.warm_up_iter:
        xyz = base if first_frame else 0.0
    elif it <= cp.densify_from_iter:
        xyz = base / 10.0
    else:
        xyz = expon_lr(it - cp.densify_from_iter, base, opt.position_lr_final * spatial / 10.0,
                       lr_delay_mult=opt.position_lr_delay_mult,
                       max_steps=opt.position_lr_max_steps)
    af = 1.0 if (first_frame or it >= cp.warm_up_iter) else 0.0
    lrs = dict(
        xyz=_f32(xyz),
        features_dc=_f32(opt.feature_lr / 10.0) * af,
        features_rest=_f32(opt.feature_lr / 20.0 / 10.0) * af,
        log_scales=_f32(opt.scaling_lr / 10.0) * af,
        quats=_f32(opt.rotation_lr / 10.0) * af,
        opacity_logit=_f32(opt.opacity_lr) * af,
        label=0.0,
    )
    return {k: lrs[k] for k in PARAM_FIELDS}


def _coarse_pose_lrs(it: int, opt, cp) -> Tuple[float, float]:
    """Pose LR: active until densify_from, frozen in the window, restored
    after densify_until (coarse_obj_pose.py:185-192)."""
    if cp.densify_from_iter <= it < cp.densify_until_iter:
        return 0.0, 0.0
    return _f32(opt.obj_translation_lr), _f32(opt.obj_rotation_lr)


def coarse_step(
    model: GaussianModel,
    opt_state: AdamState,
    pose: ObjectPose,
    pose_opt_state: AdamState,
    batch: FrameBatch,
    cam_idx: int,
    table_T: torch.Tensor,
    table_R: torch.Tensor,
    fixed_idx: int,
    it: int,
    drop_max: torch.Tensor,
    train_pose: bool,
    first_frame: bool,
    grad_params: bool,
    count_advance: int = 0,
    opt_cfg=None,
    coarse_cfg=None,
    backend: str = "tiled",
    tile_config=None,
    crop_size=None,
    crop_max=0,
):
    """Stage-2 iteration: the per-iteration LR choreography, the densify
    statistics gate (it > warm_up) and the fixed accumulated transform
    gathered from the identity-prefixed tables at fixed_idx + 1.
    `count_advance` advances the parameter Adam count first: the exact
    residue of that many elided warm-up no-op iterations."""
    cp = coarse_cfg
    if count_advance:
        opt_state = adam_advance(opt_state, count_advance)
    lr_tree = _coarse_lr_tree(model, it, opt_cfg, cp, first_frame)
    plr_t, plr_r = _coarse_pose_lrs(it, opt_cfg, cp)
    return pose_step(
        model, opt_state, pose, pose_opt_state, batch, cam_idx,
        table_T[fixed_idx + 1], table_R[fixed_idx + 1], lr_tree,
        plr_t, plr_r, it > cp.warm_up_iter, drop_max,
        train_pose=train_pose,
        lambda_image=cp.lambda_image,
        lambda_dssim=cp.lambda_dssim,
        lambda_l1_alpha=cp.lambda_Ll1_alpha,
        lambda_l2_alpha=cp.lambda_Ll2_alpha,
        backend=backend,
        tile_config=tile_config,
        grad_params=grad_params,
        crop_size=crop_size,
        crop_max=crop_max,
    )


def _accum_tables(pose_seq: PoseSequence):
    """Identity-prefixed accumulated-transform tables: row i+1 holds the
    accumulation through frame i, row 0 the identity."""
    T = pose_seq.accum_T()
    R = pose_seq.accum_R()
    return (
        torch.cat([torch.eye(4, dtype=T.dtype, device=T.device)[None], T]),
        torch.cat([torch.eye(3, dtype=R.dtype, device=R.device)[None], R]),
    )


def _sampling_pool(batch, static_frames, dyn_frames, f_cur, solved):
    """Previous-frame sampling pool: static frames 1x, solved earlier
    dynamic frames 2x, only frames with a nonempty object mask.
    Returns (frames, probabilities); one host sync per solved frame."""
    pool = list(static_frames) + [g for g in dyn_frames if g < f_cur and g in solved]
    weights = [1.0] * len(static_frames) + [2.0] * (len(pool) - len(static_frames))
    idx = torch.as_tensor(pool, device=batch.obj_masks.device)
    ok = (torch.sum(batch.obj_masks[idx].to(torch.int32), dim=(1, 2, 3)) > 0).cpu().numpy()
    pool = [p for p, k in zip(pool, ok) if k]
    weights = np.array([w for w, k in zip(weights, ok) if k], np.float64)
    return pool, weights / weights.sum()


def estimate_coarse_obj_pose(
    cameras: Sequence,
    obj_model: GaussianModel,
    cfg: Config,
    static_phase_frames: List[List[int]],
    dynamic_phase_frames: List[List[int]],
    cameras_extent: float,
    save_dir: Optional[str] = None,
    seed: int = 0,
    backend: str = "auto",
    checkpoint_every: int = 0,
    skip_noop_warmup: bool = True,
    device: Optional[torch.device] = None,
    on_step: Optional[Callable[[int, int, torch.Tensor], None]] = None,
    densify_noise: Optional[Callable[[int, int], torch.Tensor]] = None,
) -> Tuple[PoseSequence, GaussianModel, Dict[int, str]]:
    """Stage 2. Returns (pose sequence over all cameras, refined object
    model, {camera index: image name} of the solved frames).

    `device`: where the model, frames and kernels run; None means the card
      (`cuda`), as in JAX, which runs on its default device.
    `skip_noop_warmup`: elide the warm-up previous-frame iterations of
      non-first frames. Each is an exact no-op (the pose is not trained,
      the parameter gradients are zero onto zero moments, no statistics)
      except for the Adam step count, which the next real step advances.
    `on_step(frame, it, loss)`: optional observer after every real step.
    `densify_noise(frame, capacity)`: optional [2, C, 3] split noise for
      each densify call of a frame, in order (tests inject the JAX draw);
      by default the port's split_noise with seeds from a generator seeded
      seed*1000 + frame.
    At the end the run counters go to the active metrics logger as one
    record with event="stage_end": steps, elided, crop_size_initial,
    crop_size, crop_escapes, dropped_pairs.
    `checkpoint_every`: any value > 0 (with save_dir) saves after every
      solved frame (model, pose sequence, the solved frames and the loop's
      host state) to save_dir/ckpt_coarse.npz, and a run whose file exists
      skips the frames it solved: the resume is frame-granular."""
    if device is None:
        device = torch.device("cuda")
    # float32 throughout: cuDNN would run the SSIM convolutions in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    rng = np.random.RandomState(seed)
    cp = cfg.coarse
    model = obj_model
    batch = stack_cameras(list(cameras), device)
    tile_cfg = auto_tile_config(model, batch.camera(0), tile_size=cfg.render.tile_size)
    backend = pick_backend(tile_cfg, backend)
    crop_size = pose_crop_size(batch, cfg, "coarse")
    crop0 = crop_size
    pose_seq = empty_pose_sequence(batch.viewmats.shape[0], device=device)
    solved_names: Dict[int, str] = {}

    def zero_crop_stat():
        return (torch.zeros((3,), dtype=torch.int32, device=device) if crop_size is not None
                else torch.zeros((), dtype=torch.int32, device=device))

    drop_max = torch.zeros((), dtype=torch.int64, device=device)
    last_drop = 0
    crop_max = zero_crop_stat()
    last_crop = 0
    n_steps = n_elided = 0

    # any nonzero checkpoint_every saves after every solved frame; the
    # per-frame split generators are seeded afresh, so none is saved
    ckpt = StageCheckpointer(
        os.path.join(save_dir, "ckpt_coarse.npz") if save_dir and checkpoint_every else None,
        1 if checkpoint_every else 0)
    no_gen = torch.Generator()
    if ckpt.exists():
        model, _ = grow_to_capacity(model, adam_init(model.params), ckpt.peek_capacity())
        (model, pose_seq), _ = ckpt.try_restore((model, pose_seq), rng, no_gen, "coarse")
        loop = restore_loop(ckpt.extra, device)
        solved_names = dict(loop["solved"])
        tile_cfg, drop_max, last_drop = loop["tile_cfg"], loop["drop_max"], loop["last_drop"]
        crop_size, crop_max, last_crop = loop["crop_size"], loop["crop_max"], loop["last_crop"]
        n_steps, n_elided = loop["steps"], loop["elided"]
        backend = pick_backend(tile_cfg, backend)
        CONSOLE.log(f"[coarse] resume: {len(solved_names)} frames solved")
    for phase, dyn_frames in enumerate(dynamic_phase_frames):
        # the first frame of the next static phase closes the phase
        # (coarse_obj_pose.py:137)
        frames = list(dyn_frames) + [static_phase_frames[phase + 1][0]]
        CONSOLE.log(f"[coarse] phase {phase}: frames {frames[0]}..{frames[-1]} "
                    f"({len(frames)} incl. next-static anchor)")
        for i, f_cur in enumerate(frames):
            if f_cur in solved_names:
                continue  # frame-granular resume: solved before the restart
            table_T, table_R = _accum_tables(pose_seq)
            pool, weights = _sampling_pool(batch, static_phase_frames[phase], dyn_frames,
                                           f_cur, solved_names)
            pose = identity_pose(device)
            pose_opt = adam_init(pose)
            opt_state = adam_init(model.params)  # fresh Adam per frame
            gen = torch.Generator().manual_seed(seed * 1000 + f_cur)  # split seeds
            first_frame = i == 0
            is_last = i == len(frames) - 1
            next_static = static_phase_frames[phase + 1]
            pending_noop = 0
            loss = torch.full((), float("nan"), device=device)

            for it in range(1, cp.total_num_iter + 1):
                # frame selection (coarse_obj_pose.py:196-222)
                if it == 1:
                    cam_idx, train_p = static_phase_frames[0][0], False
                elif rng.rand() <= cp.curr_vpt_prob:
                    cam_idx = next_static[rng.randint(len(next_static))] if is_last else f_cur
                    train_p = True
                else:
                    cam_idx = pool[rng.choice(len(pool), p=weights)]
                    train_p = False

                # warm-up previous-frame iterations of non-first frames are
                # exact no-ops but for the Adam count (see the docstring)
                if (skip_noop_warmup and not first_frame and not train_p
                        and it < cp.warm_up_iter):
                    pending_noop += 1
                    n_elided += 1
                    continue

                fixed_idx = (f_cur - 1) if train_p else cam_idx
                (model, opt_state, pose, pose_opt, loss, _, drop_max, crop_max) = coarse_step(
                    model, opt_state, pose, pose_opt, batch, cam_idx, table_T, table_R,
                    fixed_idx, it, drop_max,
                    train_pose=train_p,
                    first_frame=first_frame,
                    grad_params=first_frame or it >= cp.warm_up_iter,
                    count_advance=pending_noop,
                    opt_cfg=cfg.opt,
                    coarse_cfg=cp,
                    backend=backend,
                    tile_config=tile_cfg,
                    crop_size=crop_size,
                    crop_max=crop_max,
                )
                pending_noop = 0
                n_steps += 1
                if on_step is not None:
                    on_step(f_cur, it, loss)

                if it % cp.densification_interval == 0:
                    tile_cfg, last_drop, changed = maybe_regrow_tile_config(
                        model, batch.camera(0), tile_cfg, drop_max, last_drop, "coarse")
                    if changed:
                        drop_max, last_drop = torch.zeros_like(drop_max), 0
                    crop_size, last_crop, cchanged = maybe_grow_crop(
                        crop_size, crop_max, last_crop, batch, "coarse")
                    if cchanged:
                        crop_max = zero_crop_stat()
                    log_metrics("coarse", it, frame=f_cur, loss=loss, alive=model.num_alive,
                                capacity=model.capacity, dropped_pairs=drop_max,
                                crop_escapes=crop_escape_count(crop_max))

                # densification window (coarse_obj_pose.py:324-337)
                if cp.densify_from_iter < it < cp.densify_until_iter:
                    if it % cp.densification_interval == 0:
                        size_threshold = 20.0 if it > cp.opacity_reset_interval else None
                        noise = None if densify_noise is None else densify_noise(
                            f_cur, model.capacity)
                        sub_seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
                        res = densify_and_prune(
                            model, opt_state, sub_seed,
                            max_grad=cp.densify_grad_threshold,
                            min_opacity=cp.min_opacity,
                            extent=cameras_extent,
                            max_screen_size=size_threshold,
                            percent_dense=cfg.opt.percent_dense,
                            which_object=1,
                            noise=noise,
                        )
                        model, opt_state = res.model, res.opt_state
                        overflow = int(res.overflow)
                        if overflow:
                            CONSOLE.log(f"[coarse] it {it}: densify overflow — {overflow} "
                                        "candidates dropped")
                        model, opt_state, grew = ensure_capacity(model, opt_state)
                        if grew:
                            tile_cfg = auto_tile_config(model, batch.camera(0),
                                                        tile_size=cfg.render.tile_size)
                    if it % cp.opacity_reset_interval == 0:
                        model, opt_state = reset_opacity(model, opt_state, which_object=1)

            # write the solved delta back once per frame (a frame's trained
            # pose never feeds its own fixed prefix)
            pose_seq = pose_seq.update_frame(f_cur, pose)
            solved_names[f_cur] = cameras[f_cur].image_name
            # before the pose file: a kill in between redoes no frame
            ckpt.maybe_save(len(solved_names), (model, pose_seq), rng, no_gen, extra=dict(
                solved=dict(solved_names), tile_cfg=tile_cfg, drop_max=drop_max,
                last_drop=last_drop, crop_size=crop_size, crop_max=crop_max,
                last_crop=last_crop, steps=n_steps, elided=n_elided))
            CONSOLE.log(f"[coarse] solved frame {cameras[f_cur].image_name} "
                        f"({i + 1}/{len(frames)}), loss {float(loss):.4f}")
            if save_dir:
                save_pose_sequence(os.path.join(save_dir, "obj_pose_sequence.npz"), pose_seq,
                                   [c.image_name for c in cameras])
                if (i + 1) % cp.save_ply_every == 0:
                    save_ply(model, os.path.join(save_dir, "ply", f"gaussians_frame{f_cur}.ply"))

    _log_dropped_pairs("coarse", None, drop_max)
    escapes = crop_escape_count(crop_max) if crop_size is not None else 0
    if escapes:
        CONSOLE.log(f"[coarse] WARNING — up to {escapes} splats/render escaped the crop "
                    "window since the last growth (their out-of-window gradients were "
                    "lost; the window grows at the next densify-interval check)")
    if save_dir:
        save_ply(model, os.path.join(save_dir, "ply", "gaussians_final.ply"))
        save_pose_sequence(os.path.join(save_dir, "obj_pose_sequence.npz"), pose_seq,
                           [c.image_name for c in cameras])
    log_metrics("coarse", n_steps + n_elided, event="stage_end", steps=n_steps,
                elided=n_elided, crop_size_initial=crop0, crop_size=crop_size,
                crop_escapes=escapes, dropped_pairs=drop_max)
    return pose_seq, model, solved_names
