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
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from egogaussian_tpu_torch.config import Config
from egogaussian_tpu_torch.data.readers import FrameBatch
from egogaussian_tpu_torch.models.densify import add_densification_stats
from egogaussian_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel, GaussianParams
from egogaussian_tpu_torch.models.optim import AdamState, adam_update, expon_lr
from egogaussian_tpu_torch.models.pose import ObjectPose, PoseSequence, pose_to_se3
from egogaussian_tpu_torch.ops.losses import l1_loss, l2_loss
from egogaussian_tpu_torch.render.project import rigid_apply
from egogaussian_tpu_torch.train.common import image_loss, mask_grad


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


def smm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the last two axes; with a leading scene axis, each
    scene's unbatched product (the bits of its call without a scene
    axis)."""
    if a.dim() == 3:
        return torch.stack([a[s] @ b[s] for s in range(a.shape[0])])
    return a @ b


def _scene_flags(flags, s_n: int) -> List[bool]:
    if isinstance(flags, (bool, np.bool_)):
        return [bool(flags)] * s_n
    if isinstance(flags, torch.Tensor):
        return [bool(x) for x in flags.reshape(-1).tolist()]
    return [bool(x) for x in flags]


def pose_loss_grads_scenes(models, poses, batches, cam_idxs, fixed_T, fixed_R, train_pose,
                           lambda_image=1.0, lambda_dssim=0.1, lambda_l1_alpha=0.0,
                           lambda_l2_alpha=0.5, backend="cuda", caps=None,
                           grad_params=True, crop=False, scenes=None) -> PoseGrads:
    """The pose stages' loss and gradients for S scenes at once: scene s's
    object Gaussians rendered at pose_s @ fixed_T[s] (fixed_T[s] alone
    where train_pose[s] is off) in its frame cam_idxs[s], against gt *
    obj_mask plus the L1 / L2 alpha terms, hand-mask gated. `caps` holds
    each scene's binning capacities and composite size (its crop window's
    with `crop`); crop sums are normalized by the full frame's pixel count.
    grad_params (a Python bool) builds the parameter backward at all.
    Returns per-scene loss [S], probe [S, C, 2], radii [S, C], dropped [S]
    and crop_outside [S, 3] (or 0)."""
    from egogaussian_tpu_torch.parallel.multi_scene import scene_frames
    from egogaussian_tpu_torch.render.api import render_scenes
    from egogaussian_tpu_torch.train.common import model_colors

    s_n, cap = models.params.xyz.shape[:2]
    dev = models.device
    tp = _scene_flags(train_pose, s_n)
    cams, gt, hand, obj_mask = scene_frames(batches, cam_idxs, scenes)
    bg = torch.zeros((s_n, 3), device=dev)
    w, h = batches.width, batches.height
    if crop:
        from egogaussian_tpu_torch.render.crop import crop_planes, mask_rects

        rects = mask_rects(obj_mask)
        # sums over the crop / full-frame count == the full-frame means
        # (every pixel outside is exactly 0 in prediction and target)
        scales = [(cw * ch) / float(w * h) for cw, ch in caps.sizes]

    leaves = {k: v.detach().requires_grad_(grad_params)
              for k, v in models.params.as_dict().items()}
    m = dataclasses.replace(models, params=GaussianParams(**leaves))
    any_tp = any(tp)
    pose_p = ObjectPose(translation=poses.translation.detach().requires_grad_(any_tp),
                        rot6d=poses.rot6d.detach().requires_grad_(any_tp))
    probe = torch.zeros((s_n, cap, 2), device=dev, requires_grad=True)
    if any_tp:
        T = smm(pose_to_se3(pose_p), fixed_T)
        R_extra = smm(pose_p.rotation, fixed_R)
        if not all(tp):
            sel = torch.as_tensor(tp, device=dev)[:, None, None]
            T = torch.where(sel, T, fixed_T)
            R_extra = torch.where(sel, R_extra, fixed_R)
    else:
        T, R_extra = fixed_T, fixed_R
    obj = (m.aux.is_object == 1)[..., None]
    xyz = torch.where(obj, rigid_apply(m.params.xyz, T[..., :3, :3], T[..., :3, 3],
                                       m.scene_rows), m.params.xyz)
    res = render_scenes(cams, xyz, m.covariance_rotated(R_extra, 1), m.opacity, bg,
                        model_colors(m), caps, valid_mask=m.aux.alive, means2d_probe=probe,
                        backend=backend, crop=crop, crop_rects=rects if crop else None)

    def loss_of(image, alpha, gt_c, hand_c, mask_c):
        img = mask_grad(image, hand_c)
        alpha = mask_grad(alpha, hand_c)
        loss = lambda_image * image_loss(img, gt_c * mask_c, lambda_dssim)
        loss = loss + lambda_l1_alpha * l1_loss(mask_c, alpha)
        return loss + lambda_l2_alpha * l2_loss(mask_c, alpha)

    if crop and len(set(caps.sizes)) > 1:
        # windows of different sizes: each scene's loss over its own
        # window, as its own run takes it (the shared largest window's
        # padding would enter the means)
        ox, oy = res.crop_offset[:, 0], res.crop_offset[:, 1]
        loss = torch.cat([
            loss_of(res.image[s:s + 1, :, :ch, :cw], res.alpha[s:s + 1, :, :ch, :cw],
                    *(crop_planes(x[s:s + 1], ox[s:s + 1], oy[s:s + 1], [(cw, ch)], cw, ch)
                      for x in (gt, hand, obj_mask))) * scales[s]
            for s, (cw, ch) in enumerate(caps.sizes)])
    elif crop:
        ox, oy = res.crop_offset[:, 0], res.crop_offset[:, 1]
        (cw, ch), = set(caps.sizes)
        loss = loss_of(res.image, res.alpha,
                       *(crop_planes(x, ox, oy, caps.sizes, cw, ch)
                         for x in (gt, hand, obj_mask))) * scales[0]
    else:
        loss = loss_of(res.image, res.alpha, gt, hand, obj_mask)

    inputs = [probe]
    if any_tp:
        inputs += [pose_p.translation, pose_p.rot6d]
    if grad_params:
        inputs += list(leaves.values())
    grads = torch.autograd.grad(loss.sum(), inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
    if grad_params:
        param_grads = GaussianParams(**dict(zip(leaves, grads[-len(leaves):])))
    else:
        param_grads = models.params.map(torch.zeros_like)
    pose_grads = ObjectPose(translation=grads[1], rot6d=grads[2]) if any_tp else None
    return PoseGrads(loss.detach(), param_grads, pose_grads, grads[0], res.radii,
                     res.dropped_pairs, res.crop_outside)


def pose_scenes_step(models, opt_states, poses, pose_opt_states, batches, cam_idxs, fixed_T,
                     fixed_R, lr_tree, pose_lr_t, pose_lr_r, record_stats: bool, drop_max,
                     train_pose, lambda_image=1.0, lambda_dssim=0.1, lambda_l1_alpha=0.0,
                     lambda_l2_alpha=0.5, backend="cuda", caps=None, grad_params=True,
                     param_grad_gate=None, crop=False, crop_max=0, scenes=None):
    """pose_step for S scenes at once (the shared core of stages 2 and 3 in
    the lockstep): pose_loss_grads_scenes, then Adam on the parameters
    (gated per scene by param_grad_gate [S] of 0 / 1 where given) and on
    the pose of every scene whose train_pose is set; a scene whose
    train_pose is off keeps its pose and pose Adam state bit for bit.
    Returns (models, opt_states, poses, pose_opt_states, loss [S], radii,
    drop_max [S], crop_max)."""
    from egogaussian_tpu_torch.models.optim import per_scene
    from egogaussian_tpu_torch.parallel.scene_trainer import _select

    s_n = models.params.xyz.shape[0]
    dev = models.device
    tp = _scene_flags(train_pose, s_n)
    g = pose_loss_grads_scenes(
        models, poses, batches, cam_idxs, fixed_T, fixed_R, tp, lambda_image=lambda_image,
        lambda_dssim=lambda_dssim, lambda_l1_alpha=lambda_l1_alpha,
        lambda_l2_alpha=lambda_l2_alpha, backend=backend, caps=caps, grad_params=grad_params,
        crop=crop, scenes=scenes)
    with torch.no_grad():
        param_grads = g.params
        if param_grad_gate is not None:
            gate = param_grad_gate
            if isinstance(gate, (list, tuple)) or (isinstance(gate, torch.Tensor)
                                                   and gate.dim() == 1):
                gate = torch.as_tensor(gate, dtype=torch.float32, device=dev)
                param_grads = param_grads.map(lambda x: x * per_scene(gate, x))
            else:
                param_grads = param_grads.map(lambda x: x * float(gate))
        if record_stats:
            # densification statistics after warm-up only
            # (coarse_obj_pose.py:283-287), in NDC units like the reference
            ndc_scale = torch.tensor([batches.width * 0.5, batches.height * 0.5], device=dev)
            models = add_densification_stats(models, g.probe * ndc_scale, g.radii)
        new_params, opt_states = adam_update(models.params, param_grads, opt_states, lr_tree)
        models = dataclasses.replace(models, params=new_params)
        if any(tp):
            new_pose, new_popt = adam_update(
                poses, g.pose, pose_opt_states, {"translation": pose_lr_t, "rot6d": pose_lr_r})
            if not all(tp):
                sel = torch.as_tensor(tp, device=dev)
                new_pose = _select(sel, new_pose, poses)
                new_popt = _select(sel, new_popt, pose_opt_states)
            poses, pose_opt_states = new_pose, new_popt
        drop_max = torch.maximum(drop_max, g.dropped.to(drop_max.dtype))
        crop_max = torch.maximum(
            torch.as_tensor(crop_max, dtype=torch.int32, device=dev),
            torch.as_tensor(g.crop_outside, dtype=torch.int32, device=dev))
    return (models, opt_states, poses, pose_opt_states, g.loss, g.radii, drop_max, crop_max)


def _one_caps(model, batch, tile_config, crop_size):
    from egogaussian_tpu_torch.render.tiled import scene_caps

    size = tuple(crop_size) if crop_size is not None else (batch.width, batch.height)
    return scene_caps([tile_config], [size], model.device, model.capacity)


def _lead_T(x):
    return torch.as_tensor(x)[None]


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
    pixel count. grad_params=False builds no parameter backward. The
    one-scene case of pose_loss_grads_scenes."""
    from egogaussian_tpu_torch.parallel.multi_scene import stack_scenes

    g = pose_loss_grads_scenes(
        stack_scenes([model]), stack_scenes([pose]), stack_scenes([batch]),
        torch.tensor([int(cam_idx)], device=model.device), _lead_T(fixed_T), _lead_T(fixed_R),
        [bool(train_pose)], lambda_image=lambda_image, lambda_dssim=lambda_dssim,
        lambda_l1_alpha=lambda_l1_alpha, lambda_l2_alpha=lambda_l2_alpha, backend=backend,
        caps=_one_caps(model, batch, tile_config, crop_size), grad_params=grad_params,
        crop=crop_size is not None)
    pose_g = None if g.pose is None else ObjectPose(translation=g.pose.translation[0],
                                                    rot6d=g.pose.rot6d[0])
    crop_out = g.crop_outside[0] if crop_size is not None else g.crop_outside
    return PoseGrads(g.loss[0], g.params.map(lambda x: x[0]), pose_g, g.probe[0], g.radii[0],
                     g.dropped[0], crop_out)


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
    crop_max), all device tensors. The one-scene case of pose_scenes_step."""
    from egogaussian_tpu_torch.parallel.multi_scene import stack_scenes, unstack_scenes

    dev = model.device
    crop = crop_size is not None
    out = pose_scenes_step(
        stack_scenes([model]), stack_scenes([opt_state]), stack_scenes([pose]),
        stack_scenes([pose_opt_state]), stack_scenes([batch]),
        torch.tensor([int(cam_idx)], device=dev), _lead_T(fixed_T), _lead_T(fixed_R), lr_tree,
        pose_lr_t, pose_lr_r, record_stats, drop_max.reshape(1), [bool(train_pose)],
        lambda_image=lambda_image, lambda_dssim=lambda_dssim, lambda_l1_alpha=lambda_l1_alpha,
        lambda_l2_alpha=lambda_l2_alpha, backend=backend,
        caps=_one_caps(model, batch, tile_config, crop_size), grad_params=grad_params,
        param_grad_gate=param_grad_gate, crop=crop,
        crop_max=torch.as_tensor(crop_max, dtype=torch.int32, device=dev)[None] if crop
        else crop_max)
    m, o, p, po, loss, radii, drop, cmax = out
    (m,), (o,), (p,), (po,) = (unstack_scenes(x, 1) for x in (m, o, p, po))
    return (m, o, p, po, loss[0], radii[0], drop[0].reshape(drop_max.shape),
            cmax[0] if crop else cmax)


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


def coarse_scenes_step(models, opt_states, poses, pose_opt_states, batches, cam_idxs,
                       table_Ts, table_Rs, fixed_idxs, it: int, drop_maxes, train_poses,
                       first_frames, grad_params: bool = True, param_grad_gate=None,
                       xyz_lr_mult=None, opt_cfg=None, coarse_cfg=None, backend: str = "cuda",
                       tile_config=None, crop: bool = False, crop_maxes=None,
                       count_advance=None, live=None, scenes=None):
    """The stage-2 iteration for S scenes at once (the body of JAX's
    `_coarse_body` vmapped): each scene's learning rates from its own
    flags and spatial_lr_scale (times xyz_lr_mult), the shared pose-rate
    choreography and densify-statistics gate (it > warm_up), the fixed
    accumulated transform gathered from each scene's identity-prefixed
    tables at fixed_idxs + 1. `grad_params` (a Python bool) is the OR over
    the scenes of `first_frame or it >= warm_up`; the scenes whose own
    value is off get their parameter gradients zeroed in the Adam update
    (`param_grad_gate`, computed here when None and grad_params is set).
    `count_advance` [S] advances each scene's Adam count first (its elided
    warm-up no-ops); `live` [S] bool keeps every scene that is off
    (elided this iteration) bit for bit. `scenes` picks the rows of a
    stacked FrameBatch holding more scenes than the step. Returns
    (models, opt_states, poses, pose_opt_states, loss [S], radii,
    drop_maxes [S], crop_maxes)."""
    from egogaussian_tpu_torch.parallel.multi_scene import place_lrs, scene_lrs
    from egogaussian_tpu_torch.parallel.scene_trainer import _select

    cp = coarse_cfg
    s_n = models.params.xyz.shape[0]
    dev = models.device
    tp = _scene_flags(train_poses, s_n)
    ff = _scene_flags(first_frames, s_n)
    old = (models, opt_states, poses, pose_opt_states, drop_maxes, crop_maxes)
    if count_advance is not None and any(count_advance):
        adv = torch.as_tensor([int(c) for c in count_advance], dtype=opt_states.count.dtype,
                              device=dev).reshape(opt_states.count.shape)
        opt_states = dataclasses.replace(opt_states, count=opt_states.count + adv)
    scales = models.spatial_lr_scale
    scales = scales if isinstance(scales, tuple) else (scales,) * s_n
    lr_tree = place_lrs(scene_lrs([
        _coarse_lr_tree(dataclasses.replace(models, spatial_lr_scale=sc), it, opt_cfg, cp, f)
        for sc, f in zip(scales, ff)]), dev)
    if xyz_lr_mult is not None:
        lr_tree["xyz"] = lr_tree["xyz"] * torch.as_tensor(xyz_lr_mult, dtype=torch.float32,
                                                          device=dev)
    plr_t, plr_r = _coarse_pose_lrs(it, opt_cfg, cp)
    if param_grad_gate is None and grad_params:
        own = [f or it >= cp.warm_up_iter for f in ff]
        param_grad_gate = None if all(own) else [1.0 if o else 0.0 for o in own]
    rows = torch.as_tensor(fixed_idxs, dtype=torch.int64, device=dev).reshape(-1) + 1
    s_idx = torch.arange(s_n, device=dev)
    out = pose_scenes_step(
        models, opt_states, poses, pose_opt_states, batches,
        torch.as_tensor(cam_idxs, dtype=torch.int64, device=dev).reshape(-1),
        table_Ts[s_idx, rows], table_Rs[s_idx, rows], lr_tree, plr_t, plr_r,
        it > cp.warm_up_iter, drop_maxes, tp,
        lambda_image=cp.lambda_image, lambda_dssim=cp.lambda_dssim,
        lambda_l1_alpha=cp.lambda_Ll1_alpha, lambda_l2_alpha=cp.lambda_Ll2_alpha,
        backend=backend, caps=tile_config, grad_params=grad_params,
        param_grad_gate=param_grad_gate, crop=crop,
        crop_max=crop_maxes if crop_maxes is not None else 0, scenes=scenes)
    if live is not None and not all(live):
        sel = torch.as_tensor(list(live), device=dev)
        kept = [_select(sel, a, b) if b is not None else a for a, b in
                zip((out[0], out[1], out[2], out[3], out[6], out[7]), old)]
        out = (kept[0], kept[1], kept[2], kept[3], out[4], out[5], kept[4], kept[5])
    return out


def coarse_step_traced(model, opt_state, pose, pose_opt_state, batch, cam_idx, table_T,
                       table_R, fixed_idx, it, drop_max, train_pose, first_frame,
                       grad_params: bool = True, param_grad_gate=None, xyz_lr_mult=None,
                       opt_cfg=None, coarse_cfg=None, backend: str = "tiled",
                       tile_config=None):
    """`coarse_step` with train_pose / first_frame as per-call values (bools
    or 0-d bool tensors, the latter read on the host) rather than fixed
    arguments, as JAX's traced form, which the lockstep needs: every
    scene's flags differ per iteration. `grad_params` selects whether the
    parameter backward exists at all; `param_grad_gate` (0 / 1) zeroes the
    parameter gradients inside the same Adam update (moments and count then
    match the grad_params=False path, where zero rates alone would not);
    `xyz_lr_mult` scales the xyz rate. No crop window (JAX's has none).
    Returns (model, opt_state, pose, pose_opt_state, loss, radii,
    drop_max). The one-scene case of coarse_scenes_step."""
    from egogaussian_tpu_torch.parallel.multi_scene import stack_scenes, unstack_scenes

    dev = model.device
    gate = None if param_grad_gate is None else [float(param_grad_gate)]
    mult = None if xyz_lr_mult is None else torch.as_tensor(xyz_lr_mult,
                                                            dtype=torch.float32).reshape(1)
    m, o, p, po, loss, radii, drop, _ = coarse_scenes_step(
        stack_scenes([model]), stack_scenes([opt_state]), stack_scenes([pose]),
        stack_scenes([pose_opt_state]), stack_scenes([batch]), [int(cam_idx)],
        table_T[None], table_R[None], [int(fixed_idx)], int(it),
        torch.as_tensor(drop_max, device=dev).reshape(1), [bool(train_pose)],
        [bool(first_frame)], grad_params, param_grad_gate=gate if grad_params else None,
        xyz_lr_mult=mult, opt_cfg=opt_cfg, coarse_cfg=coarse_cfg, backend=backend,
        tile_config=_one_caps(model, batch, tile_config, None))
    (m,), (o,), (p,), (po,) = (unstack_scenes(x, 1) for x in (m, o, p, po))
    return m, o, p, po, loss[0], radii[0], drop[0].reshape(torch.as_tensor(drop_max).shape)


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
    residue of that many elided warm-up no-op iterations. The one-scene
    case of coarse_scenes_step (with grad_params as given: a scene of its
    own is never gated)."""
    from egogaussian_tpu_torch.parallel.multi_scene import stack_scenes, unstack_scenes

    dev = model.device
    crop = crop_size is not None
    m, o, p, po, loss, radii, drop, cmax = coarse_scenes_step(
        stack_scenes([model]), stack_scenes([opt_state]), stack_scenes([pose]),
        stack_scenes([pose_opt_state]), stack_scenes([batch]), [int(cam_idx)],
        table_T[None], table_R[None], [int(fixed_idx)], it, drop_max.reshape(1),
        [bool(train_pose)], [bool(first_frame)], grad_params, param_grad_gate=None,
        opt_cfg=opt_cfg, coarse_cfg=coarse_cfg, backend=backend,
        tile_config=_one_caps(model, batch, tile_config, crop_size), crop=crop,
        crop_maxes=torch.as_tensor(crop_max, dtype=torch.int32, device=dev)[None] if crop
        else None, count_advance=[count_advance] if count_advance else None)
    (m,), (o,), (p,), (po,) = (unstack_scenes(x, 1) for x in (m, o, p, po))
    return (m, o, p, po, loss[0], radii[0], drop[0].reshape(drop_max.shape),
            cmax[0] if crop else cmax)


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
    from egogaussian_tpu_torch.parallel.scene_trainer import CoarseSceneInput, train_coarse_scenes

    scene = CoarseSceneInput(cameras, obj_model, static_phase_frames, dynamic_phase_frames,
                             cameras_extent, save_dir=save_dir, seed=seed,
                             densify_noise=densify_noise)
    hook = None if on_step is None else (lambda s, f, it, loss: on_step(f, it, loss))
    return train_coarse_scenes([scene], cfg, backend=backend, checkpoint_every=checkpoint_every,
                               skip_noop_warmup=skip_noop_warmup, device=device,
                               on_step=hook)[0]
