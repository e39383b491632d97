"""Stage 5: fine-tuning of the whole scene, object and background together.

Port of `egogaussian_tpu/train/fine_all.py` (the twin of reference
`trainers/fine_all.py:25-138`): the object and background PLYs combined
into one model; the poses frozen (each frame renders at its accumulated
transform, built once); the full-frame 0.8 L1 + 0.2 (1 - SSIM) loss with
hand-mask gradient gating only; dynamic frames sampled 4:1; no
densification, only the reference's opacity clamp on iterations inside
(densify_from, densify_until) that are not multiples of
opacity_reset_interval (fine_all.py:121-124), which keeps opacities
<= 0.01 through that window.

The loop reads nothing back from the device between logging intervals and
checkpoint saves.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from egogaussian_tpu_torch.config import Config
from egogaussian_tpu_torch.data.readers import stack_cameras
from egogaussian_tpu_torch.models.densify import reset_opacity
from egogaussian_tpu_torch.models.gaussians import (
    GaussianModel,
    GaussianParams,
    combine_models,
    save_ply,
)
from egogaussian_tpu_torch.models.optim import adam_init, adam_update
from egogaussian_tpu_torch.models.pose import PoseSequence
from egogaussian_tpu_torch.train.ckpt_hook import StageCheckpointer, restore_loop
from egogaussian_tpu_torch.train.common import (
    auto_tile_config,
    image_loss,
    mask_grad,
    maybe_regrow_tile_config,
    pick_backend,
    render_gaussians,
)
from egogaussian_tpu_torch.train.fine_obj import _fine_lr_tree
from egogaussian_tpu_torch.train.static import _log_dropped_pairs
from egogaussian_tpu_torch.utils.console import CONSOLE
from egogaussian_tpu_torch.utils.logging import log_metrics


def _fine_all_step(model, opt_state, batch, cam_idx: int, accum_T, accum_R, it: int,
                   clamp_opacity: bool, drop_max, lambda_dssim: float, backend: str,
                   tile_config, opt_cfg):
    """One stage-5 iteration at the frame's frozen accumulated pose, with
    train_fine_all_setup's learning rates (stage 3's without the
    dividers), then the opacity clamp when `clamp_opacity`. Returns
    (model, opt_state, loss, drop_max), device tensors."""
    cam, gt, hand, _ = batch.frame(cam_idx)
    leaves = {k: v.detach().requires_grad_(True) for k, v in model.params.as_dict().items()}
    m = dataclasses.replace(model, params=GaussianParams(**leaves))
    res = render_gaussians(m, cam, torch.zeros(3, device=model.device),
                           pose_T=accum_T[cam_idx], extra_rot=accum_R[cam_idx],
                           backend=backend, tile_config=tile_config)
    loss = image_loss(mask_grad(res.image, hand), gt, lambda_dssim)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = GaussianParams(**{k: torch.zeros_like(x) if g is None else g
                              for (k, x), g in zip(leaves.items(), grads)})
    with torch.no_grad():
        new_params, opt_state = adam_update(model.params, grads, opt_state,
                                            _fine_lr_tree(model, it, opt_cfg, divide_3dgs=1.0))
        model = dataclasses.replace(model, params=new_params)
        if clamp_opacity:
            model, opt_state = reset_opacity(model, opt_state)
        drop_max = torch.maximum(drop_max, res.dropped_pairs.to(drop_max.dtype))
    return model, opt_state, loss.detach(), drop_max


def fine_tune_all(
    cameras: Sequence,
    obj_model: GaussianModel,
    bg_model: GaussianModel,
    pose_seq: PoseSequence,
    cfg: Config,
    static_phase_frames: List[List[int]],
    dynamic_phase_frames: List[List[int]],
    save_dir: Optional[str] = None,
    seed: int = 0,
    backend: str = "auto",
    checkpoint_every: int = 0,
    device: Optional[torch.device] = None,
) -> GaussianModel:
    """Stage 5: combine_models(obj, bg) at the object's spatial_lr_scale,
    trained at the frozen poses of `pose_seq`; writes gaussians_all.ply
    under save_dir. `device`: None means the card (`cuda`). Ends
    with a metrics record event="stage_end" (steps, dropped_pairs).
    `checkpoint_every` > 0 (with save_dir): the state goes to
    save_dir/ckpt_fine_all.npz every that many iterations, and a run whose
    file exists resumes from it. The stage does not densify, so the
    capacity is the one combine_models gives and the saved state restores
    into the freshly combined model's shapes."""
    if device is None:
        device = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    rng = np.random.RandomState(seed)
    ap = cfg.fine_all
    model = combine_models(obj_model, bg_model)
    model = dataclasses.replace(model, spatial_lr_scale=obj_model.spatial_lr_scale)
    batch = stack_cameras(list(cameras), device)

    static_list = [f for ph in static_phase_frames for f in ph]
    dynamic_list = [f for ph in dynamic_phase_frames for f in ph]
    frames = static_list + dynamic_list
    weights = np.array([1.0] * len(static_list) + [4.0] * len(dynamic_list))
    weights = weights / weights.sum()

    opt_state = adam_init(model.params)
    tile_cfg = auto_tile_config(model, batch.camera(0), tile_size=cfg.render.tile_size)
    backend = pick_backend(tile_cfg, backend)
    # the poses are frozen: accumulate once
    accum_T = pose_seq.accum_T().to(device)
    accum_R = pose_seq.accum_R().to(device)
    CONSOLE.log(f"[fine_all] {int(model.num_alive)} gaussians, {len(frames)} frames, "
                f"{ap.total_num_iter} iters")

    drop_max = torch.zeros((), dtype=torch.int64, device=device)
    last_drop = 0

    ckpt = StageCheckpointer(
        os.path.join(save_dir, "ckpt_fine_all.npz") if save_dir and checkpoint_every else None,
        checkpoint_every)
    no_gen = torch.Generator()  # the stage draws no split noise
    start_it = 0
    if ckpt.exists():
        (model, opt_state), start_it = ckpt.try_restore((model, opt_state), rng, no_gen,
                                                        "fine_all")
        loop = restore_loop(ckpt.extra, device)
        tile_cfg, drop_max, last_drop = loop["tile_cfg"], loop["drop_max"], loop["last_drop"]
        backend = pick_backend(tile_cfg, backend)
    for it in range(start_it + 1, ap.total_num_iter + 1):
        if it == 1:
            cam_idx = static_phase_frames[0][0]
        else:
            cam_idx = int(frames[rng.choice(len(frames), p=weights)])
        clamp = (ap.densify_from_iter < it < ap.densify_until_iter
                 and bool(it % ap.opacity_reset_interval))
        model, opt_state, loss, drop_max = _fine_all_step(
            model, opt_state, batch, cam_idx, accum_T, accum_R, it, clamp, drop_max,
            ap.lambda_dssim, backend, tile_cfg, cfg.opt)
        if it % ap.opacity_reset_interval == 0:
            tile_cfg, last_drop, changed = maybe_regrow_tile_config(
                model, batch.camera(0), tile_cfg, drop_max, last_drop, "fine_all")
            if changed:
                drop_max, last_drop = torch.zeros_like(drop_max), 0
            log_metrics("fine_all", it, loss=loss, alive=model.num_alive,
                        capacity=model.capacity, dropped_pairs=drop_max)
        ckpt.maybe_save(it, (model, opt_state), rng, no_gen,
                        extra=dict(tile_cfg=tile_cfg, drop_max=drop_max, last_drop=last_drop))

    _log_dropped_pairs("fine_all", None, drop_max)
    log_metrics("fine_all", ap.total_num_iter, event="stage_end", steps=ap.total_num_iter,
                dropped_pairs=drop_max)
    if save_dir:
        save_ply(model, os.path.join(save_dir, "gaussians_all.ply"))
    return model
