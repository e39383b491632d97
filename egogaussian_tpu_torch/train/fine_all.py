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
from typing import List, Optional, Sequence

import torch

from egogaussian_tpu_torch.config import Config
from egogaussian_tpu_torch.models.densify import reset_opacity
from egogaussian_tpu_torch.models.gaussians import GaussianModel, GaussianParams
from egogaussian_tpu_torch.models.optim import adam_update
from egogaussian_tpu_torch.models.pose import PoseSequence
from egogaussian_tpu_torch.train.common import image_loss, mask_grad
from egogaussian_tpu_torch.train.fine_obj import _fine_lr_tree


def fine_all_scenes_step(models, opt_states, batches, cam_idxs, accum_Ts, accum_Rs, it: int,
                         clamp_opacity: bool, drop_maxes, lambda_dssim: float = 0.2,
                         backend: str = "cuda", tile_config=None, opt_cfg=None,
                         xyz_lr_mult=None, scenes=None):
    """One stage-5 iteration for S scenes at once: scene s renders frame
    cam_idxs[s] at its frozen accumulated pose (accum_Ts [S, F, 4, 4],
    accum_Rs [S, F, 3, 3]) with train_fine_all_setup's learning rates from
    its own spatial_lr_scale (stage 3's without the dividers, times
    xyz_lr_mult), then the opacity clamp when `clamp_opacity` (the shared
    schedule's). `tile_config`: a render/tiled.py SceneCaps. Returns
    (models, opt_states, loss [S], drop_maxes [S]), device tensors."""
    from egogaussian_tpu_torch.parallel.multi_scene import place_lrs, scene_frames, scene_lrs
    from egogaussian_tpu_torch.render.api import render_scenes
    from egogaussian_tpu_torch.render.project import rigid_apply
    from egogaussian_tpu_torch.train.common import model_colors

    s_n = models.params.xyz.shape[0]
    dev = models.device
    cam = torch.as_tensor(cam_idxs, dtype=torch.int64, device=dev).reshape(-1)
    cams, gt, hand, _ = scene_frames(batches, cam, scenes)
    s_idx = torch.arange(s_n, device=dev)
    T, R = accum_Ts[s_idx, cam], accum_Rs[s_idx, cam]
    leaves = {k: v.detach().requires_grad_(True) for k, v in models.params.as_dict().items()}
    m = dataclasses.replace(models, params=GaussianParams(**leaves))
    obj = (m.aux.is_object == 1)[..., None]
    xyz = torch.where(obj, rigid_apply(m.params.xyz, T[..., :3, :3], T[..., :3, 3],
                                       m.scene_rows), m.params.xyz)
    res = render_scenes(cams, xyz, m.covariance_rotated(R, 1), m.opacity,
                        torch.zeros((s_n, 3), device=dev), model_colors(m), tile_config,
                        valid_mask=m.aux.alive, backend=backend)
    loss = image_loss(mask_grad(res.image, hand), gt, lambda_dssim)
    grads = torch.autograd.grad(loss.sum(), list(leaves.values()), allow_unused=True)
    grads = GaussianParams(**{k: torch.zeros_like(x) if g is None else g
                              for (k, x), g in zip(leaves.items(), grads)})
    scales = models.spatial_lr_scale
    scales = scales if isinstance(scales, tuple) else (scales,) * s_n
    lr_tree = place_lrs(scene_lrs([
        _fine_lr_tree(dataclasses.replace(models, spatial_lr_scale=sc), it, opt_cfg,
                      divide_3dgs=1.0) for sc in scales]), dev)
    if xyz_lr_mult is not None:
        lr_tree["xyz"] = lr_tree["xyz"] * torch.as_tensor(xyz_lr_mult, dtype=torch.float32,
                                                          device=dev)
    with torch.no_grad():
        new_params, opt_states = adam_update(models.params, grads, opt_states, lr_tree)
        models = dataclasses.replace(models, params=new_params)
        if clamp_opacity:
            models, opt_states = reset_opacity(models, opt_states)
        drop_maxes = torch.maximum(drop_maxes, res.dropped_pairs.to(drop_maxes.dtype))
    return models, opt_states, loss.detach(), drop_maxes


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
    from egogaussian_tpu_torch.parallel.scene_trainer import (
        FineAllSceneInput,
        train_fine_all_scenes,
    )

    scene = FineAllSceneInput(cameras, obj_model, bg_model, pose_seq, static_phase_frames,
                              dynamic_phase_frames, save_dir=save_dir, seed=seed)
    return train_fine_all_scenes([scene], cfg, backend=backend,
                                 checkpoint_every=checkpoint_every, device=device)[0]
