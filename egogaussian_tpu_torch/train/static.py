"""Stage 1.0: static-phase training.

Port of `train_static` from `egogaussian_tpu/train/static.py` (the twin of
reference `trainers/train_static.py:16-207`). Per static phase, from the
point cloud:
    iters 1..std:            0.8*L1 + 0.2*(1-SSIM), hand-grad-masked
    iters std..std+entropy:  + 0.1 * opacity entropy of visible Gaussians
      (then prune opacity < 0.5 and shrink to `rewind_frames` frames)
    iters ..+label:          BCE(label render, obj mask), every LR zero
      except the label's
densify/prune every `densification_interval` iters in
(densify_from_iter, densify_until_iter], opacity reset every
`opacity_reset_interval`. Outputs: full/object/background PLYs and the
predicted object masks rendered from the thresholded label.

The loop reads nothing back from the device between densify intervals:
losses, dropped-pair counts and statistics stay device tensors until an
interval's host sync.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from egogaussian_tpu_torch.config import Config
from egogaussian_tpu_torch.data.readers import FrameBatch, stack_cameras
from egogaussian_tpu_torch.models.densify import (
    densify_and_prune,
    prune_by_opacity,
    reset_opacity,
)
from egogaussian_tpu_torch.models.gaussians import (
    GaussianModel,
    GaussianParams,
    ensure_capacity,
    from_points,
    save_ply,
    split_by_is_object,
)
from egogaussian_tpu_torch.models.optim import adam_init, adam_update, gaussian_lr_tree
from egogaussian_tpu_torch.ops.losses import bce_with_logits
from egogaussian_tpu_torch.render.api import render
from egogaussian_tpu_torch.train.common import (
    auto_tile_config,
    image_loss,
    mask_grad,
    maybe_regrow_tile_config,
    opacity_entropy,
    pick_backend,
    render_gaussians,
    render_label_image,
)
from egogaussian_tpu_torch.utils.console import CONSOLE
from egogaussian_tpu_torch.utils.logging import log_metrics


def _frames_loss_grads(model, batch, fidxs, grad_masks, mode, lambda_dssim,
                       backend, tile_config, bg):
    """Gradient of the MEAN loss over frames `fidxs` w.r.t. the params and
    the per-frame means2d probes. Returns (param grads, probe grads
    [K, C, 2], losses [K], radii [K, C], dropped [K])."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in model.params.as_dict().items()}
    m = dataclasses.replace(model, params=GaussianParams(**leaves))
    probes = [torch.zeros((model.capacity, 2), device=model.device, requires_grad=True)
              for _ in fidxs]
    losses, radii, dropped = [], [], []
    for k, f in enumerate(fidxs):
        cam, gt, _, obj_mask = batch.frame(f)
        grad_mask = FrameBatch.decode_mask(grad_masks[f])
        if mode == "label":
            # one render: the label as the color channel with detached
            # geometry; its radii are the visibility filter
            res = render(
                cam, m.params.xyz.detach(), m.covariance().detach(), m.opacity.detach(),
                bg=torch.zeros((1,), device=model.device),
                colors_precomp=m.params.label, valid_mask=m.aux.alive,
                backend=backend, tile_config=tile_config,
            )
            loss = bce_with_logits(mask_grad(res.image, grad_mask), obj_mask)
        else:
            res = render_gaussians(m, cam, bg, means2d_probe=probes[k],
                                   backend=backend, tile_config=tile_config)
            loss = image_loss(mask_grad(res.image, grad_mask), gt, lambda_dssim)
            if mode == "entropy":
                loss = loss + 0.1 * opacity_entropy(m.params.opacity_logit[:, 0], res.radii > 0)
        losses.append(loss)
        radii.append(res.radii)
        dropped.append(res.dropped_pairs)
    losses = torch.stack(losses)
    inputs = list(leaves.values()) + (probes if mode != "label" else [])
    grads = torch.autograd.grad(torch.mean(losses), inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
    param_grads = GaussianParams(**dict(zip(leaves, grads[:len(leaves)])))
    if mode == "label":
        probe_grads = torch.zeros((len(fidxs), model.capacity, 2), device=model.device)
    else:
        probe_grads = torch.stack(grads[len(leaves):])
    return (param_grads, probe_grads, losses.detach(), torch.stack(radii),
            torch.stack(dropped))


def _probe_stats(batch, probe_grads, radii, undo_mean_k):
    """Densification statistics of a frame set, reduced over frames. The
    probe is in pixels and the reference accumulates NDC-scaled gradients
    (W/2, H/2); undo_mean_k undoes the 1/K of the mean loss so each frame
    contributes what a standalone reference iteration would."""
    ndc_scale = torch.tensor([batch.width * 0.5, batch.height * 0.5],
                             dtype=probe_grads.dtype, device=probe_grads.device)
    g = probe_grads * (ndc_scale * undo_mean_k)
    gnorm = torch.sqrt(torch.sum(g * g, dim=-1))  # [K, C]
    visible = radii > 0
    zero = torch.zeros_like(gnorm)
    gn_sum = torch.sum(torch.where(visible, gnorm, zero), dim=0)
    den_sum = torch.sum(visible.to(torch.float32), dim=0)
    rad_max = torch.amax(torch.where(visible, radii.to(torch.float32), zero), dim=0)
    return gn_sum, den_sum, rad_max


def _static_lr_tree(model, it, opt_cfg, mode, label_lr):
    if mode == "label":
        lrs = gaussian_lr_tree(it, opt_cfg, model.spatial_lr_scale, zero_gaussians=True)
        return dict(lrs, label=float(np.float32(label_lr)))
    return gaussian_lr_tree(it, opt_cfg, model.spatial_lr_scale, label_lr=0.0)


def _static_step(model, opt_state, batch, fidxs, grad_masks, it, drop_max,
                 mode="std", lambda_dssim=0.2, backend="auto", tile_config=None,
                 bg_color=None, opt_cfg=None, label_lr=0.0):
    """One training iteration over frames `fidxs` (a list of K indices; the
    photometric gradient is the mean over them). mode in {std, entropy,
    label}. Returns (model, opt_state, loss, radii [K, C], drop_max), all
    device tensors."""
    lr_tree = _static_lr_tree(model, it, opt_cfg, mode, label_lr)
    bg = (torch.zeros(3, device=model.device) if bg_color is None
          else torch.as_tensor(bg_color, device=model.device))
    param_grads, probe_grads, losses, radii, dropped = _frames_loss_grads(
        model, batch, fidxs, grad_masks, mode, lambda_dssim, backend, tile_config, bg)
    gn, den, rmax = _probe_stats(batch, probe_grads, radii, len(fidxs))
    aux = dataclasses.replace(
        model.aux,
        xyz_gradient_accum=model.aux.xyz_gradient_accum + gn,
        denom=model.aux.denom + den,
        max_radii2d=torch.maximum(model.aux.max_radii2d, rmax),
    )
    with torch.no_grad():
        new_params, new_opt = adam_update(model.params, param_grads, opt_state, lr_tree)
    model = dataclasses.replace(model, params=new_params, aux=aux)
    return (model, new_opt, torch.mean(losses), radii,
            torch.maximum(drop_max, torch.amax(dropped)))


def _log_dropped_pairs(stage: str, phase, drop_max) -> None:
    """End-of-phase report of the worst binning-capacity pair loss."""
    d = int(drop_max)
    tag = f"[{stage}] phase {phase}" if phase is not None else f"[{stage}]"
    if d:
        CONSOLE.log(
            f"{tag}: WARNING — up to {d} pairs/render dropped by binning "
            "capacities (raise TileConfig.max_pairs/max_per_tile or the "
            "auto_tile_config headroom)")
    else:
        CONSOLE.log(f"{tag}: 0 pairs dropped by binning capacities")


@dataclasses.dataclass
class StaticPhaseResult:
    model: GaussianModel  # full model after the phase (is_object inferred)
    obj_model: GaussianModel  # object-only
    bg_model: GaussianModel  # background-only
    pred_masks: Dict[str, np.ndarray]  # image_name -> [H, W] binary label
    dropped_pairs: int  # worst per-render binning drop of the last baseline


def _label_stack(stack, phase, n_phases, rewind, mask_valid):
    """Label-phase frame subset: the reference's rewind window
    (train_static.py:152-162) restricted to frames whose object mask was
    shipped (BCE against a missing, all-zero mask trains labels to zero)."""
    if phase == 0:
        stack = stack[-rewind:]
    elif phase == n_phases - 1:
        stack = stack[:rewind]
    else:
        stack = stack[:rewind] + stack[-rewind:]
    valid = [i for i in stack if mask_valid[i]]
    if valid:
        return valid
    valid = [i for i in range(len(mask_valid)) if mask_valid[i]]
    return valid or stack


def train_static(
    cameras: Sequence,
    points: np.ndarray,
    colors: np.ndarray,
    cfg: Config,
    static_phase_frames: List[List[int]],
    cameras_extent: float,
    save_dir: Optional[str] = None,
    seed: int = 0,
    backend: str = "auto",
    first_phase_only: bool = False,
    checkpoint_every: int = 0,
    mesh=None,
    device: Optional[torch.device] = None,
    on_step: Optional[Callable[[int, str, torch.Tensor], None]] = None,
) -> List[StaticPhaseResult]:
    """Stage 1.0. `static_phase_frames`: per-phase lists of camera indices
    (data.readers.split_viewpoints_by_phase). `device`: where the model,
    frames and kernels run. `on_step(it, mode, loss)`: optional observer
    called after every iteration with the loss as a device scalar.

    Not ported yet: mid-stage checkpoints (checkpoint_every > 0) and
    frame-data-parallel meshes (mesh)."""
    if device is None:
        raise ValueError("train_static needs an explicit device")
    if checkpoint_every > 0:
        raise NotImplementedError("mid-stage checkpoints are not ported yet")
    if mesh is not None:
        raise NotImplementedError("frame-data-parallel training is not ported yet")
    # float32 throughout: cuDNN would run the SSIM convolutions in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    rng = np.random.RandomState(seed)
    sp = cfg.static
    opt_cfg = cfg.opt
    total_iters = sp.std_train_iter + sp.entropy_reg_iter + sp.label_train_iter
    results: List[StaticPhaseResult] = []

    for phase, frame_idxs in enumerate(static_phase_frames):
        phase_cams = [cameras[i] for i in frame_idxs]
        batch = stack_cameras(phase_cams, device)
        model = from_points(points, colors, device, sh_degree=cfg.model.sh_degree,
                            spatial_lr_scale=cameras_extent, seed=seed)
        opt_state = adam_init(model.params)
        tile_cfg = auto_tile_config(model, batch.camera(0), tile_size=cfg.render.tile_size)
        backend = pick_backend(tile_cfg, backend)
        gen = torch.Generator().manual_seed(seed + phase)  # densify split seeds

        stack = list(range(len(phase_cams)))
        mask_valid = batch.obj_mask_valid
        CONSOLE.log(f"[static] phase {phase}: {len(phase_cams)} frames, "
                    f"{total_iters} iters, capacity {model.capacity}")
        drop_max = torch.zeros((), dtype=torch.int64, device=device)
        last_drop = 0
        fb = max(1, sp.frame_batch)
        for it in range(1, total_iters + 1):
            if fb == 1:
                fidxs = [stack[rng.randint(len(stack))]]
            else:
                fidxs = [stack[i] for i in rng.randint(len(stack), size=fb)]
            if it <= sp.std_train_iter:
                mode = "std"
            elif it <= sp.std_train_iter + sp.entropy_reg_iter:
                mode = "entropy"
            else:
                mode = "label"
            bg_color = rng.rand(3).astype(np.float32) if opt_cfg.random_background else None
            model, opt_state, loss, _, drop_max = _static_step(
                model, opt_state, batch, fidxs, batch.hand_masks, it, drop_max,
                mode=mode, lambda_dssim=opt_cfg.lambda_dssim, backend=backend,
                tile_config=tile_cfg, bg_color=bg_color, opt_cfg=opt_cfg,
                label_lr=sp.label_lr,
            )
            if on_step is not None:
                on_step(it, mode, loss)

            # drop-triggered capacity regrowth at the interval host sync
            if it % opt_cfg.densification_interval == 0:
                tile_cfg, last_drop, changed = maybe_regrow_tile_config(
                    model, batch.camera(0), tile_cfg, drop_max, last_drop, "static")
                if changed:  # new baseline: re-arm the running-max counter
                    drop_max, last_drop = torch.zeros_like(drop_max), 0
                log_metrics("static", it, phase=phase, mode=mode, loss=loss,
                            alive=model.num_alive, capacity=model.capacity,
                            dropped_pairs=drop_max)

            # densification schedule (train_static.py:125-133)
            if it <= sp.densify_until_iter:
                if it > sp.densify_from_iter and it % opt_cfg.densification_interval == 0:
                    size_threshold = 20.0 if it > opt_cfg.opacity_reset_interval else None
                    sub_seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
                    res = densify_and_prune(
                        model, opt_state, sub_seed,
                        max_grad=opt_cfg.densify_grad_threshold,
                        min_opacity=0.005,
                        extent=cameras_extent,
                        max_screen_size=size_threshold,
                        percent_dense=opt_cfg.percent_dense,
                    )
                    model, opt_state = res.model, res.opt_state
                    overflow = int(res.overflow)
                    if overflow:
                        CONSOLE.log(f"[static] it {it}: densify overflow — {overflow} "
                                    "candidates dropped (capacity grows next interval)")
                    model, opt_state, grew = ensure_capacity(model, opt_state)
                    if grew:
                        tile_cfg = auto_tile_config(model, batch.camera(0),
                                                    tile_size=cfg.render.tile_size)
                if it % opt_cfg.opacity_reset_interval == 0:
                    model, opt_state = reset_opacity(model, opt_state)

            # entropy-phase end: prune + rewind (train_static.py:146-162)
            if it == sp.std_train_iter + sp.entropy_reg_iter:
                model, opt_state, n_pruned = prune_by_opacity(model, opt_state, min_opacity=0.5)
                CONSOLE.log(f"[static] pruned {int(n_pruned)} low-opacity; "
                            f"alive {int(model.num_alive)}")
                stack = _label_stack(stack, phase, len(static_phase_frames),
                                     sp.rewind_frames, mask_valid)

        _log_dropped_pairs("static", phase, drop_max)
        model = model.infer_is_object_from_label()
        obj_model, bg_model = split_by_is_object(model)

        pred_masks: Dict[str, np.ndarray] = {}
        with torch.no_grad():
            for j, cam_obj in enumerate(phase_cams):
                lbl = render_label_image(model, batch.camera(j), backend=backend,
                                         tile_config=tile_cfg)
                pred_masks[cam_obj.image_name] = (lbl[0] > 0.5).to(torch.float32).cpu().numpy()

        if save_dir:
            ply_dir = os.path.join(save_dir, "ply")
            save_ply(model, os.path.join(ply_dir, f"static_phase{phase}.ply"))
            save_ply(obj_model, os.path.join(ply_dir, f"static_phase{phase}_obj.ply"))
            save_ply(bg_model, os.path.join(ply_dir, f"static_phase{phase}_bg.ply"))
            mask_dir = os.path.join(save_dir, "obj_masks")
            os.makedirs(mask_dir, exist_ok=True)
            try:
                from PIL import Image
            except ImportError:
                Image = None
            if Image is not None:
                for name, msk in pred_masks.items():
                    Image.fromarray((msk * 255).astype(np.uint8)).save(
                        os.path.join(mask_dir, f"{name}.png"))

        results.append(StaticPhaseResult(
            model=model, obj_model=obj_model, bg_model=bg_model,
            pred_masks=pred_masks, dropped_pairs=int(drop_max),
        ))
        if first_phase_only:
            break
    return results
