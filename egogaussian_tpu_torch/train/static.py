"""Stage 1.0 (static phases) and stage 1.2 (background) trainers.

Port of `train_static` and `train_background` from
`egogaussian_tpu/train/static.py` (the twins of reference
`trainers/train_static.py:16-207` and `trainers/train_static_bg.py:23-173`).
Stage 1.0, per static phase, from the point cloud:
    iters 1..std:            0.8*L1 + 0.2*(1-SSIM), hand-grad-masked
    iters std..std+entropy:  + 0.1 * opacity entropy of visible Gaussians
      (then prune opacity < 0.5 and shrink to `rewind_frames` frames)
    iters ..+label:          BCE(label render, obj mask), every LR zero
      except the label's
densify/prune every `densification_interval` iters in
(densify_from_iter, densify_until_iter], opacity reset every
`opacity_reset_interval`. Outputs: full/object/background PLYs and the
predicted object masks rendered from the thresholded label.

Stage 1.2: the same std + entropy loop over every phase's training frames
at once, gated by the interaction mask dilate(hand | obj, 5 px), no label
phase, and a final prune of opacity < 0.5. Output: the background PLY.

The loops read nothing back from the device between densify intervals:
losses, dropped-pair counts and statistics stay device tensors until an
interval's host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from egogaussian_tpu_torch.config import Config
from egogaussian_tpu_torch.models.gaussians import GaussianModel
from egogaussian_tpu_torch.models.optim import gaussian_lr_tree
from egogaussian_tpu_torch.utils.console import CONSOLE


def _one(x):
    """The one-scene stack of x (views)."""
    from egogaussian_tpu_torch.parallel.multi_scene import stack_scenes

    return stack_scenes([x])


def _caps_of(model, batch, tile_config):
    from egogaussian_tpu_torch.render.tiled import scene_caps

    return scene_caps([tile_config], [(batch.width, batch.height)], model.device,
                      model.capacity)


def _frames_loss_grads(model, batch, fidxs, grad_masks, mode, lambda_dssim,
                       backend, tile_config, bg):
    """Gradient of the MEAN loss over frames `fidxs` w.r.t. the params and
    the per-frame means2d probes. Returns (param grads, probe grads
    [K, C, 2], losses [K], radii [K, C], dropped [K]). The one-scene case
    of parallel/multi_scene.py's."""
    from egogaussian_tpu_torch.parallel import multi_scene as ms

    fidx = torch.as_tensor(list(fidxs), dtype=torch.int64, device=model.device)[None]
    pg, probe, losses, radii, dropped = ms._frames_loss_grads(
        _one(model), _one(batch), fidx, grad_masks[None], mode, lambda_dssim,
        backend, _caps_of(model, batch, tile_config), bg[None])
    return (pg.map(lambda x: x[0]), probe[:, 0], losses[:, 0], radii[:, 0], dropped[:, 0])


def _static_lr_tree(model, it, opt_cfg, mode, label_lr):
    if mode == "label":
        lrs = gaussian_lr_tree(it, opt_cfg, model.spatial_lr_scale, zero_gaussians=True)
        return dict(lrs, label=float(np.float32(label_lr)))
    return gaussian_lr_tree(it, opt_cfg, model.spatial_lr_scale, label_lr=0.0)


def _static_step(model, opt_state, batch, fidxs, grad_masks, it, drop_max,
                 mode="std", lambda_dssim=0.2, backend="tiled", tile_config=None,
                 bg_color=None, opt_cfg=None, label_lr=0.0):
    """One training iteration over frames `fidxs` (a list of K indices; the
    photometric gradient is the mean over them). mode in {std, entropy,
    label}. Returns (model, opt_state, loss, radii [K, C], drop_max), all
    device tensors. The one-scene case of
    parallel/multi_scene.py:multi_scene_static_step."""
    return _dp_static_step(model, opt_state, batch, fidxs, grad_masks, it, drop_max,
                           mesh=None, mode=mode, lambda_dssim=lambda_dssim, backend=backend,
                           tile_config=tile_config, bg_color=bg_color, opt_cfg=opt_cfg,
                           label_lr=label_lr)


def _dp_static_step(model, opt_state, batch, fidxs, grad_masks, it, drop_max, mesh=None,
                    mode="std", lambda_dssim=0.2, backend="tiled", tile_config=None,
                    bg_color=None, opt_cfg=None, label_lr=0.0, axis="data"):
    """Frame-data-parallel `_static_step` (JAX's `_dp_static_step`): the
    K frames `fidxs` (K a multiple of the axis size; every rank passes the
    same list) are cut into equal contiguous blocks, and rank d of the
    mesh's `axis` runs the real per-frame body on block d. The parameter
    gradients and the loss are the mean of the ranks' local means; the
    densification sums (grad-norm accumulator, visibility counts) are
    summed and the max screen radius and dropped pairs max-reduced, so the
    statistics equal K sequential reference iterations. Every reduced
    tensor goes in one flat buffer through one all_gather, and each rank
    reduces the blocks in rank order itself: every replica gets the same
    bits, and Adam then runs replicated. Returns (model, opt_state, loss,
    this rank's radii [K / n, C], drop_max). On a one-rank axis (or
    mesh=None) it gives `_static_step`'s bits. The one-scene case of
    multi_scene_static_step."""
    from egogaussian_tpu_torch.parallel.multi_scene import multi_scene_static_step, unstack_scenes

    fidx = torch.as_tensor(list(fidxs), dtype=torch.int64, device=model.device)[None]
    bg = None if bg_color is None else torch.as_tensor(bg_color, device=model.device)[None]
    m, opt, loss, radii, drop = multi_scene_static_step(
        _one(model), _one(opt_state), _one(batch), fidx, grad_masks[None], it,
        drop_max.reshape(1), mesh=mesh, mode=mode, lambda_dssim=lambda_dssim, backend=backend,
        tile_config=_caps_of(model, batch, tile_config), opt_cfg=opt_cfg, label_lr=label_lr,
        bg_colors=bg, axis=axis)
    (m,), (opt,) = unstack_scenes(m, 1), unstack_scenes(opt, 1)
    return m, opt, loss[0], radii[:, 0], drop[0].reshape(drop_max.shape)


def _dp_frame_batch(fb: int, mesh) -> int:
    """Frames per step: at least 1 and, on a mesh, a multiple of the data
    axis size (one frame per rank at least)."""
    fb = max(1, fb)
    if mesh is None:
        return fb
    n = mesh.shape["data"]
    return (fb + n - 1) // n * n


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
    frames and kernels run; None means the card (`cuda`), as in JAX, which
    runs on its default device. `on_step(it, mode, loss)`: optional observer
    called after every iteration with the loss as a device scalar.
    `checkpoint_every` > 0 (with save_dir): every that many iterations the
    phase's state goes to save_dir/ckpt_static_phase{phase}.npz, and a
    phase whose file exists resumes from it (train/ckpt_hook.py).

    `mesh` (parallel/mesh.py): the frame batch is sharded over the data
    axis (_dp_static_step; frame_batch raised to a multiple of its size).
    Every rank of the scene row draws the same frames and noise from the
    same seeds, densifies, prunes and regrows from the same reduced
    tensors, so the replicas stay identical; rank (s, 0) alone writes the
    PLYs, masks and checkpoints, and the row waits at a barrier after
    each write. `device` then defaults to mesh.device."""
    from egogaussian_tpu_torch.parallel.scene_trainer import SceneInput, train_static_scenes

    scene = SceneInput(cameras, points, colors, static_phase_frames, cameras_extent,
                       save_dir=save_dir, seed=seed)
    step_hook = None if on_step is None else (lambda s, it, mode, loss: on_step(it, mode, loss))
    return train_static_scenes([scene], cfg, backend=backend, first_phase_only=first_phase_only,
                               checkpoint_every=checkpoint_every, mesh=mesh, device=device,
                               on_step=step_hook)[0]


def train_background(
    cameras: Sequence,
    points: np.ndarray,
    colors: np.ndarray,
    cfg: Config,
    train_frame_idxs: List[int],
    cameras_extent: float,
    save_dir: Optional[str] = None,
    seed: int = 0,
    backend: str = "auto",
    dilate_size: int = 5,
    checkpoint_every: int = 0,
    mesh=None,
    device: Optional[torch.device] = None,
    densify_noise: Optional[Callable[[int], torch.Tensor]] = None,
) -> GaussianModel:
    """Stage 1.2: the background over all phases' frames `train_frame_idxs`
    with the interaction mask dilate(hand | obj, dilate_size) gating the
    gradients. `device`: None means the card (`cuda`).
    `densify_noise(capacity)`: optional [2, C, 3] split noise for each
    densify call, in order (tests inject the JAX draw); by default the
    port's split_noise with seeds from a generator seeded `seed`. Ends with
    a metrics record event="stage_end" (steps, dropped_pairs). Raises
    ValueError when a training frame has no hand or object mask (stage 1.1
    completes the object masks of static frames only). `checkpoint_every`
    > 0 (with save_dir): the state goes to save_dir/ckpt_bg.npz every that
    many iterations, and a run whose file exists resumes from it.
    `mesh`: frame-data-parallel over its data axis, as train_static's;
    rank (s, 0) alone writes the checkpoints and the PLY."""
    from egogaussian_tpu_torch.parallel.scene_trainer import SceneInput, train_background_scenes

    scene = SceneInput(cameras, points, colors, [], cameras_extent, save_dir=save_dir, seed=seed,
                       train_frame_idxs=list(train_frame_idxs), densify_noise=densify_noise)
    return train_background_scenes([scene], cfg, backend=backend, dilate_size=dilate_size,
                                   checkpoint_every=checkpoint_every, mesh=mesh,
                                   device=device)[0]
