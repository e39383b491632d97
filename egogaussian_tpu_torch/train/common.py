"""Shared training-step machinery.

Port of `egogaussian_tpu/train/common.py`:
  * hand-mask gradient gating (the reference's
    `render_image.register_hook(lambda g: g * (1 - hand_mask))`) as
    `img*(1-m) + img.detach()*m`: identical value, gated gradient;
  * the L1 + SSIM photometric loss and the opacity entropy;
  * rendering the model, optionally with the object subset moved by a
    rigid transform and its covariance rotated (the pose stages render
    from `where(is_object, T(xyz), xyz)`; nothing is mutated or reversed);
  * backend choice, binning-capacity sizing and regrowth;
  * crop-window sizing and growth for the masked-object stages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from egogaussian_tpu_torch.models.gaussians import GaussianModel
from egogaussian_tpu_torch.models.optim import AdamState
from egogaussian_tpu_torch.ops.losses import l1_loss, ssim
from egogaussian_tpu_torch.ops.sh import sh_to_rgb
from egogaussian_tpu_torch.render.api import RenderResult, render, resolve_backend
from egogaussian_tpu_torch.render.camera import Camera
from egogaussian_tpu_torch.render.project import rigid_apply
from egogaussian_tpu_torch.utils.console import CONSOLE
from egogaussian_tpu_torch.utils.logging import spanned


@dataclasses.dataclass
class TrainState:
    """A model, its Adam state and the step count (JAX's TrainState, a
    pytree there; here a plain dataclass). The trainers carry the three
    separately and checkpoint them through train/ckpt_hook.py."""

    model: GaussianModel
    opt_state: AdamState
    step: torch.Tensor  # 0-d int32


@spanned("loss")
def mask_grad(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero gradients at masked pixels without changing the forward value."""
    return img * (1.0 - mask) + img.detach() * mask


@spanned("loss")
def image_loss(pred: torch.Tensor, gt: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    """(1-l)*L1 + l*(1-SSIM) — the standard 3DGS photometric loss."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (1.0 - ssim(pred, gt))


def opacity_entropy(opacity_logit: torch.Tensor, visible: torch.Tensor) -> torch.Tensor:
    """Mean binary entropy of visible Gaussians' opacities, from the logits
    (log-sigmoid is exact and never -inf for finite logits; reference
    train_static.py:97-102 computes it on probabilities)."""
    o = torch.sigmoid(opacity_logit)
    ent = -(o * F.logsigmoid(opacity_logit) + (1.0 - o) * F.logsigmoid(-opacity_logit))
    w = visible.to(ent.dtype)
    if ent.dim() == 1:
        return torch.sum(ent * w) / torch.clamp(torch.sum(w), min=1.0)
    # per scene ([S, N])
    return torch.sum(ent * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=1.0)


def model_colors(model: GaussianModel) -> torch.Tensor:
    """Degree-0 SH -> RGB with the rasterizer's non-negativity clamp."""
    rgb = sh_to_rgb(model.params.features_dc[..., 0, :])
    return torch.maximum(rgb, rgb.new_zeros(()))


def render_gaussians(
    model: GaussianModel,
    camera: Camera,
    bg: torch.Tensor,
    pose_T: Optional[torch.Tensor] = None,
    extra_rot: Optional[torch.Tensor] = None,
    which_object: int = 1,
    means2d_probe=None,
    colors_override=None,
    backend: str = "tiled",
    tile_config=None,
    crop_size=None,
    crop_rect=None,
) -> RenderResult:
    """Render the model's alive Gaussians into `camera`, optionally moving
    the Gaussians with is_object == which_object by pose_T [4, 4] and
    rotating their covariance by extra_rot [3, 3] (reference render(...)
    with rot_cov, gaussian_renderer/__init__.py:18-107). crop_size /
    crop_rect: crop-window rendering (render.api.render)."""
    xyz = model.params.xyz
    if pose_T is not None:
        moved = rigid_apply(xyz, pose_T[..., :3, :3], pose_T[..., :3, 3])
        obj_mask = (model.aux.is_object == which_object)[..., None]
        xyz = torch.where(obj_mask, moved, xyz)
    if extra_rot is not None:
        cov3d = model.covariance_rotated(extra_rot, which_object)
    else:
        cov3d = model.covariance()
    colors = colors_override if colors_override is not None else model_colors(model)
    return render(
        camera,
        xyz,
        cov3d,
        model.opacity,
        bg,
        colors_precomp=colors,
        valid_mask=model.aux.alive,
        means2d_probe=means2d_probe,
        backend=backend,
        tile_config=tile_config,
        crop_size=crop_size,
        crop_rect=crop_rect,
    )


def pick_backend(tile_config, backend: str = "auto") -> str:
    """Resolve backend="auto": the chunk-padded kernels ("cuda") whenever
    binning capacities are known (tile_config present), else the tiled
    backend, as in JAX."""
    return resolve_backend(backend, tile_config)


def auto_tile_config(model: GaussianModel, camera: Camera,
                     headroom: float = 1.5, tile_size: int = 32):
    """Estimate binning capacities for the current scene and camera (host
    sync; call at phase start and at densify intervals). Tile size and
    headroom are parameters with the JAX package's meaning; their defaults
    were picked on the TPU and are not yet measured on the card."""
    from egogaussian_tpu_torch.render.project import project_gaussians
    from egogaussian_tpu_torch.render.tiled import estimate_tile_config

    with torch.no_grad():
        proj = project_gaussians(
            model.params.xyz, model.covariance(), camera.viewmat,
            camera.fx, camera.fy, camera.cx, camera.cy,
            camera.width, camera.height, valid_mask=model.aux.alive,
        )
        opac = torch.where(model.aux.alive, model.opacity, torch.zeros_like(model.opacity))
    return estimate_tile_config(
        proj.means2d, proj.radii, camera.width, camera.height,
        tile_size=tile_size, headroom=headroom, opacities=opac,
    )


def maybe_regrow_tile_config(model, camera, tile_cfg, drop_max, last_drop, stage: str):
    """Drop-triggered capacity re-estimation at host-sync boundaries
    (densify intervals): if the running-max dropped-pair count grew since
    the last check, re-estimate the capacity fields from the current scene.
    Only max_pairs, max_per_tile and max_slots change; tile_size and the
    kernel-selecting fields (compositor, bwd_exact_total, mxu_accum) of
    tile_cfg are kept. Returns (tile_cfg, last_drop, changed)."""
    d = int(drop_max)
    if d <= last_drop:
        return tile_cfg, last_drop, False

    def merge(est):
        return dataclasses.replace(
            tile_cfg,
            max_pairs=max(est.max_pairs, tile_cfg.max_pairs),
            max_per_tile=max(est.max_per_tile, tile_cfg.max_per_tile),
            max_slots=max(est.max_slots or 0, tile_cfg.max_slots or 0) or None,
        )

    grown = merge(auto_tile_config(model, camera, tile_size=tile_cfg.tile_size))
    if grown == tile_cfg:
        # the estimate didn't grow (the dropping frame isn't the estimation
        # camera) — force headroom up instead
        grown = merge(auto_tile_config(model, camera, headroom=6.0,
                                       tile_size=tile_cfg.tile_size))
    CONSOLE.log(
        f"[{stage}] up to {d} pairs/render dropped since last check — "
        f"re-estimated binning capacities "
        f"(max_pairs {tile_cfg.max_pairs} -> {grown.max_pairs}, "
        f"max_per_tile {tile_cfg.max_per_tile} -> {grown.max_per_tile})"
    )
    return grown, d, grown != tile_cfg


def pose_crop_size(batch, cfg, stage: str):
    """Crop-window size for the masked-object stages (2 and 3), sized from
    the data: the largest object-mask box of a frame or of the union of two
    consecutive nonempty frames (warm-up starts the object at the previous
    frame's pose), plus cfg.render.pose_crop_margin px per side, rounded
    (width to 128, height to 8, the JAX package's multiples). None when
    cropping is off or the window would keep >= 80% of the frame's area.
    Host sync (set-up)."""
    if not cfg.render.pose_crop:
        return None
    from egogaussian_tpu_torch.render.crop import mask_rect_table

    w, h = batch.width, batch.height
    rects = mask_rect_table(batch.obj_masks).cpu().numpy()  # [F, 4]
    nonempty = rects[:, 2] > rects[:, 0]
    if not nonempty.any():
        return None
    margin = cfg.render.pose_crop_margin
    widths = (rects[:, 2] - rects[:, 0]).astype(np.int64)
    heights = (rects[:, 3] - rects[:, 1]).astype(np.int64)
    need_w = int(widths[nonempty].max())
    need_h = int(heights[nonempty].max())
    ne = np.flatnonzero(nonempty)
    for a, b in zip(ne[:-1], ne[1:]):
        need_w = max(need_w, int(max(rects[a, 2], rects[b, 2]) - min(rects[a, 0], rects[b, 0])))
        need_h = max(need_h, int(max(rects[a, 3], rects[b, 3]) - min(rects[a, 1], rects[b, 1])))
    cw = min(-(-(need_w + 2 * margin) // 128) * 128, w)
    ch = min(-(-(need_h + 2 * margin) // 8) * 8, h)
    if cw * ch >= 0.8 * w * h:
        return None
    CONSOLE.log(f"[{stage}] crop-window rendering {cw}x{ch} of {w}x{h} "
                f"({100.0 * cw * ch / (w * h):.0f}% area; margin {margin}px)")
    return (cw, ch)


def _host_stat(crop_out_max) -> np.ndarray:
    """The device crop stat on the host: int32 [3] [count, need_w, need_h]
    when crop is active, a scalar 0 otherwise (host sync)."""
    if isinstance(crop_out_max, torch.Tensor):
        crop_out_max = crop_out_max.cpu()
    return np.asarray(crop_out_max)


def crop_escape_count(crop_out_max) -> int:
    """Escape count of the device crop stat (host sync)."""
    a = _host_stat(crop_out_max)
    return int(a[0]) if a.ndim else int(a)


def maybe_grow_crop(crop_size, crop_out_max, last_crop_out, batch, stage: str):
    """Coverage-escape response at host-sync boundaries, from the device
    running-max crop stat [escape_count, need_w, need_h]. Escaped splats
    lose their out-of-window gradient, so the window grows until it
    covers, and only along the axis whose need exceeds the current size
    (rounded to 128 / 8); if nothing exceeds, one symmetric granule. Crop
    turns off (None) when no covering window stays under 80% of the frame.
    Returns (crop_size, last_crop_out, changed)."""
    if crop_size is None:
        return None, last_crop_out, False
    stat = _host_stat(crop_out_max)
    c = crop_escape_count(stat)
    if c <= last_crop_out:
        return crop_size, last_crop_out, False
    w, h = batch.width, batch.height
    need_w = int(stat[1]) if stat.ndim else 0
    need_h = int(stat[2]) if stat.ndim else 0
    cw, ch = crop_size
    if need_w > cw:
        cw = min(-(-need_w // 128) * 128, w)
    if need_h > ch:
        ch = min(-(-need_h // 8) * 8, h)
    if (cw, ch) == tuple(crop_size):
        cw = min(cw + 128, w)
        ch = min(ch + 64, h)
    if cw * ch >= 0.8 * w * h:
        CONSOLE.log(f"[{stage}] {c} splats escaped the {crop_size[0]}x{crop_size[1]} "
                    f"crop window (need {need_w}x{need_h}) — disabling crop "
                    "(full-frame rendering)")
        return None, 0, True
    CONSOLE.log(f"[{stage}] {c} splats escaped the {crop_size[0]}x{crop_size[1]} "
                f"crop window — growing to {cw}x{ch}")
    return (cw, ch), 0, True


def render_label_image(model: GaussianModel, camera: Camera, backend: str = "tiled",
                       tile_config=None) -> torch.Tensor:
    """[1, H, W] label rendering with detached geometry (reference
    get_render_label, render_helper.py:38-64)."""
    res = render(
        camera,
        model.params.xyz.detach(),
        model.covariance().detach(),
        model.opacity.detach(),
        bg=torch.zeros((1,), dtype=model.params.xyz.dtype, device=model.device),
        colors_precomp=model.params.label,
        valid_mask=model.aux.alive,
        backend=backend,
        tile_config=tile_config,
    )
    return res.image
