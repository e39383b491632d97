"""Shared training-step machinery.

Port of the static-training parts of `egogaussian_tpu/train/common.py`:
  * hand-mask gradient gating (the reference's
    `render_image.register_hook(lambda g: g * (1 - hand_mask))`) as
    `img*(1-m) + img.detach()*m`: identical value, gated gradient;
  * the L1 + SSIM photometric loss and the opacity entropy;
  * rendering the model, backend choice and binning-capacity sizing.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from egogaussian_tpu_torch.models.gaussians import GaussianModel
from egogaussian_tpu_torch.ops.losses import l1_loss, ssim
from egogaussian_tpu_torch.ops.sh import sh_to_rgb
from egogaussian_tpu_torch.render.api import RenderResult, render, resolve_backend
from egogaussian_tpu_torch.render.camera import Camera
from egogaussian_tpu_torch.utils.console import CONSOLE


def mask_grad(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero gradients at masked pixels without changing the forward value."""
    return img * (1.0 - mask) + img.detach() * mask


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
    return torch.sum(ent * w) / torch.clamp(torch.sum(w), min=1.0)


def model_colors(model: GaussianModel) -> torch.Tensor:
    """Degree-0 SH -> RGB with the rasterizer's non-negativity clamp."""
    rgb = sh_to_rgb(model.params.features_dc[:, 0, :])
    return torch.maximum(rgb, rgb.new_zeros(()))


def render_gaussians(
    model: GaussianModel,
    camera: Camera,
    bg: torch.Tensor,
    means2d_probe=None,
    colors_override=None,
    backend: str = "auto",
    tile_config=None,
) -> RenderResult:
    """Render the model's alive Gaussians into `camera`."""
    colors = colors_override if colors_override is not None else model_colors(model)
    return render(
        camera,
        model.params.xyz,
        model.covariance(),
        model.opacity,
        bg,
        colors_precomp=colors,
        valid_mask=model.aux.alive,
        means2d_probe=means2d_probe,
        backend=backend,
        tile_config=tile_config,
    )


def pick_backend(tile_config, backend: str = "auto") -> str:
    """Resolve backend="auto": the tile-grid kernels ("cuda") whenever
    binning capacities are known (tile_config present), else the oracle."""
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
    the last check, re-estimate the capacity fields from the current scene
    (the kernel-selecting fields of tile_cfg are kept).
    Returns (tile_cfg, last_drop, changed)."""
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


def render_label_image(model: GaussianModel, camera: Camera, backend: str = "auto",
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
