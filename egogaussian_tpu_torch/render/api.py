"""High-level differentiable render API.

Port of `egogaussian_tpu/render/api.py`. `render` is a function of tensors;
screen-space gradients for densification come from an explicit
`means2d_probe` zeros input (take the gradient with respect to it to get
the reference's `viewspace_points.grad`).

Backends:
  "oracle": all-pairs compositor in plain torch autograd (small scenes)
  "cuda":   tile binning + chunk-padded layout + the tile-grid kernel pair
            (plain twins for CPU tensors)
  "auto":   "cuda" when a tile config is given, else "oracle"
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from egogaussian_tpu_torch.ops.sh import eval_sh, sh_to_rgb
from egogaussian_tpu_torch.render.camera import Camera
from egogaussian_tpu_torch.render.oracle import composite_oracle
from egogaussian_tpu_torch.render.project import project_gaussians


class RenderResult(NamedTuple):
    image: torch.Tensor  # [D, H, W]
    alpha: torch.Tensor  # [1, H, W]
    depth: torch.Tensor  # [1, H, W]
    radii: torch.Tensor  # [N] int32; >0 == the reference's visibility_filter
    means2d: torch.Tensor  # [N, 2] projected screen means
    # pairs dropped by the binned backend's static capacities this render
    dropped_pairs: torch.Tensor


def resolve_backend(backend: str, tile_config) -> str:
    if backend == "auto":
        return "cuda" if tile_config is not None else "oracle"
    return backend


def _colors_from_sh(sh_coeffs, sh_degree: int, means3d, campos):
    """Evaluate SH towards the camera. sh_coeffs: [N, K, 3]."""
    zero = sh_coeffs.new_zeros(())
    if sh_degree == 0:
        return torch.maximum(sh_to_rgb(sh_coeffs[:, 0, :]), zero)
    dirs = means3d - campos[None]
    dirs = dirs * torch.rsqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-16)
    rgb = eval_sh(sh_degree, sh_coeffs.transpose(-1, -2), dirs)
    return torch.maximum(rgb + 0.5, zero)


def render(
    camera: Camera,
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacities: torch.Tensor,
    bg: torch.Tensor,
    sh_coeffs: Optional[torch.Tensor] = None,
    sh_degree: int = 0,
    colors_precomp: Optional[torch.Tensor] = None,
    valid_mask: Optional[torch.Tensor] = None,
    means2d_probe: Optional[torch.Tensor] = None,
    backend: str = "auto",
    tile_config=None,
) -> RenderResult:
    """Differentiable rasterization of N Gaussians into `camera`.

    Args:
      means3d: [N, 3]; cov3d: [N, 6] packed; opacities: [N] in [0, 1]
      sh_coeffs: [N, K, 3] SH colors (used unless colors_precomp given)
      colors_precomp: [N, D] overrides SH (label channel / color override)
      valid_mask: [N] alive mask (capacity padding rows culled)
      means2d_probe: [N, 2] zeros added to the projected means, so that
        d(loss)/d(probe) is the screen-space gradient for densification
      backend: "oracle" | "cuda" | "auto"
    """
    proj = project_gaussians(
        means3d, cov3d, camera.viewmat, camera.fx, camera.fy, camera.cx,
        camera.cy, camera.width, camera.height, valid_mask=valid_mask,
    )
    means2d = proj.means2d
    if means2d_probe is not None:
        means2d = means2d + means2d_probe
        proj = proj._replace(means2d=means2d)

    if colors_precomp is not None:
        colors = colors_precomp
    else:
        if sh_coeffs is None:
            raise ValueError("render needs sh_coeffs or colors_precomp")
        colors = _colors_from_sh(sh_coeffs, sh_degree, means3d, camera.camera_center)

    backend = resolve_backend(backend, tile_config)
    if backend == "oracle":
        out = composite_oracle(proj, colors, opacities, bg, camera.width, camera.height)
    elif backend == "cuda":
        from egogaussian_tpu_torch.render.tiled import composite_cuda

        out = composite_cuda(proj, colors, opacities, bg, camera.width,
                             camera.height, config=tile_config)
    else:
        raise ValueError(f"unknown render backend: {backend}")

    return RenderResult(
        image=out.image,
        alpha=out.alpha,
        depth=out.depth,
        radii=out.radii,
        means2d=means2d,
        dropped_pairs=out.dropped_pairs,
    )


def render_label(
    camera: Camera,
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacities: torch.Tensor,
    labels: torch.Tensor,
    valid_mask: Optional[torch.Tensor] = None,
    backend: str = "auto",
    tile_config=None,
) -> torch.Tensor:
    """Render the per-Gaussian scalar label as a 1-channel image with the
    geometry detached (gradient flows only through the label), matching
    reference `render_helper.get_render_label`. Returns [1, H, W]."""
    res = render(
        camera,
        means3d.detach(),
        cov3d.detach(),
        opacities.detach(),
        bg=torch.zeros((1,), dtype=means3d.dtype, device=means3d.device),
        colors_precomp=labels[:, None],
        valid_mask=valid_mask,
        backend=backend,
        tile_config=tile_config,
    )
    return res.image
