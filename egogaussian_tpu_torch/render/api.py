"""High-level differentiable render API.

Port of `egogaussian_tpu/render/api.py`. `render` is a function of tensors;
screen-space gradients for densification come from an explicit
`means2d_probe` zeros input (take the gradient with respect to it to get
the reference's `viewspace_points.grad`).

Backends:
  "oracle": all-pairs compositor in plain torch autograd (small scenes)
  "tiled":  tile binning + per-tile gather window + the chunked windowed
            kernel pair (the JAX "tiled" backend; plain twins for CPU
            tensors)
  "cuda":   tile binning + chunk-padded layout + the tile-grid or stream
            kernel pair (the JAX "pallas" backend)
  "auto":   "cuda" when a tile config is given, else "tiled", as in JAX
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
    # crop-window rendering (render/crop.py): window origin (ox, oy) int32
    # and the coverage stat [escape_count, need_w, need_h] (escape_count 0
    # == the cropped render is loss-identical for masked-object losses)
    crop_offset: Optional[torch.Tensor] = None
    crop_outside: object = 0


def resolve_backend(backend: str, tile_config) -> str:
    """"auto" -> "cuda" with a tile config, else "tiled" (JAX render's
    "pallas" / "tiled")."""
    if backend == "auto":
        return "cuda" if tile_config is not None else "tiled"
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
    backend: str = "tiled",
    tile_config=None,
    crop_size: Optional[tuple] = None,
    crop_rect: Optional[torch.Tensor] = None,
) -> RenderResult:
    """Differentiable rasterization of N Gaussians into `camera`.

    Args:
      means3d: [N, 3]; cov3d: [N, 6] packed; opacities: [N] in [0, 1]
      sh_coeffs: [N, K, 3] SH colors (used unless colors_precomp given)
      colors_precomp: [N, D] overrides SH (label channel / color override)
      valid_mask: [N] alive mask (capacity padding rows culled)
      means2d_probe: [N, 2] zeros added to the projected means, so that
        d(loss)/d(probe) is the screen-space gradient for densification
      backend: "oracle" | "tiled" | "cuda" | "auto"
      crop_size: optional (crop_w, crop_h): composite only a window of that
        size, placed on the device over (splat reach | crop_rect) every
        call (render/crop.py). Projection, radii and probe gradients stay
        those of the full frame; image/alpha/depth come back at crop_size
        and `crop_offset`/`crop_outside` report the window.
      crop_rect: optional (x0, y0, x1, y1) float32 must-cover rect (e.g.
        the object-mask box from render.crop.mask_rect)
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
    comp_w, comp_h = camera.width, camera.height
    crop_offset, crop_outside = None, 0
    if crop_size is not None:
        from egogaussian_tpu_torch.render.crop import crop_window
        from egogaussian_tpu_torch.render.tiled import TileConfig

        crop_w, crop_h = int(crop_size[0]), int(crop_size[1])
        # tile-aligned windows composite the full frame's pixels exactly
        align = 1 if backend == "oracle" else (tile_config or TileConfig()).tile_size
        ox, oy, crop_outside = crop_window(
            proj, opacities, valid_mask, crop_rect, crop_w, crop_h,
            camera.width, camera.height, align=align,
        )
        # exact window shift: means2d = fx*x/z + cx, so moving the origin by
        # an integer is the principal-point shift cx - ox (radii, conics
        # and depths are unchanged)
        shift = torch.stack([ox, oy]).to(means2d.dtype)
        proj = proj._replace(means2d=means2d - shift[None, :])
        comp_w, comp_h = crop_w, crop_h
        crop_offset = torch.stack([ox, oy])

    if backend == "oracle":
        out = composite_oracle(proj, colors, opacities, bg, comp_w, comp_h)
    elif backend == "tiled":
        from egogaussian_tpu_torch.render.tiled import composite_tiled

        out = composite_tiled(proj, colors, opacities, bg, comp_w, comp_h,
                              config=tile_config)
    elif backend == "cuda":
        from egogaussian_tpu_torch.render.tiled import composite_cuda

        out = composite_cuda(proj, colors, opacities, bg, comp_w, comp_h,
                             config=tile_config)
    else:
        raise ValueError(f"unknown render backend: {backend}")

    return RenderResult(
        image=out.image,
        alpha=out.alpha,
        depth=out.depth,
        radii=out.radii,
        means2d=means2d,
        dropped_pairs=out.dropped_pairs,
        crop_offset=crop_offset,
        crop_outside=crop_outside,
    )


def render_label(
    camera: Camera,
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacities: torch.Tensor,
    labels: torch.Tensor,
    valid_mask: Optional[torch.Tensor] = None,
    backend: str = "tiled",
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


def render_scenes(
    cams,
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacities: torch.Tensor,
    bg: torch.Tensor,
    colors: torch.Tensor,
    caps,
    valid_mask: Optional[torch.Tensor] = None,
    means2d_probe: Optional[torch.Tensor] = None,
    backend: str = "cuda",
    crop: bool = False,
    crop_rects: Optional[torch.Tensor] = None,
) -> RenderResult:
    """`render` for S scenes in one pass: every op runs once on [S, ...]
    tensors and the compositor is one launch for all scenes (the port of
    JAX's vmap over the render). `cams` (parallel/multi_scene.py
    SceneCameras) holds one camera per scene; means3d [S, N, 3], cov3d
    [S, N, 6], opacities [S, N], bg [S, D], colors [S, N, D], valid_mask
    and means2d_probe [S, N(, 2)]. `caps` (render/tiled.py SceneCaps): each
    scene's binning capacities and composite size. With `crop`, each
    scene composites a window of its caps size placed over its splats and
    crop_rects [S, 4] (render/crop.py), as `render` with crop_size does.
    backend "cuda" (tile-grid pair) or "tiled" (chunked windowed pair)."""
    from egogaussian_tpu_torch.render.tiled import composite_scenes

    proj = project_gaussians(
        means3d, cov3d, cams.viewmat, cams.fx, cams.fy, cams.cx, cams.cy,
        cams.width, cams.height, valid_mask=valid_mask,
    )
    means2d = proj.means2d
    if means2d_probe is not None:
        means2d = means2d + means2d_probe
        proj = proj._replace(means2d=means2d)
    crop_offset, crop_outside = None, 0
    if crop:
        from egogaussian_tpu_torch.render.crop import crop_window

        dev = means3d.device
        cw = torch.tensor([w for w, _ in caps.sizes], dtype=torch.float32, device=dev)
        ch = torch.tensor([h for _, h in caps.sizes], dtype=torch.float32, device=dev)
        ox, oy, crop_outside = crop_window(
            proj, opacities, valid_mask, crop_rects, cw, ch, cams.width, cams.height,
            align=caps.config.tile_size,
        )
        shift = torch.stack([ox, oy], dim=-1).to(means2d.dtype)
        proj = proj._replace(means2d=means2d - shift[:, None, :])
        crop_offset = torch.stack([ox, oy], dim=-1)
    out = composite_scenes(proj, colors, opacities, bg, caps, resolve_backend(backend, caps))
    return RenderResult(
        image=out.image, alpha=out.alpha, depth=out.depth, radii=out.radii, means2d=means2d,
        dropped_pairs=out.dropped_pairs, crop_offset=crop_offset, crop_outside=crop_outside,
    )
