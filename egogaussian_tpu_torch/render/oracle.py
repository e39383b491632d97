"""Reference (oracle) compositor: every Gaussian against every pixel.

Port of `egogaussian_tpu/render/oracle.py`, in plain torch autograd. It
defines the compositing semantics and is the correctness oracle for the
tile-grid kernels:

  alpha_i(p) = min(0.99, opacity_i * exp(-0.5 d^T Conic d)), zeroed < 1/255
  w_i = alpha_i * prod_{j<i} (1 - alpha_j)  (front-to-back depth order)
  rgb   = sum w_i c_i + T_final * bg
  alpha = 1 - T_final = sum w_i
  depth = sum w_i z_i          (unnormalized expected depth)

Memory is O(chunk * H * W) per step of the chunk loop, and autograd keeps
every chunk's intermediates: meant for small scenes and tests.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from egogaussian_tpu_torch.render.project import ProjectedGaussians

ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99


class RenderOutput(NamedTuple):
    image: torch.Tensor  # [D, H, W]
    alpha: torch.Tensor  # [1, H, W]
    depth: torch.Tensor  # [1, H, W]
    radii: torch.Tensor  # [N]
    # pairs lost to the binned backend's static capacities (0 for the
    # exact oracle)
    dropped_pairs: torch.Tensor


def pixel_alphas(
    means2d: torch.Tensor,
    conics: torch.Tensor,
    opacities: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Alpha of each Gaussian [G] at each pixel (px, py) [H, W] -> [G, H, W]."""
    shape = (-1, 1, 1)
    dx = px[None] - means2d[:, 0].reshape(shape)
    dy = py[None] - means2d[:, 1].reshape(shape)
    a = conics[:, 0].reshape(shape)
    b = conics[:, 1].reshape(shape)
    c = conics[:, 2].reshape(shape)
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    power = torch.minimum(power, power.new_zeros(()))
    alpha = opacities.reshape(shape) * torch.exp(power)
    alpha = torch.minimum(alpha, alpha.new_tensor(ALPHA_MAX))
    alpha = torch.where(alpha < ALPHA_EPS, torch.zeros_like(alpha), alpha)
    return torch.where(valid.reshape(shape), alpha, torch.zeros_like(alpha))


def composite_oracle(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    bg: torch.Tensor,
    width: int,
    height: int,
    chunk_size: int = 256,
) -> RenderOutput:
    """Composite all Gaussians over the full image, front-to-back.

    Args:
      colors: [N, D] per-Gaussian colors (D=3 RGB, or 1 for label rendering)
      opacities: [N] activated opacities in [0, 1]
      bg: [D] background color
    """
    n = proj.depths.shape[0]
    d = colors.shape[-1]
    dev, dt = proj.means2d.device, proj.means2d.dtype
    valid = proj.radii > 0

    # Depth order: culled Gaussians sort to the back with +inf depth
    # (stable, like jnp.argsort, so ties keep index order).
    key = torch.where(valid, proj.depths, torch.full_like(proj.depths, float("inf")))
    order = torch.argsort(key, stable=True)
    means2d = proj.means2d[order]
    conics = proj.conics[order]
    depths = proj.depths[order]
    cols = colors[order]
    ops = opacities[order]
    valid_s = valid[order]

    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=dt, device=dev) + 0.5,
        torch.arange(width, dtype=dt, device=dev) + 0.5,
        indexing="ij",
    )

    log_t = torch.zeros((height, width), dtype=dt, device=dev)
    img = torch.zeros((d, height, width), dtype=dt, device=dev)
    acc_alpha = torch.zeros((height, width), dtype=dt, device=dev)
    acc_depth = torch.zeros((height, width), dtype=dt, device=dev)
    for lo in range(0, n, chunk_size):
        sl = slice(lo, lo + chunk_size)
        alpha = pixel_alphas(means2d[sl], conics[sl], ops[sl], xs, ys, valid_s[sl])
        log1m = torch.log1p(-alpha)  # alpha <= 0.99 so finite
        excl = torch.cumsum(log1m, dim=0) - log1m
        w = alpha * torch.exp(log_t[None] + excl)  # [G, H, W]
        img = img + torch.einsum("ghw,gd->dhw", w, cols[sl])
        acc_alpha = acc_alpha + torch.sum(w, dim=0)
        acc_depth = acc_depth + torch.einsum("ghw,g->hw", w, depths[sl])
        log_t = log_t + torch.sum(log1m, dim=0)
    t_final = torch.exp(log_t)
    img = img + t_final[None] * bg[:, None, None]
    return RenderOutput(
        image=img,
        alpha=acc_alpha[None],
        depth=acc_depth[None],
        radii=proj.radii,
        dropped_pairs=torch.zeros((), dtype=torch.int64, device=dev),
    )
