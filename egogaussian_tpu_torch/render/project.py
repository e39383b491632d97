"""EWA splat projection: 3D Gaussians -> screen-space 2D Gaussians.

Port of `egogaussian_tpu/render/project.py` (the preprocess stage of the
reference's diff-gaussian-rasterization). Written channel-wise like the JAX
version, so both packages do the same float operations per Gaussian.

Outputs: means2d [N,2] pixel coords, conics [N,3] (inverse 2D covariance,
packed (a,b,c) for [[a,b],[b,c]]), depths [N], radii [N] (3-sigma pixel
radius, 0 = culled), cov2d [N,3].
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from egogaussian_tpu_torch.utils.logging import spanned


def rigid_apply(x: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                rows: Optional[Sequence[int]] = None) -> torch.Tensor:
    """x @ R^T + t: x [N, 3] with R [3, 3], t [3]; or with a leading scene
    axis, x [S, N, 3], R [S, 3, 3], t [S, 3]. Each scene takes the
    unbatched product over its own rows x[s, :rows[s]] (default all N), so
    it gives the bits of its call without a scene axis, values and
    gradients alike: R's and t's gradients are sums over the rows inside
    the product's backward, which a batched product takes over the padded
    stack. The padded rows pass through."""
    if x.dim() == 2:
        return x @ R.T + t
    n = x.shape[1]
    out = []
    for s in range(x.shape[0]):
        c = n if rows is None else int(rows[s])
        y = x[s, :c] @ R[s].T + t[s]
        out.append(y if c == n else torch.cat([y, x[s, c:]]))
    return torch.stack(out)


class ProjectedGaussians(NamedTuple):
    means2d: torch.Tensor  # [N, 2] pixel coordinates
    conics: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    depths: torch.Tensor  # [N] camera-space z
    radii: torch.Tensor  # [N] int32, 0 => culled
    cov2d: torch.Tensor  # [N, 3] 2D covariance (a, b, c), pre-inversion


@spanned("project")
def project_gaussians(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    viewmat: torch.Tensor,
    fx: torch.Tensor,
    fy: torch.Tensor,
    cx: torch.Tensor,
    cy: torch.Tensor,
    width: int,
    height: int,
    blur: float = 0.3,
    valid_mask: Optional[torch.Tensor] = None,
) -> ProjectedGaussians:
    """Project 3D Gaussians into a camera via the EWA approximation.

    Args:
      means3d: [N, 3] world-space means
      cov3d: [N, 6] packed symmetric covariance (xx, xy, xz, yy, yz, zz)
      viewmat: [4, 4] world-to-camera
      valid_mask: optional [N] bool; False rows are force-culled (capacity
        padding of the model)
    With a leading scene axis S: means3d [S, N, 3], cov3d [S, N, 6],
    viewmat [S, 4, 4], fx, fy, cx, cy [S, 1], valid_mask [S, N]; every
    output gains the axis. width and height are shared.
    """
    R = viewmat[..., :3, :3]
    t = viewmat[..., :3, 3]
    if means3d.dim() == 3 and means3d.shape[0] > 1:
        # one batched product: the camera is no parameter, so no gradient
        # sums the rows into a per-scene quantity here
        t_cam = torch.matmul(means3d, R.transpose(-1, -2)) + t[:, None, :]
    else:
        t_cam = rigid_apply(means3d, R, t)  # [N, 3]
    Rn = R[..., None, :, :]  # entries broadcast over the Gaussians
    z = t_cam[..., 2]

    # Frustum cull behind the near plane (the CUDA reference culls z <= 0.2)
    in_front = z > 0.2
    zs = torch.where(in_front, z, torch.ones_like(z))

    # Clamp the tangent-plane coords like the CUDA EWA (1.3 * tan(fov/2))
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tx = torch.minimum(torch.maximum(t_cam[..., 0] / zs, -lim_x), lim_x) * zs
    ty = torch.minimum(torch.maximum(t_cam[..., 1] / zs, -lim_y), lim_y) * zs

    # cov2d = (J R) Sigma (J R)^T expanded channel-wise (J has the sparse
    # EWA structure [[fx/z, 0, -fx tx/z^2], [0, fy/z, -fy ty/z^2]])
    inv_z = 1.0 / zs
    k0 = fx * inv_z
    k1 = -fx * tx * inv_z * inv_z
    k2 = fy * inv_z
    k3 = -fy * ty * inv_z * inv_z
    w00 = k0 * Rn[..., 0, 0] + k1 * Rn[..., 2, 0]
    w01 = k0 * Rn[..., 0, 1] + k1 * Rn[..., 2, 1]
    w02 = k0 * Rn[..., 0, 2] + k1 * Rn[..., 2, 2]
    w10 = k2 * Rn[..., 1, 0] + k3 * Rn[..., 2, 0]
    w11 = k2 * Rn[..., 1, 1] + k3 * Rn[..., 2, 1]
    w12 = k2 * Rn[..., 1, 2] + k3 * Rn[..., 2, 2]

    xx, xy, xz, yy, yz, zz = (cov3d[..., i] for i in range(6))
    v0 = xx * w00 + xy * w01 + xz * w02
    v1 = xy * w00 + yy * w01 + yz * w02
    v2 = xz * w00 + yz * w01 + zz * w02
    u0 = xx * w10 + xy * w11 + xz * w12
    u1 = xy * w10 + yy * w11 + yz * w12
    u2 = xz * w10 + yz * w11 + zz * w12
    a = w00 * v0 + w01 * v1 + w02 * v2 + blur
    b = w10 * v0 + w11 * v1 + w12 * v2
    c = w10 * u0 + w11 * u1 + w12 * u2 + blur

    det = a * c - b * b
    det_valid = det > 0.0
    det_safe = torch.where(det_valid, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    # 3-sigma screen radius from the larger eigenvalue of cov2d
    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))

    u = fx * t_cam[..., 0] / zs + cx
    v = fy * t_cam[..., 1] / zs + cy
    means2d = torch.stack([u, v], dim=-1)

    # Cull splats whose 3-sigma box misses the image entirely
    on_screen = (
        (u + radius > 0)
        & (u - radius < width)
        & (v + radius > 0)
        & (v - radius < height)
    )
    keep = in_front & det_valid & on_screen
    if valid_mask is not None:
        keep = keep & valid_mask
    radii = torch.where(keep, radius, torch.zeros_like(radius)).to(torch.int32)

    return ProjectedGaussians(
        means2d=means2d,
        conics=conic,
        depths=z,
        radii=radii,
        cov2d=torch.stack([a, b, c], dim=-1),
    )
