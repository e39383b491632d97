"""3D covariance construction for Gaussian splats.

Port of `egogaussian_tpu/ops/covariance.py`. Covariance is packed as 6
upper-triangular elements (xx, xy, xz, yy, yz, zz) to match the reference
rasterizer ABI, and computed channel-wise (structure of arrays) like the
JAX version, so both packages do the same float operations.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from egogaussian_tpu_torch.ops.quaternion import quat_normalize, quat_to_rotmat


def build_scaling_rotation(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """L = R(q) @ diag(s). scales [..., 3], quats [..., 4] wxyz -> [..., 3, 3]."""
    R = quat_to_rotmat(quats)
    return R * scales[..., None, :]


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """Pack symmetric [..., 3, 3] into 6 upper-triangular elements [..., 6]."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
        dim=-1,
    )


def unpack_symmetric(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of strip_symmetric: [..., 6] -> full symmetric [..., 3, 3]."""
    xx, xy, xz, yy, yz, zz = (packed[..., i] for i in range(6))
    return torch.stack(
        [
            torch.stack([xx, xy, xz], dim=-1),
            torch.stack([xy, yy, yz], dim=-1),
            torch.stack([xz, yz, zz], dim=-1),
        ],
        dim=-2,
    )


def _rotmat_entries(quats: torch.Tensor):
    """The 9 rotation-matrix entries as separate [...] tensors (wxyz quat)."""
    q = quat_normalize(quats)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    )


def covariance_from_scaling_rotation(
    scales: torch.Tensor, quats: torch.Tensor, scale_modifier: float = 1.0
) -> torch.Tensor:
    """Sigma = L L^T, packed [..., 6]: Sigma_ij = sum_k s_k^2 R_ik R_jk."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rotmat_entries(quats)
    s = scales * scale_modifier
    s0, s1, s2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    xx = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02
    xy = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12
    xz = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22
    yy = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12
    yz = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22
    zz = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22
    return torch.stack([xx, xy, xz, yy, yz, zz], dim=-1)


def covariance_from_scaling_rotation_rotated(
    scales: torch.Tensor,
    quats: torch.Tensor,
    extra_rot: torch.Tensor,
    apply_mask: torch.Tensor,
    scale_modifier: float = 1.0,
    rows: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Covariance with an extra left rotation applied to a subset of
    Gaussians: Sigma = (X L)(X L)^T where X = extra_rot [3, 3] and
    apply_mask [...] is 1 where it applies (the object Gaussians rendered
    at a frame pose). Blended as rot*m + cov*(1-m), like the JAX package,
    so both packages take the same gradient paths. With a scene axis (X
    [S, 3, 3]) X's gradient sums each scene's own rows rows[s] as the
    scene's run alone does (congruence_transform)."""
    cov = covariance_from_scaling_rotation(scales, quats, scale_modifier)
    rot = congruence_transform(cov, extra_rot, rows)
    mask = apply_mask[..., None].to(cov.dtype)
    return rot * mask + cov * (1.0 - mask)


class _SceneRowsBroadcast(torch.autograd.Function):
    """x [S, 1], one entry per scene, broadcast over a scene stack's n rows
    as [S, n]. The backward sums each scene's own rows g[s, :rows[s]] with
    the reduction a one-scene broadcast's backward takes over its rows, so
    the scene's entry gets the gradient its run alone gets (the stack's
    padded rows add nothing, and the sum's length is the scene's own)."""

    @staticmethod
    def forward(ctx, x, n, rows):
        ctx.rows = rows
        return x.expand(x.shape[0], n)

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty(g.shape[0], 1)
        for s, c in enumerate(ctx.rows):
            torch.sum(g[s, :c], 0, keepdim=True, out=out[s])
        return out, None, None


def congruence_transform(cov: torch.Tensor, X: torch.Tensor,
                         rows: Optional[Sequence[int]] = None) -> torch.Tensor:
    """X Sigma X^T on packed [..., 6] covariances, channel-wise (X [3, 3];
    with a leading scene axis cov [S, N, 6] and X [S, 3, 3], each entry
    of X[s] broadcast over scene s's rows, as one scene's X is over its
    own, one _SceneRowsBroadcast per use: X's gradient sums each use over
    the scene's own rows rows[s] (default all N) as its run alone does)."""
    xx, xy, xz, yy, yz, zz = (cov[..., i] for i in range(6))
    Xn = X[..., None, :, :]  # entries broadcast over the covariances
    entries = [Xn[..., i, j] for i in range(3) for j in range(3)]
    if X.dim() == 3:
        n = cov.shape[1]
        rows = tuple(rows) if rows is not None else (n,) * X.shape[0]

        def use(k):
            return _SceneRowsBroadcast.apply(entries[k], n, rows)
    else:
        use = entries.__getitem__
    # T = X @ Sigma (rows of the intermediate as channels)
    t00 = use(0) * xx + use(1) * xy + use(2) * xz
    t01 = use(0) * xy + use(1) * yy + use(2) * yz
    t02 = use(0) * xz + use(1) * yz + use(2) * zz
    t10 = use(3) * xx + use(4) * xy + use(5) * xz
    t11 = use(3) * xy + use(4) * yy + use(5) * yz
    t12 = use(3) * xz + use(4) * yz + use(5) * zz
    t20 = use(6) * xx + use(7) * xy + use(8) * xz
    t21 = use(6) * xy + use(7) * yy + use(8) * yz
    t22 = use(6) * xz + use(7) * yz + use(8) * zz
    # Sigma' = T @ X^T (upper triangle only)
    return torch.stack(
        [
            t00 * use(0) + t01 * use(1) + t02 * use(2),
            t00 * use(3) + t01 * use(4) + t02 * use(5),
            t00 * use(6) + t01 * use(7) + t02 * use(8),
            t10 * use(3) + t11 * use(4) + t12 * use(5),
            t10 * use(6) + t11 * use(7) + t12 * use(8),
            t20 * use(6) + t21 * use(7) + t22 * use(8),
        ],
        dim=-1,
    )
