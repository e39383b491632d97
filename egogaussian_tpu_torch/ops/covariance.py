"""3D covariance construction for Gaussian splats.

Port of `egogaussian_tpu/ops/covariance.py`. Covariance is packed as 6
upper-triangular elements (xx, xy, xz, yy, yz, zz) to match the reference
rasterizer ABI, and computed channel-wise (structure of arrays) like the
JAX version, so both packages do the same float operations.
"""
from __future__ import annotations

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
