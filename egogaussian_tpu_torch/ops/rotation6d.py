"""6D rotation representation (Zhou et al., CVPR 2019).

Port of `egogaussian_tpu/ops/rotation6d.py`: the trainable object pose
parametrizes rotation as the first two columns of R, orthonormalized by
Gram-Schmidt.
"""
from __future__ import annotations

import torch


def rot6d_to_rotmat(d6: torch.Tensor) -> torch.Tensor:
    """[..., 3, 2] (or [..., 6]) -> rotation matrices [..., 3, 3]."""
    if d6.shape[-1] == 6:
        d6 = d6.reshape(d6.shape[:-1] + (3, 2))

    def safe_normalize(v):
        # rsqrt(|v|^2 + eps^2): finite gradient at v = 0
        return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-24)

    a1 = d6[..., :, 0]
    a2 = d6[..., :, 1]
    b1 = safe_normalize(a1)
    a2_proj = torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = safe_normalize(a2 - a2_proj)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> 6D representation [..., 3, 2]."""
    return R[..., :, :2]


def identity_rot6d(device=None, dtype=torch.float32) -> torch.Tensor:
    """The 6D representation of the identity rotation, shape [3, 2]."""
    return torch.eye(3, dtype=dtype, device=device)[:, :2]
