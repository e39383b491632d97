"""SE(3) rigid-transform algebra.

Port of `egogaussian_tpu/ops/se3.py`. Pose sequences are dense tensors
[F, 4, 4]; accumulation is a running product over the frame axis (a
short Python loop: F is the number of video frames, and it runs once per
solved frame, not per iteration).
"""
from __future__ import annotations

import torch


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Build 4x4 homogeneous transforms from R [..., 3, 3] and t [..., 3]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(batch + (4,))[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def se3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b: apply b first, then a."""
    return a @ b


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of rigid transforms [..., 4, 4]: [R^T, -R^T t]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", Rt, t)
    return make_se3(Rt, t_inv)


def se3_apply(T: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Apply transforms T [..., 4, 4] to points xyz [..., N, 3] (or [N, 3])."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, xyz) + t[..., None, :]


def _running_product(seq: torch.Tensor) -> torch.Tensor:
    """A_k = M_k @ A_{k-1}, A_0 = M_0 over the leading axis (newest on the
    left, the reference's get_accum_T_seq order). The JAX package takes
    the same products in a log-depth associative scan, so the two differ
    by float32 reassociation only."""
    out = [seq[0]]
    for k in range(1, seq.shape[0]):
        out.append(seq[k] @ out[-1])
    return torch.stack(out)


def accumulate_transforms(T_seq: torch.Tensor) -> torch.Tensor:
    """Running products T_k @ ... @ T_0 for T_seq [F, 4, 4]."""
    return _running_product(T_seq)


def accumulate_rotations(R_seq: torch.Tensor) -> torch.Tensor:
    """Running products of rotations [F, 3, 3], newest on the left."""
    return _running_product(R_seq)
