"""Trainable object pose and per-frame pose sequences.

Port of `egogaussian_tpu/models/pose.py`:
  * ObjectPose is a small dataclass of tensors (translation + 6D rotation)
    optimized by the same hand-rolled Adam as the Gaussians
    (models/optim.py works on any dataclass of tensors).
  * A PoseSequence is dense [F, ...] tensors with a `solved` mask; the
    accumulated transforms are running products (ops/se3.py).
  * The N-th root of a rigid transform is closed-form (axis-angle root +
    geometric-series translation solve), as in the JAX package.
  * Pose sequences are saved as npz with the JAX package's keys, so either
    package reads the other's files.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from egogaussian_tpu_torch.ops.rotation6d import rot6d_to_rotmat, rotmat_to_rot6d
from egogaussian_tpu_torch.ops.se3 import (
    accumulate_rotations,
    accumulate_transforms,
    make_se3,
)


@dataclasses.dataclass
class ObjectPose:
    """Trainable rigid object move (reference ObjectMove,
    geometry_utils.py:14-33): translation [3] + 6D rotation [3, 2]."""

    translation: torch.Tensor
    rot6d: torch.Tensor

    @property
    def rotation(self) -> torch.Tensor:
        return rot6d_to_rotmat(self.rot6d)


def identity_pose(device=None, dtype=torch.float32) -> ObjectPose:
    return ObjectPose(
        translation=torch.zeros((3,), dtype=dtype, device=device),
        rot6d=torch.eye(3, dtype=dtype, device=device)[:, :2].clone(),
    )


def pose_from_rt(R: torch.Tensor, t: torch.Tensor) -> ObjectPose:
    return ObjectPose(translation=torch.as_tensor(t), rot6d=rotmat_to_rot6d(torch.as_tensor(R)))


def pose_from_jax_arrays(translation, rot6d, device) -> ObjectPose:
    """An ObjectPose from the JAX package's arrays, carried as numpy."""
    return ObjectPose(
        translation=torch.tensor(np.asarray(translation, np.float32), device=device),
        rot6d=torch.tensor(np.asarray(rot6d, np.float32), device=device),
    )


def pose_to_se3(pose: ObjectPose) -> torch.Tensor:
    return make_se3(pose.rotation, pose.translation)


def apply_pose(pose: ObjectPose, xyz: torch.Tensor) -> torch.Tensor:
    """R x + t on [N, 3] (ObjectMove.forward, geometry_utils.py:20-25)."""
    return xyz @ pose.rotation.T + pose.translation


@dataclasses.dataclass
class PoseSequence:
    """Per-frame object pose deltas over a video: translations [F, 3],
    rotations [F, 3, 3], solved [F] bool. Frame f's delta moves the object
    from frame f-1's pose to frame f's; unsolved frames hold the identity.
    The accumulated transform of frame f is delta_f @ ... @ delta_0."""

    translations: torch.Tensor
    rotations: torch.Tensor
    solved: torch.Tensor

    @property
    def num_frames(self) -> int:
        return self.translations.shape[0]

    def deltas(self) -> torch.Tensor:
        """Per-frame 4x4 deltas with the identity at unsolved frames."""
        eye = torch.eye(4, dtype=self.translations.dtype, device=self.translations.device)
        T = make_se3(self.rotations, self.translations)
        return torch.where(self.solved[:, None, None], T, eye[None])

    def accum_T(self) -> torch.Tensor:
        """[F, 4, 4] accumulated transforms A_f = T_f ... T_0."""
        return accumulate_transforms(self.deltas())

    def accum_R(self) -> torch.Tensor:
        """[F, 3, 3] accumulated rotations (get_accum_R_seq twin)."""
        eye = torch.eye(3, dtype=self.rotations.dtype, device=self.rotations.device)
        R = torch.where(self.solved[:, None, None], self.rotations, eye[None])
        return accumulate_rotations(R)

    def update_frame(self, frame: int, pose: ObjectPose) -> "PoseSequence":
        """A new sequence with frame `frame` set to `pose` and solved."""
        tr, rot, solved = self.translations.clone(), self.rotations.clone(), self.solved.clone()
        tr[frame] = pose.translation.detach()
        rot[frame] = pose.rotation.detach()
        solved[frame] = True
        return PoseSequence(translations=tr, rotations=rot, solved=solved)


def empty_pose_sequence(num_frames: int, device=None, dtype=torch.float32) -> PoseSequence:
    return PoseSequence(
        translations=torch.zeros((num_frames, 3), dtype=dtype, device=device),
        rotations=torch.eye(3, dtype=dtype, device=device)[None].repeat(num_frames, 1, 1),
        solved=torch.zeros((num_frames,), dtype=torch.bool, device=device),
    )


def pose_sequence_from_jax_arrays(translations, rotations, solved, device) -> PoseSequence:
    """A PoseSequence from the JAX package's arrays, carried as numpy."""
    return PoseSequence(
        translations=torch.tensor(np.asarray(translations, np.float32), device=device),
        rotations=torch.tensor(np.asarray(rotations, np.float32), device=device),
        solved=torch.tensor(np.asarray(solved, bool), device=device),
    )


# ---------------------------------------------------------------------------
# npz (de)serialization, interchangeable with the JAX package's files
# ---------------------------------------------------------------------------

def save_pose_sequence(path: str, seq: PoseSequence, frame_names: List[str]) -> None:
    """Atomic save (tmp + os.replace) as npz keyed by the JAX package's
    names: translations, rotations, solved, frame_names."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            translations=seq.translations.detach().cpu().numpy(),
            rotations=seq.rotations.detach().cpu().numpy(),
            solved=seq.solved.detach().cpu().numpy(),
            frame_names=np.asarray(frame_names),
        )
    os.replace(tmp, path)


def load_pose_sequence(path: str, device=None) -> Tuple[PoseSequence, List[str]]:
    with np.load(path, allow_pickle=False) as data:
        seq = pose_sequence_from_jax_arrays(
            data["translations"], data["rotations"], data["solved"], device)
        names = [str(x) for x in data["frame_names"]]
    return seq, names


# ---------------------------------------------------------------------------
# Closed-form N-th root of a rigid transform (pose interpolation)
# ---------------------------------------------------------------------------

def _rotmat_log(R: torch.Tensor) -> torch.Tensor:
    """SO(3) log map: rotation matrix -> axis-angle vector [3]."""
    cos_theta = torch.clamp(0.5 * (torch.trace(R) - 1.0), -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = 0.5 * torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    # near theta = 0: w ~ axis*sin(theta), so axis*theta ~ w * theta/sin(theta)
    sin_theta = torch.sin(theta)
    scale = torch.where(sin_theta > 1e-6,
                        theta / torch.clamp(sin_theta, min=1e-12), torch.ones_like(theta))
    return w * scale


def _rotmat_exp(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exp map: axis-angle vector [3] -> rotation matrix."""
    theta = torch.linalg.vector_norm(w)
    k = w / torch.clamp(theta, min=1e-12)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    K = torch.stack([
        torch.stack([zero, -k[2], k[1]]),
        torch.stack([k[2], zero, -k[0]]),
        torch.stack([-k[1], k[0], zero]),
    ])
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(theta > 1e-8, R, eye + K * theta)


def se3_nth_root(T: torch.Tensor, n: int) -> torch.Tensor:
    """Closed-form D with D^n = T for a rigid transform T [4, 4]: rotation
    root via axis-angle / n; translation from the geometric series
    t = (I + R_d + ... + R_d^{n-1}) t_d, so t_d = S^{-1} t."""
    R = T[:3, :3]
    t = T[:3, 3]
    R_d = _rotmat_exp(_rotmat_log(R) / n)
    S = torch.zeros((3, 3), dtype=T.dtype, device=T.device)
    P = torch.eye(3, dtype=T.dtype, device=T.device)
    for _ in range(n):
        S, P = S + P, P @ R_d
    t_d = torch.linalg.solve(S, t)
    return make_se3(R_d, t_d)


def interpolate_pose_sequence(
    seq: PoseSequence, dynamic_mask: Optional[np.ndarray] = None
) -> PoseSequence:
    """Fill unsolved dynamic frames with equal per-frame N-th-root deltas
    (reference interpolate_pose.py:65-116): for each run of consecutive
    unsolved frames followed by a solved frame with delta T, every frame of
    the run and the solved frame get T^(1/(run+1)). Host-side loop over
    frames, once per stage."""
    F = seq.num_frames
    solved = seq.solved.detach().cpu().numpy()
    if dynamic_mask is None:
        dynamic_mask = np.ones(F, bool)
    trans = seq.translations.detach().cpu().clone()
    rots = seq.rotations.detach().cpu().clone()
    new_solved = solved.copy()
    run: List[int] = []
    for f in range(F):
        if not dynamic_mask[f]:
            run = []
            continue
        if solved[f]:
            if run:
                D = se3_nth_root(make_se3(rots[f], trans[f]), len(run) + 1)
                for g in run + [f]:
                    rots[g] = D[:3, :3]
                    trans[g] = D[:3, 3]
                    new_solved[g] = True
            run = []
        else:
            run.append(f)
    dev = seq.translations.device
    return PoseSequence(translations=trans.to(dev), rotations=rots.to(dev),
                        solved=torch.as_tensor(new_solved, device=dev))
