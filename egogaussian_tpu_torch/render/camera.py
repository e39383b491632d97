"""Camera model.

Port of `egogaussian_tpu/render/camera.py`: a world-to-camera transform
plus pinhole intrinsics (fx, fy, cx, cy), with optional per-frame ground
truth planes. Tensor fields live on the camera's device; width, height and
image_name are plain Python values.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _as_tensor(x, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.tensor(np.asarray(x), device=device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """A single view. viewmat [4, 4] world-to-camera (camera looks down +z);
    fx, fy, cx, cy are 0-d float32 tensors on the same device."""

    viewmat: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int
    image_name: str = ""
    gt_image: Optional[torch.Tensor] = None  # [3, H, W]
    hand_mask: Optional[torch.Tensor] = None  # [1, H, W] 1 = hand pixel
    obj_mask: Optional[torch.Tensor] = None  # [1, H, W] 1 = object pixel

    @property
    def device(self) -> torch.device:
        return self.viewmat.device

    @property
    def camera_center(self) -> torch.Tensor:
        """Camera position in world coordinates (reference cameras.py:70)."""
        R = self.viewmat[:3, :3]
        t = self.viewmat[:3, 3]
        return -R.T @ t

    @classmethod
    def from_viewmat(
        cls,
        viewmat: np.ndarray,
        fx: float,
        fy: float,
        width: int,
        height: int,
        device: torch.device,
        image_name: str = "",
        cx: Optional[float] = None,
        cy: Optional[float] = None,
        gt_image=None,
        hand_mask=None,
        obj_mask=None,
    ) -> "Camera":
        f32 = dict(dtype=torch.float32, device=device)
        return cls(
            viewmat=torch.tensor(np.asarray(viewmat, np.float32), device=device),
            fx=torch.tensor(np.float32(fx), **f32),
            fy=torch.tensor(np.float32(fy), **f32),
            cx=torch.tensor(np.float32(width / 2.0 if cx is None else cx), **f32),
            cy=torch.tensor(np.float32(height / 2.0 if cy is None else cy), **f32),
            width=int(width),
            height=int(height),
            image_name=image_name,
            gt_image=_as_tensor(gt_image, device),
            hand_mask=_as_tensor(hand_mask, device),
            obj_mask=_as_tensor(obj_mask, device),
        )

    @classmethod
    def from_colmap(
        cls,
        R_w2c: np.ndarray,
        t_w2c: np.ndarray,
        fx: float,
        fy: float,
        width: int,
        height: int,
        device: torch.device,
        image_name: str = "",
        cx: Optional[float] = None,
        cy: Optional[float] = None,
        gt_image=None,
        hand_mask=None,
        obj_mask=None,
    ) -> "Camera":
        viewmat = np.eye(4, dtype=np.float32)
        viewmat[:3, :3] = R_w2c
        viewmat[:3, 3] = t_w2c
        return cls.from_viewmat(
            viewmat, fx, fy, width, height, device, image_name=image_name,
            cx=cx, cy=cy, gt_image=gt_image, hand_mask=hand_mask,
            obj_mask=obj_mask,
        )


def look_at(
    eye: np.ndarray, target: np.ndarray, up: np.ndarray = np.array([0.0, -1.0, 0.0])
) -> tuple[np.ndarray, np.ndarray]:
    """Build a world-to-camera (R, t) looking from eye at target (+z forward)."""
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, dtype=np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)  # world->cam rows
    t = -R @ eye
    return R.astype(np.float32), t.astype(np.float32)
