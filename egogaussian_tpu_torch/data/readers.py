"""Frame batches and phase splits.

Port of the training-path parts of `egogaussian_tpu/data/readers.py`:
frames are stacked into one FrameBatch of [F, ...] tensors on the device,
so a training step picks a frame by index with no host-device copy.
Image and mask planes that are exactly 8-bit representable are stored as
uint8 and decoded to float32 on use (img / 255), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from egogaussian_tpu_torch.render.camera import Camera


def frame_number(image_name: str) -> Optional[int]:
    """Frame index from an image name; handles the EK 'frame_0000000123'
    prefix and plain digits."""
    stem = image_name.split(".")[0]
    if stem.startswith("frame_"):
        stem = stem[len("frame_"):]
    digits = "".join(c for c in stem if c.isdigit())
    return int(digits) if digits else None


def split_viewpoints_by_phase(
    cameras: Sequence[Camera],
    phases: Sequence[Tuple[int, int]],
    training_frames: Optional[Sequence[str]] = None,
) -> List[List[int]]:
    """Partition the (sorted) camera list into per-phase index lists,
    filtered by the training-frame whitelist (reference get_viewpoint_split,
    utils/dynamic_utils.py:16-47). Phases are inclusive frame-number ranges."""
    train_set = set(training_frames) if training_frames is not None else None
    out: List[List[int]] = []
    for start, end in phases:
        idxs = []
        for i, cam in enumerate(cameras):
            num = frame_number(cam.image_name)
            if num is None:
                continue
            if start <= num <= end and (train_set is None or cam.image_name in train_set):
                idxs.append(i)
        out.append(idxs)
    return out


def dilate_mask(mask: np.ndarray, iterations: int = 5) -> np.ndarray:
    """Binary dilation with a 3x3 kernel (reference train_static_bg.py:14-21).
    mask [1, H, W]."""
    m = mask[0] > 0.5
    for _ in range(iterations):
        p = np.pad(m, 1)
        m = (
            p[:-2, 1:-1] | p[2:, 1:-1] | p[1:-1, :-2] | p[1:-1, 2:]
            | p[1:-1, 1:-1] | p[:-2, :-2] | p[:-2, 2:] | p[2:, :-2] | p[2:, 2:]
        )
    return m[None].astype(np.float32)


@dataclasses.dataclass
class FrameBatch:
    """All frames of one scene stacked on the device. hand_mask 1 = hand
    pixel (excluded from the loss), obj_mask 1 = interacted-object pixel."""

    viewmats: torch.Tensor  # [F, 4, 4]
    fx: torch.Tensor  # [F]
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    images: torch.Tensor  # [F, 3, H, W] uint8 or float32
    hand_masks: torch.Tensor  # [F, 1, H, W] uint8 or float32
    obj_masks: torch.Tensor  # [F, 1, H, W] (zeros where missing)
    obj_mask_valid: np.ndarray  # [F] bool (host): obj mask actually present
    width: int = 0
    height: int = 0

    def camera(self, f: int) -> Camera:
        return Camera(
            viewmat=self.viewmats[f], fx=self.fx[f], fy=self.fy[f],
            cx=self.cx[f], cy=self.cy[f], width=self.width, height=self.height,
        )

    @staticmethod
    def decode_mask(m: torch.Tensor) -> torch.Tensor:
        """float32 view of a possibly uint8-stored binary mask plane."""
        return m.to(torch.float32) if m.dtype == torch.uint8 else m

    @staticmethod
    def decode_image(img: torch.Tensor) -> torch.Tensor:
        """float32 view of a possibly uint8-stored image plane: img / 255,
        exactly what the loader computed from the PNG."""
        if img.dtype == torch.uint8:
            return img.to(torch.float32) / 255.0
        return img

    def frame(self, f: int):
        """(camera, gt_image, hand_mask, obj_mask) of frame f, decoded."""
        return (
            self.camera(f),
            self.decode_image(self.images[f]),
            self.decode_mask(self.hand_masks[f]),
            self.decode_mask(self.obj_masks[f]),
        )


def _as_uint8_plane(x: np.ndarray, scale: float):
    """(uint8 array, True) when x*scale is exactly 8-bit representable
    (PNG-loaded images /255, binarized masks), else (x, False)."""
    if x.size == 0:
        return x, False
    s = x * scale
    q = np.round(s)
    if float(np.abs(s - q).max()) < 1e-4 and float(q.min()) >= 0.0 and float(q.max()) <= 255.0:
        return q.astype(np.uint8), True
    return x, False


def _host(x, shape) -> np.ndarray:
    if x is None:
        return np.zeros(shape, np.float32)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def stack_cameras(cameras: Sequence[Camera], device: torch.device) -> FrameBatch:
    """Stack per-frame cameras into one FrameBatch on `device` (set-up)."""
    if not cameras:
        raise ValueError("empty camera list")
    w, h = cameras[0].width, cameras[0].height
    for c in cameras:
        if (c.width, c.height) != (w, h):
            raise ValueError("mixed resolutions in one batch")
    images, _ = _as_uint8_plane(np.stack([_host(c.gt_image, (3, h, w)) for c in cameras]), 255.0)
    hand_m, _ = _as_uint8_plane(np.stack([_host(c.hand_mask, (1, h, w)) for c in cameras]), 1.0)
    obj_m, _ = _as_uint8_plane(np.stack([_host(c.obj_mask, (1, h, w)) for c in cameras]), 1.0)

    def stack(attr):
        return torch.stack([getattr(c, attr).to(device) for c in cameras])

    return FrameBatch(
        viewmats=stack("viewmat"), fx=stack("fx"), fy=stack("fy"),
        cx=stack("cx"), cy=stack("cy"),
        images=torch.as_tensor(images).to(device),
        hand_masks=torch.as_tensor(hand_m).to(device),
        obj_masks=torch.as_tensor(obj_m).to(device),
        obj_mask_valid=np.array([c.obj_mask is not None for c in cameras]),
        width=w, height=h,
    )
