"""Synthetic 2-phase egocentric video for tests and the on-card smoke run.

Port of `egogaussian_tpu/data/synthetic.py`: a ground-truth Gaussian scene
(colored background shell + a small colored cube "object") rendered along
an orbiting camera path with the port's own `render`. During a dynamic
phase the cube moves by a known per-frame rigid step. Hand masks are a
wandering square; object masks are the object's alpha footprint.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from egogaussian_tpu_torch.ops.covariance import covariance_from_scaling_rotation
from egogaussian_tpu_torch.render.api import render
from egogaussian_tpu_torch.render.camera import Camera, look_at


@dataclasses.dataclass
class SyntheticVideo:
    cameras: List[Camera]  # with gt_image / hand_mask / obj_mask filled
    image_names: List[str]
    static_phases: List[Tuple[int, int]]  # inclusive frame-number ranges
    dynamic_phases: List[Tuple[int, int]]
    gt_obj_deltas: np.ndarray  # [F, 4, 4] per-frame object delta
    points: np.ndarray  # noisy init point cloud [N, 3]
    colors: np.ndarray  # [N, 3]
    gt_means: np.ndarray  # GT gaussian centers at rest pose
    gt_is_object: np.ndarray  # [N] bool


def _gt_scene(seed: int, n_bg: int, n_obj: int):
    rng = np.random.RandomState(seed)
    dirs = rng.randn(n_bg, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    bg_pts = dirs * 4.0  # inward-facing shell of radius 4
    bg_cols = (dirs * 0.5 + 0.5).astype(np.float32)
    obj_pts = rng.uniform(-0.4, 0.4, (n_obj, 3))  # cube of side 0.8
    obj_cols = np.clip(obj_pts + 0.6, 0, 1).astype(np.float32)
    pts = np.concatenate([bg_pts, obj_pts]).astype(np.float32)
    cols = np.concatenate([bg_cols, obj_cols])
    is_obj = np.zeros(len(pts), bool)
    is_obj[n_bg:] = True
    scales = np.where(is_obj[:, None], 0.09, 0.35).astype(np.float32)
    return pts, cols, is_obj, scales


def _se3(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def make_synthetic_video(
    device: torch.device,
    width: int = 64,
    height: int = 48,
    n_bg: int = 300,
    n_obj: int = 80,
    frames_static: int = 6,
    frames_dynamic: int = 4,
    seed: int = 0,
    with_hand: bool = True,
    n_cycles: int = 1,
) -> SyntheticVideo:
    """Alternating static/dynamic phases (n_cycles+1 static phases around
    n_cycles dynamic ones). Ground truth is rendered with the oracle, like
    the JAX package's."""
    pts, cols, is_obj, scales = _gt_scene(seed, n_bg, n_obj)
    s, d = frames_static, frames_dynamic
    total = s * (n_cycles + 1) + d * n_cycles

    deltas = np.tile(np.eye(4, dtype=np.float32), (total, 1, 1))
    ang = 0.12
    step_T = _se3(
        np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                  [0, 0, 1.0]], np.float32),
        np.array([0.12, 0.0, 0.04], np.float32),
    )
    inv_step_T = np.linalg.inv(step_T).astype(np.float32)
    for c in range(n_cycles):
        start = c * (s + d) + s
        step = step_T if c % 2 == 0 else inv_step_T
        for f in range(start, start + d):
            deltas[f] = step

    n = len(pts)
    quats = torch.zeros((n, 4), device=device)
    quats[:, 0] = 1.0
    cov3d = covariance_from_scaling_rotation(
        torch.as_tensor(np.repeat(scales, 3, axis=1).reshape(-1, 3), device=device), quats)
    opac = torch.full((n,), 0.95, device=device)
    colors_t = torch.as_tensor(cols, device=device)
    obj_t = torch.as_tensor(is_obj, device=device)
    black = torch.zeros(3, device=device)

    cameras: List[Camera] = []
    names: List[str] = []
    accum = np.eye(4, dtype=np.float32)
    focal = 0.9 * width
    rng = np.random.RandomState(seed + 1)
    for f in range(total):
        accum = deltas[f] @ accum
        moved = pts[is_obj] @ accum[:3, :3].T + accum[:3, 3]
        means = pts.copy()
        means[is_obj] = moved
        theta = 0.35 * np.sin(2 * np.pi * f / total)
        eye = np.array([3.2 * np.sin(theta), -0.4, -3.2 * np.cos(theta)])
        R, t = look_at(eye, np.array([0.0, 0.0, 0.0]))
        cam = Camera.from_colmap(R, t, focal, focal, width, height, device=device)

        with torch.no_grad():
            means_t = torch.as_tensor(means, device=device)
            out = render(cam, means_t, cov3d, opac, black, colors_precomp=colors_t,
                         backend="oracle")
            out_o = render(cam, means_t[obj_t], cov3d[obj_t], opac[obj_t], black,
                           colors_precomp=colors_t[obj_t], backend="oracle")
        obj_mask = (out_o.alpha > 0.5).to(torch.float32)

        hand = torch.zeros((1, height, width), device=device)
        if with_hand:
            hw = height // 4
            x0 = int((width - hw) * (0.5 + 0.3 * np.sin(f * 0.7)))
            y0 = height - hw - 1
            hand[0, y0:y0 + hw, x0:x0 + hw] = 1.0

        name = f"{f:06d}"
        cameras.append(dataclasses.replace(
            cam, image_name=name, gt_image=out.image, hand_mask=hand, obj_mask=obj_mask))
        names.append(name)

    noisy = pts + rng.randn(*pts.shape).astype(np.float32) * 0.02
    return SyntheticVideo(
        cameras=cameras,
        image_names=names,
        static_phases=[(c * (s + d), c * (s + d) + s - 1) for c in range(n_cycles + 1)],
        dynamic_phases=[(c * (s + d) + s, c * (s + d) + s + d - 1) for c in range(n_cycles)],
        gt_obj_deltas=deltas,
        points=noisy,
        colors=cols,
        gt_means=pts,
        gt_is_object=is_obj,
    )
