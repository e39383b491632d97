"""Seeded synthetic egocentric video and models, made on the device.

A plain-torch rewrite of the program's synthetic video (a coloured
background shell of radius 4 around a cube of side 0.8, an orbiting
camera, a hand square wandering along the bottom edge, the cube moved by
a fixed rigid step per dynamic frame), at the configuration's frame size.
Ground truth is rendered by the reference renderer and quantised to 8 bits,
as frames read from PNGs are. Everything random comes from one
`torch.Generator` per stream, seeded from `--seed`; the camera path, the
hand path, the object's motion and every count are fixed, so each seed
gives the same amount of work on other draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.reference import render as R

SHELL_RADIUS = 4.0
CUBE_HALF = 0.4
STEP_ANGLE = 0.12  # rad about z per dynamic frame
STEP_TRANSLATION = (0.12, 0.0, 0.04)


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 7919 + stream * 104729) % (2 ** 63))
    return g


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def shell_points(gen, n: int, device, jitter: float = 0.0):
    d = torch.randn((n, 3), generator=gen, device=device)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    p = d * SHELL_RADIUS
    if jitter:
        p = p + torch.randn((n, 3), generator=gen, device=device) * jitter
    return p, d * 0.5 + 0.5


def cube_points(gen, n: int, device, surface: bool = False):
    p = _uniform(gen, (n, 3), -CUBE_HALF, CUBE_HALF, device)
    if surface:  # push one coordinate of each point onto a face
        axis = torch.randint(0, 3, (n,), generator=gen, device=device)
        side = torch.randint(0, 2, (n,), generator=gen, device=device).float() * 2 - 1
        p[torch.arange(n, device=device), axis] = side * CUBE_HALF
    return p, torch.clamp(p + 0.6, 0.0, 1.0)


def step_transform(device) -> torch.Tensor:
    c, s = math.cos(STEP_ANGLE), math.sin(STEP_ANGLE)
    T = torch.tensor([[c, -s, 0, STEP_TRANSLATION[0]], [s, c, 0, STEP_TRANSLATION[1]],
                      [0, 0, 1, STEP_TRANSLATION[2]], [0, 0, 0, 1]], dtype=torch.float64)
    return T.to(torch.float32).to(device)


def object_poses(n_frames: int, dynamic: Sequence[int], device) -> torch.Tensor:
    """[F, 4, 4] accumulated object pose of each frame (the step applied at
    every frame of `dynamic`, inclusive range [a, b])."""
    step = step_transform(device)
    out, acc = [], torch.eye(4, device=device)
    for f in range(n_frames):
        if dynamic and dynamic[0] <= f <= dynamic[1]:
            acc = step @ acc
        out.append(acc)
    return torch.stack(out)


def look_at(eye: np.ndarray) -> np.ndarray:
    """World-to-camera [4, 4] looking from eye at the origin (+z forward,
    -y up)."""
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, -1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    Rw = np.stack([right, down, fwd])
    V = np.eye(4)
    V[:3, :3], V[:3, 3] = Rw, -Rw @ eye
    return V.astype(np.float32)


def camera_path(n_frames: int, width: int, height: int, lane: int = 0) -> List[np.ndarray]:
    views = []
    for f in range(n_frames):
        theta = 0.35 * math.sin(2 * math.pi * f / n_frames) + 0.2 * lane
        views.append(look_at(np.array([3.2 * math.sin(theta), -0.4, -3.2 * math.cos(theta)])))
    return views


def hand_masks(n_frames: int, width: int, height: int, device) -> torch.Tensor:
    m = torch.zeros((n_frames, 1, height, width), device=device)
    hw = height // 4
    for f in range(n_frames):
        x0 = int((width - hw) * (0.5 + 0.3 * math.sin(f * 0.7)))
        m[f, 0, height - hw - 1:height - 1, x0:x0 + hw] = 1.0
    return m


def camera(view: np.ndarray, width: int, height: int, device) -> R.Camera:
    f = 0.9 * width
    return R.Camera(torch.as_tensor(view, device=device), f, f, width / 2.0, height / 2.0,
                    width, height)


def extent(views: Sequence[np.ndarray]) -> float:
    """1.1 x the largest distance of a camera centre from their mean."""
    centers = np.stack([-v[:3, :3].T @ v[:3, 3] for v in views])
    r = float(np.linalg.norm(centers - centers.mean(0), axis=1).max()) * 1.1
    return r if r > 0 else 1.0


@dataclasses.dataclass
class GTScene:
    xyz: torch.Tensor
    cov: torch.Tensor
    opacity: torch.Tensor
    colors: torch.Tensor
    is_object: torch.Tensor


def gt_scene(seed: int, lane: int, n_bg: int, n_obj: int, device) -> GTScene:
    gen = generator(seed, 100 + lane, device)
    bg, bg_c = shell_points(gen, n_bg, device)
    ob, ob_c = cube_points(gen, n_obj, device)
    cols = torch.cat([bg_c, ob_c]) + torch.randn((n_bg + n_obj, 3), generator=gen,
                                                  device=device) * 0.12
    scale = torch.cat([torch.full((n_bg,), 0.08, device=device),
                       torch.full((n_obj,), 0.03, device=device)])
    cov = torch.diag_embed((scale ** 2)[:, None].expand(-1, 3))
    is_obj = torch.zeros(n_bg + n_obj, dtype=torch.bool, device=device)
    is_obj[n_bg:] = True
    return GTScene(torch.cat([bg, ob]), cov, torch.full((n_bg + n_obj,), 0.95, device=device),
                   torch.clamp(cols, 0.0, 1.0), is_obj)


@dataclasses.dataclass
class Video:
    views: List[np.ndarray]  # world-to-camera per frame
    width: int
    height: int
    gt: torch.Tensor  # [F, 3, H, W] in k / 255
    hand: torch.Tensor  # [F, 1, H, W]
    obj_mask: torch.Tensor  # [F, 1, H, W]
    obj_pose: torch.Tensor  # [F, 4, 4] accumulated object pose
    extent: float

    def camera(self, f: int) -> R.Camera:
        return camera(self.views[f], self.width, self.height, self.gt.device)


def make_video(seed: int, lane: int, n_frames: int, width: int, height: int,
               dynamic: Sequence[int], gt_sizes: Dict[str, int], device,
               ts: int = 16) -> Video:
    """Ground truth of one video: the GT scene with its cube at each frame's
    pose, rendered by the reference renderer; the object mask is the cube
    alone rendered at alpha > 0.5."""
    scene = gt_scene(seed, lane, gt_sizes["gt_background"], gt_sizes["gt_object"], device)
    views = camera_path(n_frames, width, height, lane)
    poses = object_poses(n_frames, dynamic, device)
    gts, masks = [], []
    black = torch.zeros(3, device=device)
    obj = scene.is_object
    with torch.no_grad():
        for f in range(n_frames):
            cam = camera(views[f], width, height, device)
            T = poses[f]
            xyz = torch.where(obj[:, None], scene.xyz @ T[:3, :3].T + T[:3, 3], scene.xyz)
            img, _, _, _ = R.render(xyz, scene.cov, scene.opacity, scene.colors, cam, black, ts)
            _, a_obj, _, _ = R.render(xyz[obj], scene.cov[obj], scene.opacity[obj],
                                      scene.colors[obj], cam, black, ts)
            gts.append(torch.round(torch.clamp(img, 0.0, 1.0) * 255.0) / 255.0)
            masks.append((a_obj > 0.5).float())
    return Video(views, width, height, torch.stack(gts), hand_masks(n_frames, width, height, device),
                 torch.stack(masks), poses, extent(views))


def init_point_cloud(seed: int, n: int, object_share: float, device):
    """The stage-1.0 point cloud: n points on the shell and in the cube,
    jittered by 0.02, coloured as the GT scene with noise."""
    gen = generator(seed, 200, device)
    n_obj = int(round(n * object_share))
    bg, bg_c = shell_points(gen, n - n_obj, device, jitter=0.02)
    ob, ob_c = cube_points(gen, n_obj, device)
    ob = ob + torch.randn(ob.shape, generator=gen, device=device) * 0.02
    cols = torch.cat([bg_c, ob_c]) + torch.randn((n, 3), generator=gen, device=device) * 0.05
    return torch.cat([bg, ob]).contiguous(), torch.clamp(cols, 0.0, 1.0).contiguous()


def splat_params(gen, xyz: torch.Tensor, colors: torch.Tensor, scale_lo: float, scale_hi: float,
                 logit_lo: float, logit_hi: float) -> Dict[str, torch.Tensor]:
    """Trained-looking Gaussians at xyz: anisotropic log-uniform scales,
    random rotations, uniform opacity logits, degree-0 SH colours."""
    n, dev = xyz.shape[0], xyz.device
    quats = torch.randn((n, 4), generator=gen, device=dev)
    return dict(
        xyz=xyz,
        features_dc=((colors - 0.5) / R.SH_C0)[:, None, :],
        log_scales=_uniform(gen, (n, 3), math.log(scale_lo), math.log(scale_hi), dev),
        quats=quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True),
        opacity_logit=_uniform(gen, (n, 1), logit_lo, logit_hi, dev),
    )
