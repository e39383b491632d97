"""Plain PyTorch training steps of EgoGaussian's stages 1.0 and 2.

The benchmark's reference for the training cells, written from the
published method (EgoGaussian, zdwww/EgoGaussian: trainers/train_static.py,
trainers/coarse_obj_pose.py, utils/loss_utils.py; 3DGS's Adam set-up) and
imports nothing of the program:

  * 3DGS initialisation from a point cloud: isotropic log-scales from the
    mean squared distance to the 3 nearest neighbours (distCUDA2, clamped
    at 1e-7), identity rotations, opacity 0.1, colours as degree-0 SH.
  * The photometric loss (1 - l) L1 + l (1 - SSIM), SSIM with an 11x11
    Gaussian window (sigma 1.5) and zero padding; gradients masked at the
    hand pixels.
  * Adam (beta 0.9 / 0.999, eps 1e-15) with a learning rate per field.
  * Stage 2: the object's rigid move by a 6D-rotation pose (Gram-Schmidt on
    the two columns), its covariance rotated along, the loss
    lambda_image [(1 - l) L1 + l (1 - SSIM)](render, gt * mask) +
    lambda_l2 L2(mask, alpha).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.render import Camera, covariance, render, sh0_colors

FIELDS = ("xyz", "features_dc", "log_scales", "quats", "opacity_logit")


def set_precision(tf32: bool) -> None:
    """float32 matmuls and convolutions (tf32=False), or TF32 (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def knn_mean_sq_dist(points: torch.Tensor, k: int = 3, exact: bool = True) -> torch.Tensor:
    """Mean of the k smallest squared distances to other points, blockwise:
    from the coordinates' differences (distCUDA2's arithmetic), or with
    exact=False from the |p|^2 + |q|^2 - 2 p.q expansion (faster; loses
    precision where the distances are small against the coordinates)."""
    n = points.shape[0]
    block = 256 if exact else 2048
    sq = (points * points).sum(-1)
    out = torch.empty(n, dtype=points.dtype, device=points.device)
    for lo in range(0, n, block):
        p = points[lo:lo + block]
        if exact:
            d2 = ((p[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        else:
            d2 = (p * p).sum(-1)[:, None] + sq[None, :] - 2.0 * (p @ points.T)
        d2[torch.arange(p.shape[0]), torch.arange(lo, lo + p.shape[0])] = math.inf
        out[lo:lo + p.shape[0]] = torch.topk(d2, k, dim=-1, largest=False).values.mean(-1)
    return out


def init_from_points(points: torch.Tensor, colors: torch.Tensor, exact: bool = True,
                     k: int = 3) -> Dict[str, torch.Tensor]:
    n = points.shape[0]
    dist = torch.sqrt(torch.clamp(knn_mean_sq_dist(points, k=k, exact=exact), min=1e-7))
    quats = torch.zeros((n, 4), device=points.device)
    quats[:, 0] = 1.0
    return dict(
        xyz=points.clone(),
        features_dc=((colors - 0.5) / 0.28209479177387814)[:, None, :],
        log_scales=torch.log(dist)[:, None].repeat(1, 3),
        quats=quats,
        opacity_logit=torch.full((n, 1), math.log(0.1 / 0.9), device=points.device),
    )


def _window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-x * x / (2 * sigma * sigma))
    return (g / g.sum()).float()


def _blur(x: torch.Tensor) -> torch.Tensor:
    """The 11x11 Gaussian window (sigma 1.5) as two 11-tap passes, each
    channel as an image of its own, zero padding."""
    g = _window().to(x.device, x.dtype)
    y = F.conv2d(x[:, None], g.reshape(1, 1, 11, 1), padding=(5, 0))
    return F.conv2d(y, g.reshape(1, 1, 1, 11), padding=(0, 5))[:, 0]


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two [C, H, W] images (3DGS's loss_utils: an 11x11
    Gaussian window, C1 = 0.01^2, C2 = 0.03^2)."""
    mu1, mu2 = _blur(a), _blur(b)
    s11 = _blur(a * a) - mu1 * mu1
    s22 = _blur(b * b) - mu2 * mu2
    s12 = _blur(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean()


def hand_masked(x: torch.Tensor, hand: torch.Tensor) -> torch.Tensor:
    """x with its gradient zeroed where hand == 1 (the value unchanged)."""
    return torch.where(hand > 0.5, x.detach(), x)


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean |a - b|, taking the slope +1 where a == b (the JAX package's and
    the port's convention; torch.abs takes 0 there)."""
    d = a - b
    return torch.where(d >= 0, d, -d).mean()


def photometric(img, gt, lambda_dssim):
    return (1.0 - lambda_dssim) * l1(img, gt) + lambda_dssim * (1.0 - ssim(img, gt))


def adam(params: Dict[str, torch.Tensor], grads, state: Optional[dict], lrs: Dict[str, float]):
    """One Adam step per field. Returns (params, state)."""
    b1, b2, eps = 0.9, 0.999, 1e-15
    if state is None:
        state = dict(t=0, m={k: torch.zeros_like(v) for k, v in params.items()},
                     v={k: torch.zeros_like(v) for k, v in params.items()})
    t = state["t"] + 1
    new, m_new, v_new = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = b1 * state["m"][k] + (1 - b1) * g
        v = b2 * state["v"][k] + (1 - b2) * g * g
        step = lrs[k] * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)
        new[k], m_new[k], v_new[k] = p - step, m, v
    return new, dict(t=t, m=m_new, v=v_new)


def expon_lr(step: int, lr_init: float, lr_final: float, max_steps: int) -> float:
    """3DGS's log-linear position schedule without delay."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return float(np.float32(math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)))


def static_lrs(it: int, opt: dict, extent: float) -> Dict[str, float]:
    """Stage 1.0's rates (3DGS training_setup) at iteration it."""
    return dict(
        xyz=expon_lr(it, opt["position_lr_init"] * extent, opt["position_lr_final"] * extent,
                     opt["position_lr_max_steps"]),
        features_dc=opt["feature_lr"], log_scales=opt["scaling_lr"],
        quats=opt["rotation_lr"], opacity_logit=opt["opacity_lr"])


def _render_params(p, cam: Camera, ts: int, bg, extra_T=None):
    xyz, cov = p["xyz"], covariance(p["log_scales"], p["quats"])
    if extra_T is not None:
        xyz = xyz @ extra_T[:3, :3].T + extra_T[:3, 3]
        cov = extra_T[:3, :3] @ cov @ extra_T[:3, :3].T
    return render(xyz, cov, torch.sigmoid(p["opacity_logit"][:, 0]), sh0_colors(p["features_dc"]),
                  cam, bg, ts)


def static_loss_grads(p: Dict[str, torch.Tensor], cam: Camera, gt, hand, lambda_dssim: float,
                      ts: int):
    """Stage 1.0's std loss on one frame and its gradients (every field,
    and the screen-space mean's, in pixels), with the visible mask."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    img, _, proj, _ = _render_params(leaves, cam, ts, torch.zeros(3, device=gt.device))
    proj.means2d.retain_grad()
    loss = photometric(hand_masked(img, hand), gt, lambda_dssim)
    loss.backward()
    grads = {k: v.grad for k, v in leaves.items()}
    return loss.detach(), grads, proj.means2d.grad, proj.radius > 0


def rot6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """[3, 2] columns -> rotation [3, 3] by Gram-Schmidt (Zhou et al. 2019)."""
    a1, a2 = d6[:, 0], d6[:, 1]
    b1 = a1 / torch.linalg.vector_norm(a1)
    b2 = a2 - (b1 * a2).sum() * b1
    b2 = b2 / torch.linalg.vector_norm(b2)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2)], dim=-1)


def pose_matrix(translation: torch.Tensor, rot6d: torch.Tensor) -> torch.Tensor:
    top = torch.cat([rot6d_to_matrix(rot6d), translation[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=translation.device)
    return torch.cat([top, bottom], dim=0)


def pose_loss_grads(p, pose: Dict[str, torch.Tensor], train_pose: bool, cam: Camera, gt, hand,
                    mask, cp: dict, ts: int):
    """Stage 2's loss on one frame and its gradients: the object at pose
    (identity when train_pose is off), against gt * mask."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    pl = {k: v.detach().requires_grad_(train_pose) for k, v in pose.items()}
    T = pose_matrix(pl["translation"], pl["rot6d"]) if train_pose else None
    img, alpha, _, _ = _render_params(leaves, cam, ts, torch.zeros(3, device=gt.device), T)
    img, alpha = hand_masked(img, hand), hand_masked(alpha, hand)
    loss = cp["lambda_image"] * photometric(img, gt * mask, cp["lambda_dssim"]) \
        + cp["lambda_Ll2_alpha"] * ((mask - alpha) ** 2).mean()
    loss.backward()
    grads = {k: v.grad for k, v in leaves.items()}
    pose_grads = {k: v.grad for k, v in pl.items()} if train_pose else None
    return loss.detach(), grads, pose_grads
