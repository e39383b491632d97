"""Image losses and metrics on tensors.

Port of `egogaussian_tpu/ops/losses.py` (twin of reference
`utils/loss_utils.py` and `utils/image_utils.py:9-11`). SSIM uses the same
11x11 separable Gaussian window (sigma=1.5), C1=0.01^2, C2=0.03^2 and zero
SAME padding. The blur is a depthwise `F.conv2d` (the JAX package uses
XLA's depthwise conv, not a Pallas kernel). On a GPU, cuDNN runs float32
convolutions in TF32 unless `torch.backends.cudnn.allow_tf32` is False;
the trainer turns TF32 off so SSIM keeps float32 accuracy.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F


def image_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of an image [C, H, W] (or of anything up to 3-D); with a leading
    scene axis [S, C, H, W], the mean of each scene's image, [S]."""
    return torch.mean(x) if x.dim() <= 3 else torch.mean(x, dim=(-3, -2, -1))


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean |pred - target|, with the JAX package's slope +1 at 0 (torch.abs
    takes 0 there; masked-object losses have many exact zeros). Per scene
    for [S, C, H, W] inputs."""
    d = pred - target
    return image_mean(torch.where(d >= 0, d, -d))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return image_mean((pred - target) ** 2)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """PSNR per image: 20*log10(1/sqrt(mse)). Inputs [..., C, H, W] in [0,1]."""
    mse = torch.mean((pred - target) ** 2, dim=(-3, -2, -1))
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


@functools.lru_cache(maxsize=None)
def _gaussian_window(window_size: int, sigma: float):
    xs = [math.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2)) for x in range(window_size)]
    total = sum(xs)
    return tuple(x / total for x in xs)


def _depthwise_blur(img: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur per channel, zero SAME padding.
    img [C, H, W] -> [C, H, W]; [S, C, H, W] -> [S, C, H, W] in one call."""
    batched = img.dim() == 4
    x = img if batched else img[None]
    c = x.shape[1]
    w = torch.tensor(_gaussian_window(window_size, sigma), dtype=img.dtype,
                     device=img.device)
    kernel_h = w.reshape(1, 1, window_size, 1).expand(c, 1, window_size, 1)
    kernel_w = w.reshape(1, 1, 1, window_size).expand(c, 1, 1, window_size)
    pad = window_size // 2
    x = F.conv2d(x, kernel_h, padding=(pad, 0), groups=c)
    x = F.conv2d(x, kernel_w, padding=(0, pad), groups=c)
    return x if batched else x[0]


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Mean SSIM between images [C, H, W] in [0,1] (reference protocol:
    utils/loss_utils.py:66-106); per scene for [S, C, H, W] inputs."""
    C1 = 0.01**2
    C2 = 0.03**2
    # one stacked depthwise blur for the five blurred planes
    c = img1.shape[-3]
    # contiguous: the renders are views of channel-last memory, and a 4-D
    # concatenation of them stays channel-last, which cuDNN blurs with other
    # kernels than the [C, H, W] concatenation's (a no-op for that one)
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=-3).contiguous()
    blurred = _depthwise_blur(stacked, window_size, sigma)

    def plane(k):
        return blurred[..., k * c:(k + 1) * c, :, :]

    mu1 = plane(0)
    mu2 = plane(1)
    sigma1_sq = plane(2) - mu1 * mu1
    sigma2_sq = plane(3) - mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma12 = plane(4) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1 * mu1 + mu2 * mu2 + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return image_mean(ssim_map)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross-entropy with logits (mean reduction),
    written out like the JAX package's version (reference
    trainers/train_static.py:104-109 uses BCEWithLogitsLoss). Uncovered
    label pixels are exactly 0, so the tie gradients follow JAX: `maximum`
    splits 1/2 : 1/2 and |x| takes slope +1 at 0 (torch.abs would take 0)."""
    abs_logits = torch.where(logits >= 0, logits, -logits)
    return image_mean(
        torch.maximum(logits, logits.new_zeros(())) - logits * targets
        + torch.log1p(torch.exp(-abs_logits))
    )


def dice_loss(pred: torch.Tensor, target: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """Dice loss on probabilities (reference utils/loss_utils.py:18-35; no
    stage of the pipeline uses it)."""
    p = pred.reshape(-1)
    t = target.reshape(-1)
    inter = torch.sum(p * t)
    return 1.0 - (2.0 * inter + smooth) / (torch.sum(p) + torch.sum(t) + smooth)


def iou_loss(pred: torch.Tensor, target: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """IoU loss on probabilities (reference utils/loss_utils.py:38-55)."""
    p = pred.reshape(-1)
    t = target.reshape(-1)
    inter = torch.sum(p * t)
    union = torch.sum(p) + torch.sum(t) - inter
    return 1.0 - (inter + smooth) / (union + smooth)
