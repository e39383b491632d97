"""Hand-masked evaluation metrics.

Port of `egogaussian_tpu/eval/metrics.py` (protocol twin of reference
`trainers/eval_metric.py:129-175`): metrics are computed on
`render * (1 - hand_mask)` against `gt * (1 - hand_mask)`, PSNR and SSIM
from the port's `ops/losses.py`, LPIPS-VGG from `eval/lpips.py`.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from egogaussian_tpu_torch.ops.losses import psnr, ssim


def masked_psnr(render: torch.Tensor, gt: torch.Tensor, hand: torch.Tensor) -> torch.Tensor:
    m = 1.0 - hand
    return psnr(render * m, gt * m)


def masked_ssim(render: torch.Tensor, gt: torch.Tensor, hand: torch.Tensor) -> torch.Tensor:
    m = 1.0 - hand
    return ssim(render * m, gt * m)


def evaluate_metrics(
    renders: Sequence[np.ndarray],
    gts: Sequence[np.ndarray],
    hands: Sequence[np.ndarray],
    lpips_fn=None,
    device: torch.device = torch.device("cuda"),
) -> Dict[str, float]:
    """Mean PSNR / SSIM (and LPIPS when a callable is given) over a split;
    each [C, H, W] frame is moved to `device` for its metrics."""
    psnrs, ssims, lpipss = [], [], []
    with torch.no_grad():
        for r, g, h in zip(renders, gts, hands):
            r_t, g_t, h_t = (torch.as_tensor(np.asarray(x), device=device) for x in (r, g, h))
            psnrs.append(float(masked_psnr(r_t, g_t, h_t)))
            ssims.append(float(masked_ssim(r_t, g_t, h_t)))
            if lpips_fn is not None:
                m = 1.0 - h_t
                lpipss.append(float(torch.mean(lpips_fn(r_t * m, g_t * m))))
    out = {
        "psnr": float(np.mean(psnrs)) if psnrs else float("nan"),
        "ssim": float(np.mean(ssims)) if ssims else float("nan"),
    }
    if lpips_fn is not None:
        out["lpips"] = float(np.mean(lpipss)) if lpipss else float("nan")
    return out
