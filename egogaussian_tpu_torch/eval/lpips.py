"""LPIPS (Learned Perceptual Image Patch Similarity), VGG16 backbone.

Port of `egogaussian_tpu/eval/lpips.py`, the framework's own LPIPS (the
reference imports the external `lpipsPyTorch` package):

  * VGG16 feature trunk (conv slices 1-5, features after relu1_2 /
    relu2_2 / relu3_3 / relu4_3 / relu5_3),
  * input scaling by the LPIPS shift/scale constants,
  * unit-normalized channel features, 1x1 linear heads, spatial mean, sum.

A plain `torch.nn.Module` on `F.conv2d` / `F.max_pool2d` (it is no Pallas
kernel in the JAX package, so cuDNN runs it here). cuDNN would run float32
convolutions in TF32; the module turns that off, as the trainers do, so the
distance keeps float32 accuracy.

Weights are data: calibrated weights come as an .npz (keys conv{i}_w,
conv{i}_b for i in 0..12, OIHW, and lin{j} for j in 0..4), e.g. made by
`convert_torch_lpips` from torchvision's `vgg16-397923af.pth` features and
LPIPS v0.1's `vgg.pth` linear heads. Nothing is downloaded. Without weights
`LPIPS` raises unless `allow_random=True` (He-initialized stand-in weights
from `random_lpips_weights`: plumbing tests only, not a perceptual metric).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 configuration: (out_channels, num_convs) per block
_VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
# LPIPS input normalization (the standard shift/scale over [-1, 1] inputs)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


@dataclasses.dataclass
class LPIPSWeights:
    """Host arrays: 13 conv kernels OIHW, their biases, 5 linear heads [C]."""

    convs: List[np.ndarray]
    biases: List[np.ndarray]
    lins: List[np.ndarray]


def random_lpips_weights(seed: int = 0) -> LPIPSWeights:
    """He-initialized stand-in weights (uncalibrated; plumbing tests only).
    Drawn from numpy's RandomState(seed) in the JAX package's order, so both
    packages get the same weights."""
    rng = np.random.RandomState(seed)
    convs, biases = [], []
    in_c = 3
    for out_c, n in _VGG_BLOCKS:
        for _ in range(n):
            std = np.sqrt(2.0 / (in_c * 9))
            w = rng.randn(out_c, in_c, 3, 3).astype(np.float32) * std
            convs.append(w.astype(np.float32))
            biases.append(np.zeros(out_c, np.float32))
            in_c = out_c
    lins = [np.ones(c, np.float32) / c for c, _ in _VGG_BLOCKS]
    return LPIPSWeights(convs=convs, biases=biases, lins=lins)


def save_lpips_weights(weights: LPIPSWeights, path: str) -> None:
    """Write weights as the .npz that load_lpips_weights reads."""
    out = {f"conv{i}_w": w for i, w in enumerate(weights.convs)}
    out.update({f"conv{i}_b": b for i, b in enumerate(weights.biases)})
    out.update({f"lin{j}": w for j, w in enumerate(weights.lins)})
    np.savez(path, **out)


def load_lpips_weights(path: str) -> LPIPSWeights:
    """Load from .npz with keys conv{i}_w, conv{i}_b (i in 0..12, OIHW) and
    lin{j} (j in 0..4, per-channel non-negative weights)."""
    data = np.load(path)
    return LPIPSWeights(
        convs=[np.asarray(data[f"conv{i}_w"], np.float32) for i in range(13)],
        biases=[np.asarray(data[f"conv{i}_b"], np.float32) for i in range(13)],
        lins=[np.asarray(data[f"lin{j}"], np.float32) for j in range(5)],
    )


def convert_torch_lpips(vgg_state: Dict, lpips_state: Dict, out_path: str) -> None:
    """torchvision VGG16 `features` state dict + LPIPS linear-layer state
    dict -> the .npz this module loads (any mapping of name -> array-like)."""
    out = {}
    conv_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    for i, li in enumerate(conv_idx):
        out[f"conv{i}_w"] = host(vgg_state[f"features.{li}.weight"])
        out[f"conv{i}_b"] = host(vgg_state[f"features.{li}.bias"])
    for j in range(5):
        out[f"lin{j}"] = host(lpips_state[f"lin{j}.model.1.weight"]).reshape(-1)
    np.savez(out_path, **out)


class LPIPS(torch.nn.Module):
    """d(x, y) perceptual distance. Images [3, H, W] or [N, 3, H, W] in
    [0, 1]; returns [N]."""

    def __init__(
        self,
        weights: Optional[LPIPSWeights] = None,
        weights_path: Optional[str] = None,
        allow_random: bool = False,
        device: torch.device = torch.device("cuda"),
    ):
        super().__init__()
        if weights is None and weights_path is not None:
            weights = load_lpips_weights(weights_path)
        if weights is None:
            if not allow_random:
                raise ValueError(
                    "LPIPS needs calibrated weights (.npz via load_lpips_weights /"
                    " convert_torch_lpips). Pass allow_random=True for an"
                    " uncalibrated stand-in (tests only).")
            weights = random_lpips_weights()

        def params(arrays):
            return torch.nn.ParameterList(
                torch.nn.Parameter(torch.as_tensor(np.asarray(a, np.float32), device=device),
                                   requires_grad=False) for a in arrays)

        self.convs = params(weights.convs)
        self.biases = params(weights.biases)
        self.lins = params(weights.lins)
        self.register_buffer("shift", torch.as_tensor(_SHIFT, device=device)[None, :, None, None])
        self.register_buffer("scale", torch.as_tensor(_SCALE, device=device)[None, :, None, None])
        torch.backends.cudnn.allow_tf32 = False

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = (2.0 * x - 1.0 - self.shift) / self.scale  # to [-1, 1], then LPIPS scaling
        feats = []
        k = 0
        for b, (_, n) in enumerate(_VGG_BLOCKS):
            for _ in range(n):
                x = F.relu(F.conv2d(x, self.convs[k], self.biases[k], padding=1))
                k += 1
            feats.append(x)
            if b < len(_VGG_BLOCKS) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[None]
        if y.dim() == 3:
            y = y[None]
        total = 0.0
        for f1, f2, lin in zip(self.features(x), self.features(y), self.lins):
            n1 = f1 / torch.sqrt(torch.sum(f1 * f1, dim=1, keepdim=True) + 1e-10)
            n2 = f2 / torch.sqrt(torch.sum(f2 * f2, dim=1, keepdim=True) + 1e-10)
            weighted = torch.einsum("nchw,c->nhw", (n1 - n2) ** 2, lin)
            total = total + torch.mean(weighted, dim=(1, 2))
        return total
