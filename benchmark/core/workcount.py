"""The yardstick's work count: FLOPs and bytes the published algorithm needs,
counted from the Gaussians and the camera by the benchmark's own code
(benchmark/reference/render.py), never from the program's layouts.

A covered evaluation is one pair-pixel with alpha >= 1/255 in front of the
point where the pixel's transmittance falls below 1e-4 (the 3DGS
compositing rule). FMAs count as 2 FLOPs, exp as 1.

Per covered evaluation:
  forward, 27: d = p - mu (2); -0.5 (a dx^2 + c dy^2) - b dx dy (9); exp (1);
    o * G, min 0.99, the 1/255 test (3); w = alpha T (1); colour, 3 FMAs (6);
    T *= 1 - alpha (2); alpha and depth sums (3).
  backward, 67: the forward's alpha again (15); T recovered (2); colour
    gradient and its sum (6); dL/dalpha over 3 channels, T and background
    (13); the running suffix, 3 FMAs (6); dL/dG, dL/dpower (2); dL/dmean
    (10); dL/dconic (9); dL/dopacity (2); the mean's sums (2).
Per Gaussian alive: projection and covariance forward 220 (rotation of the
  mean 15, J 10, J R 30, M Sigma M^T 60, conic and radius 20, R(q) S S^T R^T
  85), backward 440.
Per pixel and channel: the loss forward and backward 720 (five planes of a
  separable 11-tap blur, 44 each, the SSIM map 20, L1 10, twice backward).
Per parameter element: Adam 12.
Bytes of the compositor: each pair read once per tile, (7 + D) floats
  (mean 2, conic 3, opacity, depth, colour D); each pixel writes D + 3
  floats (colour, alpha, depth, final T); the backward reads each pair
  again, writes its 6 + D gradient floats, and reads D + 2 floats per pixel.
"""
from __future__ import annotations

from typing import Dict

FLOPS_EVAL_FWD = 27
FLOPS_EVAL_BWD = 67
FLOPS_GAUSS_FWD = 220
FLOPS_GAUSS_BWD = 440
FLOPS_LOSS_PIXEL_CHANNEL = 720
FLOPS_ADAM_ELEMENT = 12
PARAM_ELEMENTS_PER_GAUSSIAN = 14  # xyz 3, colour 3, scales 3, rotation 4, opacity 1


def compositor_bytes(pairs: float, pixels: float, d: int, backward: bool) -> float:
    fwd = pairs * (7 + d) * 4 + pixels * (d + 3) * 4
    if not backward:
        return fwd
    return fwd + pairs * ((7 + d) + (6 + d)) * 4 + pixels * (d + 2) * 4


def frame_work(evals: float, pairs: float, pixels: float, gaussians: float,
               backward: bool, d: int = 3) -> Dict[str, float]:
    """Work of one render (backward=False) or one training step on one frame
    (render forward and backward, loss, Adam)."""
    comp = evals * (FLOPS_EVAL_FWD + (FLOPS_EVAL_BWD if backward else 0))
    flops = comp + gaussians * (FLOPS_GAUSS_FWD + (FLOPS_GAUSS_BWD if backward else 0))
    if backward:
        flops += pixels * d * FLOPS_LOSS_PIXEL_CHANNEL
        flops += gaussians * PARAM_ELEMENTS_PER_GAUSSIAN * FLOPS_ADAM_ELEMENT
    return dict(compositor_flops=comp, compositor_bytes=compositor_bytes(pairs, pixels, d, backward),
                flops=flops)


def mean_work(works) -> Dict[str, float]:
    works = list(works)
    return {k: sum(w[k] for w in works) / len(works) for k in works[0]}
