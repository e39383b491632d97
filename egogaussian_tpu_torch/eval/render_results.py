"""Stage 6: render every frame at its solved pose, bucket by split, compute
hand-masked metrics, write results.txt.

Port of `egogaussian_tpu/eval/render_results.py` (behavioral twin of
reference `trainers/eval_metric.py`: render_results :41, calculate_metric
:129, the results.txt format :167-172, and the novel-view render). Frames
render one at a time under `torch.no_grad()`; each frame's image is copied
to the host once, to be quantized and written as a PNG.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from egogaussian_tpu_torch.eval.metrics import evaluate_metrics
from egogaussian_tpu_torch.models.gaussians import GaussianModel
from egogaussian_tpu_torch.models.pose import PoseSequence
from egogaussian_tpu_torch.train.common import render_gaussians
from egogaussian_tpu_torch.utils.console import CONSOLE


def _save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    arr = np.round(np.clip(img.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)


def _quantize8(img: np.ndarray) -> np.ndarray:
    """uint8 round trip. The reference computes its metrics from SAVED PNGs
    (trainers/eval_metric.py:139-161), i.e. after 8-bit quantization of both
    render and gt."""
    return (np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8).astype(np.float32)
            / 255.0)


def _host_plane(x: Optional[torch.Tensor], shape) -> np.ndarray:
    if x is None:
        return np.zeros(shape, np.float32)
    return x.detach().cpu().numpy()


def render_results(
    cameras: Sequence,
    model: GaussianModel,
    pose_seq: PoseSequence,
    training_frames: Optional[Sequence[str]] = None,
    dynamic_eval_frames: Optional[Sequence[str]] = None,
    static_eval_frames: Optional[Sequence[str]] = None,
    save_dir: Optional[str] = None,
    backend: str = "tiled",
) -> Dict[str, List[dict]]:
    """Render every camera at its accumulated object pose
    (render_gaussians(pose_T=accum_T[f], extra_rot=accum_R[f])) and bucket
    the results into training / dynamic_eval / static_eval / other
    (eval_metric.py:41-127).

    Returns {bucket: [{name, render, gt, hand}]} as quantized numpy arrays;
    also writes PNGs (render + 1 - hand mask) under save_dir/<bucket>/ when
    given. A camera without a hand mask counts as hand-free."""
    accum_T = pose_seq.accum_T()
    accum_R = pose_seq.accum_R()
    bg = torch.zeros(3, device=model.device)
    train_set = set(training_frames or [])
    dyn_set = set(dynamic_eval_frames or [])
    stat_set = set(static_eval_frames or [])
    buckets: Dict[str, List[dict]] = {
        "training": [], "dynamic_eval": [], "static_eval": [], "other": [],
    }
    for f, cam in enumerate(cameras):
        with torch.no_grad():
            res = render_gaussians(model, cam, bg, pose_T=accum_T[f], extra_rot=accum_R[f],
                                   backend=backend)
        img = res.image.cpu().numpy()
        name = cam.image_name
        if name in dyn_set:
            bucket = "dynamic_eval"
        elif name in stat_set:
            bucket = "static_eval"
        elif name in train_set or not train_set:
            bucket = "training"
        else:
            bucket = "other"
        entry = dict(
            name=name,
            render=_quantize8(img),
            gt=_quantize8(_host_plane(cam.gt_image, (3, cam.height, cam.width))),
            hand=_quantize8(_host_plane(cam.hand_mask, (1, cam.height, cam.width))),
        )
        buckets[bucket].append(entry)
        if save_dir:
            d = os.path.join(save_dir, bucket)
            os.makedirs(d, exist_ok=True)
            _save_png(os.path.join(d, f"{name}.png"), img)
            _save_png(os.path.join(d, f"{name}_mask.png"), 1.0 - entry["hand"])
    return buckets


def calculate_metric(
    buckets: Dict[str, List[dict]],
    save_dir: Optional[str] = None,
    lpips_fn=None,
    device: torch.device = torch.device("cpu"),
) -> Dict[str, Dict[str, float]]:
    """Hand-masked PSNR/SSIM/LPIPS per eval bucket, computed on `device`,
    and results.txt in the JAX package's layout (eval_metric.py:129-175)."""
    results: Dict[str, Dict[str, float]] = {}
    for bucket in ("dynamic_eval", "static_eval"):
        entries = buckets.get(bucket, [])
        if not entries:
            continue
        results[bucket] = evaluate_metrics(
            [e["render"] for e in entries], [e["gt"] for e in entries],
            [e["hand"] for e in entries], lpips_fn=lpips_fn, device=device)
        CONSOLE.log(f"[eval] {bucket}: {results[bucket]}")
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "results.txt"), "w") as f:
            for bucket, m in results.items():
                f.write(f"{bucket}\n")
                f.write(f"  SSIM : {m.get('ssim', float('nan')):.7f}\n")
                f.write(f"  PSNR : {m.get('psnr', float('nan')):.7f}\n")
                if "lpips" in m:
                    f.write(f"  LPIPS: {m['lpips']:.7f}\n")
                else:
                    # explicit, not silent: the reference protocol's third
                    # metric needs pretrained VGG16+LPIPS weights
                    f.write("  LPIPS: unavailable (no pretrained weights; "
                            "pass --lpips_weights <npz> — see "
                            "eval/lpips.py)\n")
    return results


def render_novel_view(
    model: GaussianModel,
    camera,
    pose_T: Optional[torch.Tensor] = None,
    pose_R: Optional[torch.Tensor] = None,
    backend: str = "tiled",
) -> np.ndarray:
    """Render from an arbitrary camera with an optional object pose
    (viewer / trajectory paths, eval_metric.py:181-496)."""
    with torch.no_grad():
        res = render_gaussians(model, camera, torch.zeros(3, device=model.device),
                               pose_T=pose_T, extra_rot=pose_R, backend=backend)
    return res.image.cpu().numpy()
