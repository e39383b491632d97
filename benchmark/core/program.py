"""Hands the benchmark's inputs to the program under test
(`egogaussian_tpu_torch`, the PyTorch and CUDA port) in its own types.

Only entries and this file import the program. The reference
(benchmark/reference) never does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch


def gaussian_model(p: Dict[str, torch.Tensor], is_object: torch.Tensor, capacity: int,
                   spatial_lr_scale: float = 1.0):
    """A GaussianModel of `capacity` rows whose first n rows are p, alive,
    with is_object from the [n] bool mask; the rest dead with the program's
    safe defaults (unit quaternion, tiny scale, opacity logit -10)."""
    from egogaussian_tpu_torch.models.gaussians import GaussianAux, GaussianModel, GaussianParams

    n = p["xyz"].shape[0]
    dev = p["xyz"].device

    def pad(x, fill):
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill, dtype=torch.float32, device=dev)
        out[:n] = x
        return out

    quats = pad(p["quats"], 0.0)
    quats[n:, 0] = 1.0
    params = GaussianParams(
        xyz=pad(p["xyz"], 0.0), features_dc=pad(p["features_dc"], 0.0),
        features_rest=torch.zeros((capacity, 0, 3), device=dev),
        log_scales=pad(p["log_scales"], -10.0), quats=quats,
        opacity_logit=pad(p["opacity_logit"], -10.0),
        label=torch.full((capacity, 1), 0.01, device=dev))
    alive = torch.zeros(capacity, dtype=torch.bool, device=dev)
    alive[:n] = True
    obj = torch.zeros(capacity, dtype=torch.int32, device=dev)
    obj[:n] = is_object.to(torch.int32)
    zeros = torch.zeros(capacity, device=dev)
    aux = GaussianAux(alive=alive, generation=torch.zeros(capacity, dtype=torch.int32, device=dev),
                      is_object=obj, max_radii2d=zeros.clone(), xyz_gradient_accum=zeros.clone(),
                      denom=zeros.clone())
    return GaussianModel(params=params, aux=aux, sh_degree=0, spatial_lr_scale=spatial_lr_scale)


def cameras(video, with_frames: bool = True) -> List:
    """The program's Camera per frame of a benchmark Video, ground truth and
    masks attached as device tensors."""
    from egogaussian_tpu_torch.render.camera import Camera

    f = 0.9 * video.width
    out = []
    for i, view in enumerate(video.views):
        cam = Camera.from_viewmat(view, f, f, video.width, video.height, video.gt.device,
                                  image_name=f"{i:06d}", cx=video.width / 2.0,
                                  cy=video.height / 2.0)
        if with_frames:
            cam = dataclasses.replace(cam, gt_image=video.gt[i], hand_mask=video.hand[i],
                                      obj_mask=video.obj_mask[i])
        out.append(cam)
    return out


def host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def rows(tree, n: int, lane: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The first n rows of every field of a dataclass of tensors (one lane of
    a scene stack with `lane`), copied to the host as float32."""
    out = {}
    for f in dataclasses.fields(tree):
        x = getattr(tree, f.name)
        if lane is not None:
            x = x[lane]
        out[f.name] = x[:n].detach().to("cpu", torch.float32).clone()
    return out
