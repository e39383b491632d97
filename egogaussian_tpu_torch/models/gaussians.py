"""Gaussian model: a fixed-capacity dataclass of tensors with an alive mask.

Port of `egogaussian_tpu/models/gaussians.py`. Densify/clone/prune are
masked writes at fixed capacity; capacity grows by doubling on the host at
densify intervals. Activations match the reference (scaling=exp,
opacity=sigmoid, rotation=normalized quaternion). The PLY schema is
byte-compatible with the reference (x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,
scale_*,rot_*,label,generation,is_object).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from egogaussian_tpu_torch.ops.covariance import (
    covariance_from_scaling_rotation,
    covariance_from_scaling_rotation_rotated,
)
from egogaussian_tpu_torch.ops.knn import mean_sq_dist_to_knn
from egogaussian_tpu_torch.ops.sh import rgb_to_sh
from egogaussian_tpu_torch.utils.logging import spanned


def inverse_sigmoid(x: float) -> float:
    return float(np.log(x / (1.0 - x)))


@dataclasses.dataclass
class GaussianParams:
    """Trainable leaves, all of length == capacity."""

    xyz: torch.Tensor  # [C, 3]
    features_dc: torch.Tensor  # [C, 1, 3]
    features_rest: torch.Tensor  # [C, K-1, 3]
    log_scales: torch.Tensor  # [C, 3]
    quats: torch.Tensor  # [C, 4] wxyz (normalized on use)
    opacity_logit: torch.Tensor  # [C, 1]
    label: torch.Tensor  # [C, 1] trainable object identity (raw float)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def map(self, fn) -> "GaussianParams":
        """New GaussianParams with fn applied to every field."""
        return GaussianParams(**{k: fn(v) for k, v in self.as_dict().items()})


@dataclasses.dataclass
class GaussianAux:
    """Non-trainable per-Gaussian state, all of length == capacity."""

    alive: torch.Tensor  # [C] bool
    generation: torch.Tensor  # [C] int32 densification birth cohort
    is_object: torch.Tensor  # [C] int32 0/1 static segmentation
    max_radii2d: torch.Tensor  # [C] float32
    xyz_gradient_accum: torch.Tensor  # [C] float32
    denom: torch.Tensor  # [C] float32

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


PARAM_FIELDS = tuple(f.name for f in dataclasses.fields(GaussianParams))
AUX_FIELDS = tuple(f.name for f in dataclasses.fields(GaussianAux))


@dataclasses.dataclass
class GaussianModel:
    params: GaussianParams
    aux: GaussianAux
    sh_degree: int = 0
    spatial_lr_scale: float = 1.0
    # a scene stack's own row count per scene (parallel/multi_scene.py
    # stack_scenes); None for one model
    scene_rows: Optional[Tuple[int, ...]] = None

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.params.xyz.device

    @property
    def scaling(self) -> torch.Tensor:
        return torch.exp(self.params.log_scales)

    @property
    def opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.params.opacity_logit[..., 0])

    def covariance(self, scale_modifier: float = 1.0) -> torch.Tensor:
        return _covariance(self.params.log_scales, self.params.quats, scale_modifier)

    def covariance_rotated(self, extra_rot: torch.Tensor, which_object: int = 1,
                           scale_modifier: float = 1.0) -> torch.Tensor:
        """Covariance with the object Gaussians (is_object == which_object)
        rotated by extra_rot [3, 3] (reference gaussian_model.py:46-63)."""
        mask = self.aux.is_object == which_object
        return _covariance(self.params.log_scales, self.params.quats, scale_modifier,
                           extra_rot, mask, self.scene_rows)

    @property
    def num_alive(self) -> torch.Tensor:
        """Device scalar (reading it on the host is a sync)."""
        return torch.sum(self.aux.alive.to(torch.int32))

    def infer_is_object_from_label(self, threshold: float = 0.5) -> "GaussianModel":
        """Threshold the trainable label into the hard is_object
        segmentation (reference gaussian_model.py:1116-1121)."""
        is_obj = (self.params.label[:, 0] > threshold).to(torch.int32)
        return dataclasses.replace(
            self, aux=dataclasses.replace(self.aux, is_object=is_obj)
        )


@spanned("project")
def _covariance(log_scales, quats, scale_modifier, extra_rot=None, mask=None, rows=None):
    """The packed covariance from the activated scales, with the rows of
    `mask` rotated by extra_rot where given (the projection's first part)."""
    scales = torch.exp(log_scales)
    if extra_rot is None:
        return covariance_from_scaling_rotation(scales, quats, scale_modifier)
    return covariance_from_scaling_rotation_rotated(scales, quats, extra_rot, mask,
                                                    scale_modifier, rows=rows)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _empty_params(capacity: int, sh_degree: int, device) -> GaussianParams:
    k_rest = (sh_degree + 1) ** 2 - 1
    f32 = dict(dtype=torch.float32, device=device)
    quats = torch.zeros((capacity, 4), **f32)
    quats[:, 0] = 1.0
    return GaussianParams(
        xyz=torch.zeros((capacity, 3), **f32),
        features_dc=torch.zeros((capacity, 1, 3), **f32),
        features_rest=torch.zeros((capacity, k_rest, 3), **f32),
        log_scales=torch.full((capacity, 3), -10.0, **f32),
        quats=quats,
        opacity_logit=torch.full((capacity, 1), -10.0, **f32),
        label=torch.full((capacity, 1), 0.01, **f32),
    )


def _empty_aux(capacity: int, device) -> GaussianAux:
    return GaussianAux(
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
        generation=torch.zeros((capacity,), dtype=torch.int32, device=device),
        is_object=torch.zeros((capacity,), dtype=torch.int32, device=device),
        max_radii2d=torch.zeros((capacity,), dtype=torch.float32, device=device),
        xyz_gradient_accum=torch.zeros((capacity,), dtype=torch.float32, device=device),
        denom=torch.zeros((capacity,), dtype=torch.float32, device=device),
    )


def _filled(capacity: int, sh_degree: int, device, params: dict, aux: dict, n: int):
    """Fresh model state with the first n rows set from numpy/tensors."""
    p = _empty_params(capacity, sh_degree, device)
    a = _empty_aux(capacity, device)

    def dev(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        return torch.tensor(np.asarray(v), device=device)

    for k, v in params.items():
        getattr(p, k)[:n] = dev(v)
    for k, v in aux.items():
        getattr(a, k)[:n] = dev(v)
    a.alive[:n] = True
    return p, a


def from_points(
    points: np.ndarray,
    colors: np.ndarray,
    device: torch.device,
    sh_degree: int = 0,
    spatial_lr_scale: float = 1.0,
    capacity: Optional[int] = None,
    rand_pts_init: Optional[int] = None,
    rand_label_init: bool = False,
    seed: int = 0,
) -> GaussianModel:
    """Initialize from a point cloud (reference create_from_pcd,
    gaussian_model.py:274-338): kNN-seeded isotropic log-scales, identity
    quats, opacity sigmoid^-1(0.1), label 0.01 (or uniform random). Host
    randomness comes from np.random.RandomState(seed), as in the JAX
    package, so both draw the same values."""
    rng = np.random.RandomState(seed)
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.float32)
    if rand_pts_init is not None:
        points = rng.uniform(points.min(), points.max(), (rand_pts_init, 3)).astype(np.float32)
        colors = rng.uniform(colors.min(), colors.max(), (rand_pts_init, 3)).astype(np.float32)
    n = points.shape[0]
    if capacity is None:
        capacity = _next_pow2(max(2 * n, 1024))
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} points")

    pts = torch.as_tensor(points, device=device)
    dist2 = torch.clamp(mean_sq_dist_to_knn(pts, k=3), min=1e-7)
    log_scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    label0 = (
        rng.rand(n, 1).astype(np.float32)
        if rand_label_init
        else np.full((n, 1), 0.01, np.float32)
    )
    f_dc = rgb_to_sh(torch.as_tensor(colors, device=device))[:, None, :]
    params, aux = _filled(
        capacity, sh_degree, device,
        dict(xyz=pts, features_dc=f_dc, log_scales=log_scales,
             opacity_logit=np.full((n, 1), inverse_sigmoid(0.1), np.float32),
             label=label0),
        {}, n,
    )
    return GaussianModel(params=params, aux=aux, sh_degree=sh_degree,
                         spatial_lr_scale=spatial_lr_scale)


def from_jax_arrays(
    params: Dict[str, np.ndarray],
    aux: Dict[str, np.ndarray],
    device: torch.device,
    sh_degree: int = 0,
    spatial_lr_scale: float = 1.0,
) -> GaussianModel:
    """Build a model from the JAX package's GaussianParams / GaussianAux
    fields, given as dicts of numpy arrays (field name -> array), so both
    packages can start from identical state."""
    p = GaussianParams(**{k: torch.tensor(np.asarray(params[k], np.float32), device=device)
                          for k in PARAM_FIELDS})
    a = GaussianAux(
        alive=torch.tensor(np.asarray(aux["alive"], bool), device=device),
        generation=torch.tensor(np.asarray(aux["generation"], np.int32), device=device),
        is_object=torch.tensor(np.asarray(aux["is_object"], np.int32), device=device),
        max_radii2d=torch.tensor(np.asarray(aux["max_radii2d"], np.float32), device=device),
        xyz_gradient_accum=torch.tensor(np.asarray(aux["xyz_gradient_accum"], np.float32),
                                        device=device),
        denom=torch.tensor(np.asarray(aux["denom"], np.float32), device=device),
    )
    return GaussianModel(params=p, aux=a, sh_degree=sh_degree,
                         spatial_lr_scale=spatial_lr_scale)


def compact(model: GaussianModel, capacity: Optional[int] = None) -> GaussianModel:
    """Pack alive Gaussians to the front and resize capacity (host sync;
    between stages and before saving)."""
    idx = torch.nonzero(model.aux.alive).flatten()
    n = int(idx.numel())
    if capacity is None:
        capacity = _next_pow2(max(2 * n, 1024))
    params, aux = _filled(
        capacity, model.sh_degree, model.device,
        {k: v[idx] for k, v in model.params.as_dict().items()},
        {k: v[idx] for k, v in model.aux.as_dict().items() if k != "alive"},
        n,
    )
    return dataclasses.replace(model, params=params, aux=aux)


def ensure_capacity(model: GaussianModel, opt_state, min_free: Optional[int] = None):
    """If fewer than `min_free` dead slots remain, double the capacity
    (host sync; densify intervals only). Params are padded with the safe
    per-field defaults (a zero quaternion has a NaN normalize-gradient),
    aux and Adam moments with zeros. Returns (model, opt_state, grew)."""
    n = int(model.num_alive)
    C = model.capacity
    if min_free is None:
        min_free = max(C // 8, 256)
    if C - n >= min_free:
        return model, opt_state, False
    new_c = C * 2
    fresh = _empty_params(new_c, model.sh_degree, model.device)
    params = GaussianParams(**{
        k: torch.cat([v, getattr(fresh, k)[C:]], dim=0)
        for k, v in model.params.as_dict().items()
    })

    def pad(x):
        return torch.cat([x, torch.zeros((C,) + tuple(x.shape[1:]), dtype=x.dtype,
                                         device=x.device)], dim=0)

    aux = GaussianAux(**{k: pad(v) for k, v in model.aux.as_dict().items()})
    new_model = dataclasses.replace(model, params=params, aux=aux)
    new_opt = dataclasses.replace(opt_state, mu=opt_state.mu.map(pad),
                                  nu=opt_state.nu.map(pad))
    return new_model, new_opt, True


def combine_models(a: GaussianModel, b: GaussianModel) -> GaussianModel:
    """Concatenate two models, a's Gaussians first (reference
    combine_gaussians, gaussian_model.py:1072-1089): both compacted, at
    capacity next_pow2(max(2 (na + nb), 1024)), with a's sh_degree and
    spatial_lr_scale (host sync; stage 5 merges the object and the
    background with it)."""
    a, b = compact(a), compact(b)
    na, nb = int(a.num_alive), int(b.num_alive)
    capacity = _next_pow2(max(2 * (na + nb), 1024))

    def cat(x, y):
        return torch.cat([x[:na], y[:nb].to(a.device)], dim=0)

    params, aux = _filled(
        capacity, a.sh_degree, a.device,
        {k: cat(v, getattr(b.params, k)) for k, v in a.params.as_dict().items()},
        {k: cat(v, getattr(b.aux, k)) for k, v in a.aux.as_dict().items() if k != "alive"},
        na + nb,
    )
    return dataclasses.replace(a, params=params, aux=aux)


def split_by_is_object(model: GaussianModel):
    """(object-only, background-only) compacted models."""
    alive = model.aux.alive
    obj = dataclasses.replace(
        model, aux=dataclasses.replace(model.aux, alive=alive & (model.aux.is_object == 1)))
    bg = dataclasses.replace(
        model, aux=dataclasses.replace(model.aux, alive=alive & (model.aux.is_object == 0)))
    return compact(obj), compact(bg)


_POINT_COLORS = {
    "red": (1.0, 0.05, 0.05),
    "blue": (0.05, 0.05, 1.0),
    "green": (0.05, 0.8, 0.1),
}


def make_it_a_point(model: GaussianModel, color: str = "red", scale: float = 0.02
                    ) -> GaussianModel:
    """Collapse the model to one opaque blob of `color` (red, blue or
    green; red for any other name) and radius `scale` at its alive
    centroid, in a capacity-128 model: the trajectory viewers' marker
    (reference make_it_a_point, gaussian_model.py:1091-1114)."""
    w = model.aux.alive.to(torch.float32)[:, None]
    centroid = torch.sum(model.params.xyz * w, dim=0) / torch.clamp(torch.sum(w), min=1.0)
    capacity = 128
    dev = model.device
    params = _empty_params(capacity, model.sh_degree, dev)
    aux = _empty_aux(capacity, dev)
    rgb = torch.tensor(_POINT_COLORS.get(color, _POINT_COLORS["red"]), dtype=torch.float32,
                       device=dev)
    params.xyz[0] = centroid
    params.features_dc[0, 0] = rgb_to_sh(rgb)
    params.log_scales[0] = torch.log(torch.tensor(scale, dtype=torch.float32, device=dev))
    params.opacity_logit[0] = 8.0  # sigmoid ~ 1
    aux.alive[0] = True
    aux.is_object[0] = 1
    return dataclasses.replace(model, params=params, aux=aux)


# ---------------------------------------------------------------------------
# PLY IO — byte-compatible with the reference schema
# ---------------------------------------------------------------------------

def save_ply(model: GaussianModel, path: str) -> None:
    """Write alive Gaussians in the reference's extended-3DGS PLY schema
    (gaussian_model.py:375-397)."""
    from egogaussian_tpu_torch.utils.ply import write_ply

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    alive = model.aux.alive.cpu().numpy()
    idx = np.nonzero(alive)[0]

    def host(x):
        return x.detach().cpu().numpy()[idx]

    xyz = host(model.params.xyz)
    n = xyz.shape[0]
    normals = np.zeros_like(xyz)
    k_dc = model.params.features_dc.shape[1]
    k_rest = model.params.features_rest.shape[1]
    f_dc = host(model.params.features_dc).transpose(0, 2, 1).reshape(n, 3 * k_dc)
    f_rest = host(model.params.features_rest).transpose(0, 2, 1).reshape(n, 3 * k_rest)
    opacity = host(model.params.opacity_logit)
    scales = host(model.params.log_scales)
    rots = host(model.params.quats)
    labels = host(model.params.label)
    gens = host(model.aux.generation).astype(np.float32)[:, None]
    is_obj = host(model.aux.is_object).astype(np.float32)[:, None]

    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(f_dc.shape[1])]
    names += [f"f_rest_{i}" for i in range(f_rest.shape[1])]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(scales.shape[1])]
    names += [f"rot_{i}" for i in range(rots.shape[1])]
    names += ["label", "generation", "is_object"]
    attributes = np.concatenate(
        [xyz, normals, f_dc, f_rest, opacity, scales, rots, labels, gens, is_obj],
        axis=1,
    )
    write_ply(path, names, attributes)


def load_ply(
    path: str,
    device: torch.device,
    sh_degree: int = 0,
    is_object: bool = False,
    force_bg: bool = False,
    capacity: Optional[int] = None,
    spatial_lr_scale: float = 1.0,
) -> GaussianModel:
    """Load a (reference-compatible) PLY into a fresh model
    (gaussian_model.py:399-480 semantics incl. missing-field defaults)."""
    from egogaussian_tpu_torch.utils.ply import read_ply

    v, _ = read_ply(path)
    names = tuple(v.keys())
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    n = xyz.shape[0]
    opacity = np.asarray(v["opacity"], np.float32)[:, None]
    f_dc = np.stack([v["f_dc_0"], v["f_dc_1"], v["f_dc_2"]], axis=1).astype(np.float32)

    def sorted_fields(prefix):
        return sorted((x for x in names if x.startswith(prefix)),
                      key=lambda s: int(s.split("_")[-1]))

    rest_names = sorted_fields("f_rest_")
    k_rest = (sh_degree + 1) ** 2 - 1
    if len(rest_names) != 3 * k_rest:
        raise ValueError(f"{path}: {len(rest_names)} f_rest fields, sh_degree "
                         f"{sh_degree} needs {3 * k_rest}")
    if rest_names:
        f_rest = np.stack([v[x] for x in rest_names], axis=1).astype(np.float32)
        f_rest = f_rest.reshape(n, 3, k_rest).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    scales = np.stack([v[x] for x in sorted_fields("scale_")], axis=1).astype(np.float32)
    rots = np.stack([v[x] for x in sorted_fields("rot_")], axis=1).astype(np.float32)
    labels = (np.asarray(v["label"], np.float32)[:, None] if "label" in names
              else np.full((n, 1), 0.01, np.float32))
    gens = (np.asarray(v["generation"]).astype(np.int32) if "generation" in names
            else np.zeros(n, np.int32))
    if "is_object" in names:
        is_obj = np.asarray(v["is_object"]).astype(np.int32)
    else:
        is_obj = np.full(n, 1 if is_object else 0, np.int32)
    if force_bg:
        is_obj = np.zeros(n, np.int32)

    if capacity is None:
        capacity = _next_pow2(max(2 * n, 1024))
    params, aux = _filled(
        capacity, sh_degree, device,
        dict(xyz=xyz, features_dc=f_dc[:, None, :], features_rest=f_rest,
             log_scales=scales, quats=rots, opacity_logit=opacity, label=labels),
        dict(generation=gens, is_object=is_obj),
        n,
    )
    return GaussianModel(params=params, aux=aux, sh_degree=sh_degree,
                         spatial_lr_scale=spatial_lr_scale)
