"""Densification and pruning as fixed-capacity masked writes.

Port of `egogaussian_tpu/models/densify.py` (reference
gaussian_model.py:588-748 and the opacity resets :485-501):

  * clone candidates  = copies of selected rows
  * split candidates  = 2 rows sampled from the parent's anisotropic
    Gaussian, scales /(0.8*2); the parent is killed
  * candidates go to dead slots found by ranking the free slots; overflow
    beyond free capacity is dropped and counted
  * pruning clears `alive`; Adam moments of changed slots are zeroed.

Writes that JAX does with mode="drop" go through a buffer with one
sentinel row, which is sliced off.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from egogaussian_tpu_torch.models.gaussians import (
    GaussianAux,
    GaussianModel,
    GaussianParams,
)
from egogaussian_tpu_torch.models.optim import (
    AdamState,
    zero_moments_field,
    zero_moments_where,
)
from egogaussian_tpu_torch.ops.quaternion import quat_to_rotmat


class DensifyResult(NamedTuple):
    model: GaussianModel
    opt_state: AdamState
    num_cloned: torch.Tensor
    num_split: torch.Tensor
    num_pruned: torch.Tensor
    overflow: torch.Tensor  # candidates dropped for lack of free capacity


def add_densification_stats(
    model: GaussianModel, means2d_grad: torch.Tensor, radii: torch.Tensor
) -> GaussianModel:
    """Accumulate screen-space gradient norms of visible Gaussians
    (reference add_densification_stats; visibility filter radii > 0)."""
    visible = radii > 0
    gnorm = torch.linalg.vector_norm(means2d_grad[..., :2], dim=-1)
    zero = torch.zeros_like(gnorm)
    aux = dataclasses.replace(
        model.aux,
        xyz_gradient_accum=model.aux.xyz_gradient_accum + torch.where(visible, gnorm, zero),
        denom=model.aux.denom + visible.to(torch.float32),
        max_radii2d=torch.maximum(
            model.aux.max_radii2d, torch.where(visible, radii.to(torch.float32), zero)),
    )
    return dataclasses.replace(model, aux=aux)


_PCG_MUL = 747796405
_PCG_INC = 2891336453
_MASK32 = 0xFFFFFFFF


def _pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG-RXS-M-XS 32-bit hash on int64 tensors holding uint32 values."""
    state = (x * _PCG_MUL + _PCG_INC) & _MASK32
    word = ((state >> ((state >> 28) + 4)) ^ state) * 277803737 & _MASK32
    return ((word >> 22) ^ word) & _MASK32


def split_noise(seed: int, capacity: int, device) -> torch.Tensor:
    """Standard-normal split offsets [2, C, 3], drawn per SLOT from a
    counter-based hash of (seed, slot index, draw index) and Box-Muller.
    A slot's values depend only on (seed, slot), never on the capacity, so
    the same scene densifies the same way at any padded capacity (the
    property the JAX package gets from per-slot fold_in keys)."""
    slot = torch.arange(capacity, dtype=torch.int64, device=device)
    draw = torch.arange(12, dtype=torch.int64, device=device)
    key = _pcg_hash(torch.tensor(seed & _MASK32, dtype=torch.int64, device=device))
    bits = _pcg_hash(key ^ _pcg_hash(slot[:, None] * 12 + draw[None, :]))  # [C, 12]
    u = (bits >> 8).to(torch.float64) * (1.0 / (1 << 24))  # [0, 1)
    u1 = 1.0 - u[:, 0::2]  # (0, 1]
    u2 = u[:, 1::2]
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * torch.pi * u2)  # [C, 6]
    return z.to(torch.float32).reshape(capacity, 2, 3).transpose(0, 1)


def _scatter_rows(dst: torch.Tensor, slot_idx: torch.Tensor, src: torch.Tensor,
                  ok: torch.Tensor) -> torch.Tensor:
    """dst.at[where(ok, slot_idx, OOB)].set(src, mode="drop"): rows with
    ok False go to a sentinel row that is sliced off."""
    c = dst.shape[0]
    idx = torch.where(ok, slot_idx, torch.full_like(slot_idx, c))
    buf = torch.cat([dst, dst[:1]], dim=0)
    buf[idx] = src.to(dst.dtype)
    return buf[:c]


def densify_and_prune(
    model: GaussianModel,
    opt_state: AdamState,
    seed: int,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: Optional[float],
    percent_dense: float = 0.01,
    clone: bool = True,
    split: bool = True,
    curr_gen: Optional[int] = None,
    prune_prev_gen: bool = True,
    split_prev_gen: bool = True,
    which_object: Optional[int] = None,
    noise: Optional[torch.Tensor] = None,
) -> DensifyResult:
    """One densify+prune pass (reference densify_and_prune incl. the
    generation/object filters). Resets the densification stats after.

    `seed` selects the split offsets (see split_noise); `noise` [2, C, 3]
    standard normals, when given, replaces that draw (tests inject the JAX
    package's draw this way)."""
    p, a = model.params, model.aux
    C = p.xyz.shape[0]
    dev = p.xyz.device
    alive = a.alive

    grads = a.xyz_gradient_accum / torch.clamp(a.denom, min=1e-12)
    grads = torch.where(torch.isnan(grads) | (a.denom == 0), torch.zeros_like(grads), grads)
    scaling = torch.exp(p.log_scales)
    max_scale = torch.amax(scaling, dim=1)

    base_sel = alive & (grads >= max_grad)
    if which_object is not None:
        base_sel = base_sel & (a.is_object == which_object)
    clone_sel = base_sel & (max_scale <= percent_dense * extent)
    split_sel = base_sel & (max_scale > percent_dense * extent)
    if not split_prev_gen:
        if curr_gen is None:
            raise ValueError("split_prev_gen=False needs curr_gen")
        split_sel = split_sel & (a.generation == curr_gen)
    if not clone:
        clone_sel = torch.zeros_like(clone_sel)
    if not split:
        split_sel = torch.zeros_like(split_sel)

    new_gen_of = a.generation if curr_gen is None else torch.full_like(a.generation, curr_gen)

    # candidates, fixed shape [3C] = C clones + 2C split children
    if noise is None:
        noise = split_noise(seed, C, dev)
    samples = noise.to(dev) * scaling[None]  # [2, C, 3]
    R = quat_to_rotmat(p.quats)  # [C, 3, 3]
    offsets = torch.einsum("cij,ncj->nci", R, samples)
    split_xyz = p.xyz[None] + offsets
    split_log_scales = torch.log(scaling / (0.8 * 2.0))

    def cand(field_clone, field_split):
        return torch.cat([field_clone, field_split, field_split], dim=0)

    cand_params = GaussianParams(
        xyz=torch.cat([p.xyz, split_xyz[0], split_xyz[1]], dim=0),
        features_dc=cand(p.features_dc, p.features_dc),
        features_rest=cand(p.features_rest, p.features_rest),
        log_scales=cand(p.log_scales, split_log_scales),
        quats=cand(p.quats, p.quats),
        opacity_logit=cand(p.opacity_logit, p.opacity_logit),
        label=cand(p.label, p.label),
    )
    cand_gen = torch.cat([new_gen_of, new_gen_of, new_gen_of], dim=0)
    cand_is_obj = a.is_object.repeat(3)
    cand_mask = torch.cat([clone_sel, split_sel, split_sel], dim=0)  # [3C]

    # prune mask on existing rows
    opacity = torch.sigmoid(p.opacity_logit[:, 0])
    prune_mask = opacity < min_opacity
    if max_screen_size is not None:
        prune_mask = prune_mask | (a.max_radii2d > max_screen_size) | (max_scale > 0.1 * extent)
    if not prune_prev_gen:
        if curr_gen is None:
            raise ValueError("prune_prev_gen=False needs curr_gen")
        prune_mask = prune_mask & (a.generation == curr_gen)
    prune_mask = (prune_mask | split_sel) & alive  # split parents die
    alive_after_prune = alive & ~prune_mask

    # slot assignment: the r-th candidate goes to the r-th free slot
    free = ~alive_after_prune
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    num_free = torch.sum(free.to(torch.int64))
    ar = torch.arange(C, dtype=torch.int64, device=dev)
    free_slots = _scatter_rows(torch.full((C,), C, dtype=torch.int64, device=dev),
                               free_rank, ar, free)
    cand_rank = torch.cumsum(cand_mask.to(torch.int64), 0) - 1
    fits = cand_mask & (cand_rank < num_free)
    slot_of_cand = free_slots[torch.clamp(cand_rank, 0, C - 1)]

    new_params = GaussianParams(**{
        k: _scatter_rows(v, slot_of_cand, getattr(cand_params, k), fits)
        for k, v in p.as_dict().items()
    })
    new_alive = _scatter_rows(alive_after_prune, slot_of_cand,
                              torch.ones_like(cand_mask), fits)
    new_aux = GaussianAux(
        alive=new_alive,
        generation=_scatter_rows(a.generation, slot_of_cand, cand_gen, fits),
        is_object=_scatter_rows(a.is_object, slot_of_cand, cand_is_obj, fits),
        # postfix resets stats for ALL points (gaussian_model.py:579-581)
        max_radii2d=torch.zeros_like(a.max_radii2d),
        xyz_gradient_accum=torch.zeros_like(a.xyz_gradient_accum),
        denom=torch.zeros_like(a.denom),
    )
    # moments: zero for any slot whose occupant changed (new fills) or died
    changed = ~new_alive | (new_alive & ~alive_after_prune)
    new_opt_state = zero_moments_where(opt_state, changed)

    is_clone = torch.arange(3 * C, device=dev) < C
    return DensifyResult(
        model=dataclasses.replace(model, params=new_params, aux=new_aux),
        opt_state=new_opt_state,
        num_cloned=torch.sum(fits & is_clone),
        num_split=torch.sum(fits & ~is_clone),
        num_pruned=torch.sum(prune_mask),
        overflow=torch.sum(cand_mask & ~fits),
    )


def reset_opacity(
    model: GaussianModel,
    opt_state: AdamState,
    max_opacity: float = 0.01,
    which_object: Optional[int] = None,
):
    """Clamp opacities to <= max_opacity and zero the opacity moments
    (reference reset_opacity / reset_opacity_for_object)."""
    p = model.params
    opacity = torch.sigmoid(p.opacity_logit)
    new_op = torch.minimum(opacity, opacity.new_tensor(max_opacity))
    new_logit = torch.log(new_op / (1.0 - new_op))
    if which_object is not None:
        m = (model.aux.is_object == which_object)[..., None]
        new_logit = torch.where(m, new_logit, p.opacity_logit)
    new_params = dataclasses.replace(p, opacity_logit=new_logit)
    return (
        dataclasses.replace(model, params=new_params),
        zero_moments_field(opt_state, "opacity_logit"),
    )


def prune_by_opacity(model: GaussianModel, opt_state: AdamState, min_opacity: float):
    """Standalone opacity pruning (reference train_static.py:146-150 prunes
    opacity < 0.5 after the entropy phase). Returns (model, opt, n_pruned)."""
    opacity = torch.sigmoid(model.params.opacity_logit[:, 0])
    prune = model.aux.alive & (opacity < min_opacity)
    new_alive = model.aux.alive & ~prune
    aux = dataclasses.replace(model.aux, alive=new_alive)
    opt_state = zero_moments_where(opt_state, ~new_alive)
    return dataclasses.replace(model, aux=aux), opt_state, torch.sum(prune)
