"""Per-field Adam with moment surgery and the 3DGS LR schedules.

Port of `egogaussian_tpu/models/optim.py` (the reference's torch.optim.Adam
usage, gaussian_model.py:180-273). Hand-rolled rather than torch.optim so
that learning rates are per-field step arguments and the first/second
moments are plain GaussianParams that densify/prune/opacity-reset can zero
or drop exactly like the reference's optimizer surgery. Adam
hyperparameters match the reference: betas=(0.9, 0.999), eps=1e-15.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from egogaussian_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianParams


@dataclasses.dataclass
class AdamState:
    mu: Any  # same dataclass of tensors as the params
    nu: Any
    count: torch.Tensor  # 0-d int32 step count (on the params' device)


def _fields(x) -> List[str]:
    return [f.name for f in dataclasses.fields(x)]


def _map(fn, x):
    """The same dataclass with fn applied to every field."""
    return type(x)(**{k: fn(getattr(x, k)) for k in _fields(x)})


def adam_init(params) -> AdamState:
    """Zero moments for a dataclass of tensors (GaussianParams, ObjectPose)."""
    first = getattr(params, _fields(params)[0])
    return AdamState(
        mu=_map(torch.zeros_like, params),
        nu=_map(torch.zeros_like, params),
        count=torch.zeros((), dtype=torch.int32, device=first.device),
    )


def adam_advance(state: AdamState, steps) -> AdamState:
    """Advance the step count by `steps` without an update: the exact
    residue of `steps` Adam updates with zero gradients onto zero moments
    (the coarse stage's elided warm-up no-ops)."""
    return dataclasses.replace(state, count=state.count + int(steps))


def adam_state_from_jax_arrays(
    mu: Dict[str, np.ndarray], nu: Dict[str, np.ndarray], count: int,
    device: torch.device,
) -> AdamState:
    """Adam state from the JAX package's moments (dicts of numpy arrays
    keyed by GaussianParams field) and step count."""
    def params_of(d):
        return GaussianParams(**{k: torch.tensor(np.asarray(d[k], np.float32), device=device)
                                 for k in PARAM_FIELDS})

    return AdamState(mu=params_of(mu), nu=params_of(nu),
                     count=torch.tensor(int(count), dtype=torch.int32, device=device))


def per_scene(x, like: torch.Tensor):
    """A per-scene [S] tensor shaped to broadcast over `like` ([S, ...]);
    floats and 0-d tensors pass unchanged."""
    if isinstance(x, torch.Tensor) and x.dim() == 1:
        return x.reshape((-1,) + (1,) * (like.dim() - 1))
    return x


def adam_update(
    params,
    grads,
    state: AdamState,
    lr_tree: Dict[str, float],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
):
    """One Adam step with a learning rate per field (`lr_tree`: field ->
    float or 0-d tensor, zero allowed) on a dataclass of tensors. Returns
    (new params, new state); inputs are not modified.

    A scene-stacked state (every field [S, ...], count [S]) steps every
    scene at its own count; a learning rate may then be an [S] tensor, one
    per scene."""
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c
    mu, nu, new = {}, {}, {}
    for k in _fields(params):
        p = getattr(params, k)
        g = getattr(grads, k)
        m = b1 * getattr(state.mu, k) + (1 - b1) * g
        v = b2 * getattr(state.nu, k) + (1 - b2) * (g * g)
        m_hat = m / per_scene(bc1, p)
        v_hat = v / per_scene(bc2, p)
        new[k] = p - per_scene(lr_tree[k], p) * m_hat / (torch.sqrt(v_hat) + eps)
        mu[k], nu[k] = m, v
    cls = type(params)
    return cls(**new), AdamState(mu=cls(**mu), nu=cls(**nu), count=count)


def zero_moments_where(state: AdamState, mask: torch.Tensor) -> AdamState:
    """Zero Adam moments at masked rows across every field (new / reset
    Gaussians; reference cat_tensors_to_optimizer / replace_tensor_to_optimizer)."""
    def z(x):
        m = mask.reshape((-1,) + (1,) * (x.dim() - 1)).to(torch.bool)
        return torch.where(m, torch.zeros_like(x), x)

    return dataclasses.replace(state, mu=_map(z, state.mu), nu=_map(z, state.nu))


def zero_moments_field(state: AdamState, field: str) -> AdamState:
    """Zero the moments of one field (opacity reset path)."""
    mu = dataclasses.replace(state.mu, **{field: torch.zeros_like(getattr(state.mu, field))})
    nu = dataclasses.replace(state.nu, **{field: torch.zeros_like(getattr(state.nu, field))})
    return dataclasses.replace(state, mu=mu, nu=nu)


def expon_lr(
    step: int,
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1000000,
) -> float:
    """Log-linear LR schedule (reference get_expon_lr_func), evaluated on
    the host in float32 like the JAX version evaluates it on the device."""
    f32 = np.float32
    step = f32(step)
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
            f32(0.5 * np.pi) * np.clip(step / f32(lr_delay_steps), f32(0.0), f32(1.0))
        )
    else:
        delay_rate = f32(1.0)
    t = np.clip(step / f32(max_steps), f32(0.0), f32(1.0))
    log_lerp = np.exp(
        f32(math.log(max(lr_init, 1e-32))) * (f32(1) - t)
        + f32(math.log(max(lr_final, 1e-32))) * t
    )
    out = f32(delay_rate * log_lerp)
    return 0.0 if step < 0 else float(out)


def gaussian_lr_tree(
    step: int,
    opt,
    spatial_lr_scale: float,
    label_lr: Optional[float] = None,
    zero_gaussians: bool = False,
) -> Dict[str, float]:
    """Per-field learning rates for GaussianParams from an
    OptimizationParams-style config (reference training_setup,
    gaussian_model.py:180-223). `zero_gaussians` zeroes every field (the
    label phase then sets the label's own rate)."""
    xyz_lr = expon_lr(
        step,
        opt.position_lr_init * spatial_lr_scale,
        opt.position_lr_final * spatial_lr_scale,
        lr_delay_steps=0,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps,
    )
    lrs = dict(
        xyz=xyz_lr,
        features_dc=opt.feature_lr,
        features_rest=opt.feature_lr / 20.0,
        log_scales=opt.scaling_lr,
        quats=opt.rotation_lr,
        opacity_logit=opt.opacity_lr,
        label=label_lr if label_lr is not None else opt.label_lr,
    )
    if zero_gaussians:
        lrs = {k: 0.0 for k in lrs}
    # float32 values, like the JAX tree of f32 scalars
    return {k: float(np.float32(v)) for k, v in lrs.items()}
