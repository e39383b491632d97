"""Plain PyTorch densification of 3DGS (clone, split, prune).

Written from the published method (3DGS, gaussian_model.py
densify_and_clone / densify_and_split / densify_and_prune; EgoGaussian
keeps them) and imports nothing of the program:

  * the statistic: mean screen-space gradient norm, accum / denom (0 where
    a Gaussian was never visible);
  * clone: the rows whose statistic reaches the threshold and whose
    largest scale is at most percent_dense * extent, copied whole;
  * split: those whose largest scale is above it; each gives 2 children at
    xyz + R(q) (s * n), n standard normal, with scales s / (0.8 * 2), and
    is removed;
  * prune: rows of the state before densification whose opacity is under
    min_opacity (and, with max_screen, whose screen radius or world scale
    is too large).

The decisions are taken on the state before densification and the prune
applies to its rows, as the system under test states it; 3DGS prunes
after appending, so its new rows of low opacity go too. The normal draws
are the counter-based draws the configuration's trainer takes from its
seed, per slot of the state (`split_noise`, a frozen copy), so both
sides split with the same n.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.reference.render import quat_to_rotmat

FIELDS = ("xyz", "features_dc", "log_scales", "quats", "opacity_logit")
MIN_OPACITY = 0.005  # 3DGS train.py's densify_and_prune(..., 0.005, ...)

_PCG_MUL = 747796405
_PCG_INC = 2891336453
_MASK32 = 0xFFFFFFFF


def _pcg_hash(x: torch.Tensor) -> torch.Tensor:
    state = (x * _PCG_MUL + _PCG_INC) & _MASK32
    word = ((state >> ((state >> 28) + 4)) ^ state) * 277803737 & _MASK32
    return ((word >> 22) ^ word) & _MASK32


def split_noise(seed: int, slots: torch.Tensor) -> torch.Tensor:
    """Standard normals [2, len(slots), 3] for the given slots: a PCG hash of
    (seed, slot, draw) and Box-Muller, per slot alone."""
    dev = slots.device
    draw = torch.arange(12, dtype=torch.int64, device=dev)
    key = _pcg_hash(torch.tensor(seed & _MASK32, dtype=torch.int64, device=dev))
    bits = _pcg_hash(key ^ _pcg_hash(slots.to(torch.int64)[:, None] * 12 + draw[None, :]))
    u = (bits >> 8).to(torch.float64) * (1.0 / (1 << 24))
    u1, u2 = 1.0 - u[:, 0::2], u[:, 1::2]
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * torch.pi * u2)
    return z.to(torch.float32).reshape(-1, 2, 3).transpose(0, 1)


def split_seed(trainer_seed: int) -> int:
    """The seed of the first densification's draws: the first draw of a CPU
    torch.Generator seeded with the trainer's seed."""
    g = torch.Generator().manual_seed(int(trainer_seed))
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=g))


def densify(p: Dict[str, torch.Tensor], alive, accum, denom, max_grad: float, extent: float,
            percent_dense: float, seed: int, min_opacity: float = MIN_OPACITY,
            max_screen: Optional[float] = None, max_radii=None):
    """One densification of the state `p` (fields of every slot, `alive`
    [C] bool). Returns (rows, counts): the Gaussians alive after it, kept
    rows first, then clones, then each split's two children, and the
    numbers cloned, split and pruned."""
    grads = torch.where(denom > 0, accum / denom.clamp(min=1e-12), torch.zeros_like(accum))
    grads = torch.nan_to_num(grads, nan=0.0)
    scaling = torch.exp(p["log_scales"])
    max_scale = scaling.amax(dim=1)
    chosen = alive & (grads >= max_grad)
    clone = chosen & (max_scale <= percent_dense * extent)
    split = chosen & (max_scale > percent_dense * extent)
    prune = torch.sigmoid(p["opacity_logit"][:, 0]) < min_opacity
    if max_screen is not None:
        prune = prune | (max_radii > max_screen) | (max_scale > 0.1 * extent)
    prune = alive & (prune | split)
    keep = alive & ~prune

    parents = torch.nonzero(split).reshape(-1)
    n = split_noise(seed, parents)
    s = scaling[parents]
    R = quat_to_rotmat(p["quats"][parents])
    children = {k: p[k][parents].repeat((2,) + (1,) * (p[k].dim() - 1)) for k in FIELDS}
    offsets = torch.matmul(R[None], (n * s[None])[..., None])[..., 0]  # [2, P, 3]
    children["xyz"] = (p["xyz"][parents][None] + offsets).reshape(-1, 3)
    children["log_scales"] = torch.log(s / (0.8 * 2.0)).repeat(2, 1)
    rows = {k: torch.cat([p[k][keep], p[k][clone], children[k]], dim=0) for k in FIELDS}
    counts = dict(cloned=int(clone.sum()), split=int(split.sum()), pruned=int(prune.sum()),
                  alive_after=int(rows["xyz"].shape[0]))
    return rows, counts
