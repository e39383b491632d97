"""The numbers that decide `correct`, and their limits.

Training cells compare, against the reference run from the same inputs:
each step's loss, the first gradient as the optimizer got it (Adam's first
moment after one step over 1 - beta1), and the parameters' change after
the steps checked. Both by the worst leaf: the gap between the program's
norm and the reference's, over the reference's norm of that leaf or of the
median leaf, whichever is larger. A leaf whose reference gradient is under
a thousandth of the median leaf's moves under Adam by round-off alone and
is left out.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Sequence

import numpy as np
import torch

QUIET_LEAF = 1e-3


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def counted_leaves(ref_grads: Dict[str, torch.Tensor]) -> list:
    norms = {k: norm(v) for k, v in ref_grads.items() if v.numel()}
    if not norms:
        return []
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= QUIET_LEAF * med]


def active_elements(grads_seen: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per leaf, the elements whose largest reference gradient over the steps
    checked is at least a thousandth of the leaf's median nonzero one: the
    quiet-leaf rule taken element by element. An element below it (an
    occluded Gaussian's, whose gradient is ~1e-30) moves under Adam by
    round-off alone, a full step for a gradient of 1e-20 or 0 for one of
    1e-30."""
    out = {}
    for k, a in grads_seen.items():
        nz = a[a > 0]
        thr = QUIET_LEAF * float(nz.median()) if nz.numel() else math.inf
        out[k] = a >= thr
    return out


def masked(tree: Dict[str, torch.Tensor], mask: Dict[str, torch.Tensor]):
    return {k: tree[k][mask[k]] if k in mask else tree[k] for k in tree}


def worst_norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                   leaves: Iterable[str]) -> float:
    leaves = list(leaves)
    if not leaves:
        return 0.0
    rn = {k: norm(ref[k]) for k in leaves}
    med = statistics.median(rn.values())
    worst = 0.0
    for k in leaves:
        den = max(rn[k], med)
        gap = abs(norm(prog[k]) - rn[k]) / den if den > 0 else abs(norm(prog[k]))
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def row_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
            order: Sequence[str]) -> float:
    """Two sets of rows (fields of [M, ...] each) compared as sets: both
    sorted by the fields in `order` (the first the primary key), then the
    worst field's largest difference over its largest reference value.
    Infinite when the counts differ."""
    def table(rows):
        return torch.cat([rows[k].reshape(rows[k].shape[0], -1).double().cpu() for k in order],
                         dim=1).numpy()

    a, b = table(prog), table(ref)
    if a.shape != b.shape:
        return math.inf
    if not len(b):
        return 0.0
    a, b = a[np.lexsort(a.T[::-1])], b[np.lexsort(b.T[::-1])]
    worst, lo = 0.0, 0
    for k in order:
        w = int(np.prod(ref[k].shape[1:]))
        d = float(np.abs(a[:, lo:lo + w] - b[:, lo:lo + w]).max())
        worst = max(worst, d / max(float(np.abs(b[:, lo:lo + w]).max()), 1e-30))
        lo += w
    return worst if math.isfinite(worst) else math.inf


def rel_gap(a: float, b: float) -> float:
    g = abs(a - b) / max(abs(b), 1e-30)
    return g if math.isfinite(g) else math.inf


def decide(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every number at or under its limit; a number
    without a limit, or not finite, fails."""
    checks, ok = {}, True
    for k, v in numbers.items():
        lim = limits.get(k)
        good = lim is not None and math.isfinite(v) and v <= lim
        ok = ok and good
        checks[k] = {"value": v, "limit": lim}
    return ok and bool(numbers), checks
