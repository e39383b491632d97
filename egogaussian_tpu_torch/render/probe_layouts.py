"""Hand-made tile-grid layouts that pin one rule of the compositor kernels.

`quadrant_scene` pins the tile-wide saturation vote: the kernels, their
plain twins and the JAX package's tile-grid kernel must write the same
zero pattern for its later chunks. It is numpy only, so the kernel checks
of `chip_smoke.py`, the card tests and the CPU tests share one copy.
"""
from __future__ import annotations

import numpy as np


def quadrant_scene(d: int, seed: int = 5):
    """A hand-made tile-grid layout that pins the tile-wide saturation vote
    (ts 32, 64x32 pixels, two tiles; float32 numpy):
      tile 0, chunks 0-1: one steep splat (conic 20, op 1e4: alpha 0.99 at
        the 4 pixels of its 2x2 block, 0 at every other pixel) per 2x2
        block of quadrant (0, 0), 4 layers, so that quadrant's T falls to
        ~1e-8 while the rest of the tile stays at 1. Chunk 2 holds 20
        splats seen only inside that quadrant and 20 in the lower half. The
        tile-wide rule composites chunk 2 everywhere, so the first 20 get
        tiny nonzero gradients; a per-quadrant vote would zero them.
      tile 1: chunk 0 saturates the whole tile (broad op-1e6 splats on an
        8-px grid, 8 layers); its chunk 1 (30 pairs) is skipped: zeros.
    Returns (meta [3, 2] int32, vals [5, ch16, 128], bg [1, D], n_tx, W, H);
    slots 2 and 4 are the later chunks."""
    rng = np.random.RandomState(seed)
    ch16 = ((7 + d) + 7) // 8 * 8

    def rows(mx, my, a, op):
        n = len(mx)
        r = np.zeros((n, ch16), np.float32)
        r[:, 0], r[:, 1], r[:, 2], r[:, 4], r[:, 5] = mx, my, a, a, op
        r[:, 3] = rng.uniform(-0.1, 0.1, n) * a
        r[:, 6:6 + d] = rng.rand(n, d)
        r[:, 6 + d] = rng.uniform(1.0, 5.0, n)
        return r

    def grid(x0, step, n_side, layers, a, op, x_off=0.0):
        g = np.arange(n_side) * step + x0
        mx, my = np.meshgrid(g + x_off, g, indexing="xy")
        n = n_side * n_side * layers
        return rows(np.tile(mx.ravel(), layers) + rng.uniform(-0.1, 0.1, n),
                    np.tile(my.ravel(), layers) + rng.uniform(-0.1, 0.1, n),
                    np.full(n, a), np.full(n, op))

    def splats(n, x_lo, x_hi, y_lo, y_hi):
        return rows(rng.uniform(x_lo, x_hi, n), rng.uniform(y_lo, y_hi, n), np.full(n, 0.5),
                    rng.uniform(0.3, 0.9, n))

    quad = grid(1.0, 2.0, 8, 4, 20.0, 1e4)  # 256 pairs: chunks 0 and 1
    later0 = np.concatenate([splats(20, 3.0, 10.0, 3.0, 10.0), splats(20, 2.0, 30.0, 20.0, 28.0)])
    full1 = grid(4.0, 8.0, 4, 8, 0.5, 1e6, x_off=32.0)
    later1 = splats(30, 34.0, 62.0, 2.0, 30.0)
    chunks = [quad[:128], quad[128:], later0, full1, later1]
    vals = np.zeros((len(chunks), ch16, 128), np.float32)
    for slot, r in enumerate(chunks):
        vals[slot, :, :len(r)] = r.T
    meta = np.array([[0, 3], [256 + len(later0), 128 + len(later1)], [5, 5]], np.int32)
    bg = np.array([[0.2, 0.1, 0.4][:d]], np.float32)
    return meta, vals, bg, 2, 64, 32
