"""Hand-made layouts that pin rules of the compositor kernels.

`quadrant_scene` pins the tile-wide saturation vote: the kernels, their
plain twins and the JAX package's tile-grid kernel must write the same
zero pattern for its later chunks. `window_probe` puts the chunked
windowed pair's edge cases into one gather window: a tile three chunks
deep, footprints across the 16x16 quadrant and 8x4 warp-patch edges,
live rows past a tile's count, an empty tile and pairs on either side of
the 1/255 gate. Both are numpy only, so the kernel checks of
`chip_smoke.py`, the card tests and the CPU tests share one copy.
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


PROBE_ROWS = 384  # window rows of window_probe: three 128-row chunks
PROBE_COUNTS = (300, 0, 50)  # pairs of its three tiles
PROBE_GATE = (2, 0, 5, 4)  # tile, row, pixel (x, y) in the tile of the gate pair


def window_probe(d: int, ts: int, seed: int = 6):
    """A hand-made gather window for the chunked windowed compositor: three
    tiles of size ts in a row (3ts x ts pixels), PROBE_ROWS rows each,
    float32 numpy rows mu_x | mu_y | a | b | c | op | col x D | z:
      tile 0: 300 pairs (three chunks, the last partial); two thirds are
        centred within half a pixel of a warp-patch edge (x a multiple of
        8, y of 4, tile-local; at ts 32 this includes the quadrant edges
        x = 16, y = 16), with 1-5 px footprints that cross them; the rest
        anywhere in the tile or up to 6 px outside it.
      tile 1: count 0 (empty): bg, zero gradients.
      tile 2: 50 pairs; row 0 sits exactly on the centre of pixel (5, 4)
        with op = float32(1/255), so its alpha there is exactly the gate
        (kept: the gate keeps alpha >= 1/255) and 0 at every other pixel;
        row 1 likewise at pixel (9, 4) with op one ulp below the gate
        (alpha 0 everywhere).
    Every row past a tile's count holds a live, opaque splat over the
    tile (op 0.95), which must be masked. Returns (counts [3] int32,
    data [3, PROBE_ROWS, 7+D], bg [1, D], n_tx, width, height)."""
    rng = np.random.RandomState(seed)
    ch = 7 + d

    def rows(mx, my, sigma, op):
        n = len(mx)
        r = np.zeros((n, ch), np.float32)
        a = 1.0 / sigma ** 2
        c = a * rng.uniform(0.6, 1.4, n)
        r[:, 0], r[:, 1], r[:, 2], r[:, 4], r[:, 5] = mx, my, a, c, op
        r[:, 3] = rng.uniform(-0.4, 0.4, n) * np.sqrt(a * c)
        r[:, 6:6 + d] = rng.rand(n, d)
        r[:, 6 + d] = rng.uniform(1.0, 5.0, n)
        return r

    def edge_splats(n, x0):
        mx = x0 + 8.0 * rng.randint(1, ts // 8, n) + rng.uniform(-0.5, 0.5, n)
        my = 4.0 * rng.randint(1, ts // 4, n) + rng.uniform(-0.5, 0.5, n)
        return rows(mx, my, rng.uniform(1.0, 5.0, n), rng.uniform(0.05, 0.5, n))

    def loose_splats(n, x0, margin):
        return rows(x0 + rng.uniform(-margin, ts + margin, n), rng.uniform(-margin, ts + margin, n),
                    rng.uniform(0.7, 4.0, n), rng.uniform(0.05, 0.6, n))

    def masked_splats(n, x0):
        return rows(x0 + rng.uniform(0, ts, n), rng.uniform(0, ts, n),
                    np.full(n, ts / 2.0), np.full(n, 0.95))

    counts = np.array(PROBE_COUNTS, np.int32)
    tiles = []
    for t, cnt in enumerate(counts):
        x0 = float(t * ts)
        if t == 0:
            live = np.concatenate([edge_splats(200, x0), loose_splats(cnt - 200, x0, 6.0)])
            live = live[rng.permutation(cnt)]
        elif t == 2:
            live = loose_splats(cnt, x0, 3.0)
            gate = np.float32(1.0 / 255.0)
            for k, (px, op) in enumerate(((5.5, gate), (9.5, np.nextafter(gate, np.float32(0))))):
                live[k, :6] = (x0 + px, 4.5, 2.0, 0.0, 2.0, op)
        else:
            live = np.zeros((0, ch), np.float32)
        tiles.append(np.concatenate([live, masked_splats(PROBE_ROWS - cnt, x0)]))
    data = np.stack(tiles).astype(np.float32)
    bg = np.array([[0.2, 0.1, 0.4][:d]], np.float32)
    return counts, data, bg, 3, 3 * ts, ts
