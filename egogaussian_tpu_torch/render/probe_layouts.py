"""Hand-made layouts that pin rules of the compositor kernels.

`quadrant_scene` pins the tile-wide saturation vote: the kernels, their
plain twins and the JAX package's tile-grid kernel must write the same
zero pattern for its later chunks. `window_probe` puts the chunked
windowed pair's edge cases into one gather window: a tile three chunks
deep, footprints across the 16x16 quadrant and 8x4 warp-patch edges,
live rows past a tile's count, an empty tile and pairs on either side of
the 1/255 gate. `stream_probe` does the same for the stream pair's slot
runs: empty tiles between runs, a run of exactly two chunks, a one-pair
tile, the pure-padding tail and a run cut at the slot capacity.
`simple_window_probe` does it for the simple windowed pair's five split
inputs: window rows that are not a multiple of 128 or of 4, masked rows
among live ones, an all-masked chunk between live chunks and an
all-masked tile, alphas at the 0.99 clamp and on either side of 1/255,
a mean on a pixel centre and a conic whose power clamps at 0.
`gather_scene` is no hand-made layout but a scene at the training cell's
sizes, for the card checks of the layouts' pair gather. All are numpy
only, so the kernel checks of `chip_smoke.py`, the card tests and
the CPU tests share one copy.
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


class _Splats:
    """Seeded float32 pair rows mu_x | mu_y | a | b | c | op | col x D | z
    for the probes of tiles of size ts (x0: the tile's left edge)."""

    def __init__(self, d: int, ts: int, seed: int):
        self.rng, self.d, self.ts = np.random.RandomState(seed), d, ts

    def rows(self, mx, my, sigma, op):
        rng, d, n = self.rng, self.d, len(mx)
        r = np.zeros((n, 7 + d), np.float32)
        a = 1.0 / sigma ** 2
        c = a * rng.uniform(0.6, 1.4, n)
        r[:, 0], r[:, 1], r[:, 2], r[:, 4], r[:, 5] = mx, my, a, c, op
        r[:, 3] = rng.uniform(-0.4, 0.4, n) * np.sqrt(a * c)
        r[:, 6:6 + d] = rng.rand(n, d)
        r[:, 6 + d] = rng.uniform(1.0, 5.0, n)
        return r

    def edge(self, n, x0):
        """Centred within half a pixel of a warp-patch edge (x a multiple of
        8, y of 4, tile-local; at ts 32 also the quadrant edges), 1-5 px
        footprints that cross it."""
        rng, ts = self.rng, self.ts
        mx = x0 + 8.0 * rng.randint(1, ts // 8, n) + rng.uniform(-0.5, 0.5, n)
        my = 4.0 * rng.randint(1, ts // 4, n) + rng.uniform(-0.5, 0.5, n)
        return self.rows(mx, my, rng.uniform(1.0, 5.0, n), rng.uniform(0.05, 0.5, n))

    def loose(self, n, x0, margin):
        """Anywhere in the tile or up to `margin` px outside it."""
        rng, ts = self.rng, self.ts
        return self.rows(x0 + rng.uniform(-margin, ts + margin, n),
                         rng.uniform(-margin, ts + margin, n),
                         rng.uniform(0.7, 4.0, n), rng.uniform(0.05, 0.6, n))

    def masked(self, n, x0):
        """Live, opaque splats over the whole tile (op 0.95): rows that must
        never be read."""
        rng, ts = self.rng, self.ts
        return self.rows(x0 + rng.uniform(0, ts, n), rng.uniform(0, ts, n),
                         np.full(n, ts / 2.0), np.full(n, 0.95))

    def gate(self, live, x0):
        """Rows 0-1 of `live` on pixel centres (5, 4) and (9, 4): op exactly
        float32(1/255), alpha at the gate there (kept), and one ulp below
        it (alpha 0 everywhere)."""
        g = np.float32(1.0 / 255.0)
        for k, (px, op) in enumerate(((5.5, g), (9.5, np.nextafter(g, np.float32(0))))):
            live[k, :6] = (x0 + px, 4.5, 2.0, 0.0, 2.0, op)


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
    sp = _Splats(d, ts, seed)
    counts = np.array(PROBE_COUNTS, np.int32)
    tiles = []
    for t, cnt in enumerate(counts):
        x0 = float(t * ts)
        if t == 0:
            live = np.concatenate([sp.edge(200, x0), sp.loose(cnt - 200, x0, 6.0)])
            live = live[sp.rng.permutation(cnt)]
        elif t == 2:
            live = sp.loose(cnt, x0, 3.0)
            sp.gate(live, x0)
        else:
            live = np.zeros((0, 7 + d), np.float32)
        tiles.append(np.concatenate([live, sp.masked(PROBE_ROWS - cnt, x0)]))
    data = np.stack(tiles).astype(np.float32)
    bg = np.array([[0.2, 0.1, 0.4][:d]], np.float32)
    return counts, data, bg, 3, 3 * ts, ts


STREAM_COUNTS = (256, 0, 1, 0, 300, 0)  # pairs of stream_probe's six tiles


def stream_probe(d: int, ts: int, cut: bool = False, seed: int = 7):
    """A hand-made stream layout (meta [4, n_slots], vals [n_slots*128, 7+D])
    of six tiles of size ts in a row (6ts x ts pixels), laid out as
    render/tiled.py:stream_layout lays out their runs:
      tile 0: exactly 2 x 128 pairs (two full chunks, slots 0-1); rows 0-1
        are the 1/255 gate pairs of window_probe's tile 2;
      tiles 1 and 3: empty, between runs (they own no slot);
      tile 2: one pair (slot 2), near a warp-patch edge;
      tile 4: 300 pairs (slots 3-5, the last partial), two thirds across
        warp-patch and quadrant edges;
      tile 5: empty, the last tile: it owns the pure-padding tail slots 6-7
        (rank 0 and 128 >= its count 0).
    With cut=True the slot capacity ends inside tile 4's run (n_slots 5,
    slots 3-4 at ranks 0 and 128 < 300), as when the padded total overflows
    the capacity: tile 5 then owns no slot. Every row past a count, in the
    partial chunks and the tail slots, holds a live, opaque splat over its
    tile (op 0.95) that would show if it were read. Returns (meta, vals,
    bg [1, D], n_tx, width, height)."""
    sp = _Splats(d, ts, seed)
    counts = np.array(STREAM_COUNTS, np.int32)
    n_tiles = len(counts)
    chunks = -(-counts // 128)
    starts2 = np.concatenate([[0], np.cumsum(chunks)[:-1]])
    n_used = int(chunks.sum())
    n_slots = 5 if cut else n_used + 2
    owner = np.full(n_slots, n_tiles - 1, np.int64)
    for t in np.nonzero(chunks)[0]:
        owner[starts2[t]:starts2[t] + chunks[t]] = t
    rank = (np.arange(n_slots) - starts2[owner]) * 128
    meta = np.stack([owner, rank, counts[owner], np.full(n_slots, min(n_used, n_slots) - 1)])
    vals = np.zeros((n_slots * 128, 7 + d), np.float32)
    for t in range(n_tiles):
        x0 = float(t * ts)
        cnt = int(counts[t])
        if t == 0:
            live = sp.loose(cnt, x0, 4.0)
            sp.gate(live, x0)
        elif t == 4:
            live = np.concatenate([sp.edge(200, x0), sp.loose(cnt - 200, x0, 6.0)])
            live = live[sp.rng.permutation(cnt)]
        else:
            live = sp.edge(cnt, x0)
        slots = np.nonzero(owner == t)[0]
        if not len(slots):
            continue
        n_rows = len(slots) * 128
        rows = np.concatenate([live, sp.masked(max(n_rows - cnt, 0), x0)])[:n_rows]
        vals[slots[0] * 128:slots[0] * 128 + n_rows] = rows
    bg = np.array([[0.2, 0.1, 0.4][:d]], np.float32)
    return meta.astype(np.int32), vals, bg, n_tiles, n_tiles * ts, ts


SIMPLE_PROBE_ROWS = (300, 258)  # window rows of simple_window_probe: not a multiple of 128 / of 4
SIMPLE_PROBE_CLAMP = (2, 2, 3, 4)  # tile 2: rows of the mean on a pixel centre, the 0.99 clamp
# and the indefinite conic


def simple_window_probe(d: int, ts: int, m: int = 300, seed: int = 8):
    """A hand-made window for the simple windowed compositor: three tiles
    of size ts in a row (3ts x ts pixels), m rows each (m > 256; the tail
    chunk holds m - 256 rows), as its five float32 inputs (op = 0 on
    masked rows):
      tile 0: chunk 0 live, footprints across the quadrant and warp-patch
        edges, every fourth row masked; chunk 1 all masked (an all-masked
        chunk between live chunks); the tail chunk live.
      tile 1: all masked.
      tile 2: rows 0-1 the 1/255 gate pairs of window_probe (PROBE_GATE);
        row 2 a mean exactly on the centre of pixel (ts/2, 7), so power is
        -0 there; row 3 a mean on the centre of pixel (3, ts - 4) with op
        1.5, so alpha clamps at 0.99 around it; row 4 an indefinite conic
        (b^2 > ac), so power > 0 clamps at 0 over part of the tile; then
        live rows up to row 200, every fifth masked, one in twenty with op in
        (0.99, 2]; the rest masked, so its tail chunk is all masked.
    Every masked row holds an opaque splat over its tile (op 0.95 before
    masking) that would show if it were not masked. Returns (mu [3, m, 2],
    con [3, m, 3], op [3, m, 1], col [3, m, D], z [3, m, 1], bg [1, D],
    n_tx, width, height)."""
    if m <= 2 * 128:
        raise ValueError("simple_window_probe needs more than two chunks of rows")
    sp = _Splats(d, ts, seed)
    tiles = []
    for t in range(3):
        x0 = float(t * ts)
        rows = sp.masked(m, x0)
        live = np.zeros(m, bool)
        if t == 0:
            rows[:128] = sp.edge(128, x0)
            rows[256:] = sp.edge(m - 256, x0)
            live[:128] = np.arange(128) % 4 != 3
            live[256:] = True
        elif t == 2:
            n = 200
            rows[:n] = sp.loose(n, x0, 3.0)
            sp.gate(rows, x0)
            rows[2, :6] = (x0 + ts // 2 + 0.5, 7.5, 0.5, 0.1, 0.4, 0.7)
            rows[3, :6] = (x0 + 3.5, ts - 3.5, 0.5, 0.0, 0.5, 1.5)
            rows[4, :6] = (x0 + ts / 2.0, ts / 2.0, 0.02, 0.1, 0.02, 0.2)
            hot = sp.rng.rand(n) < 0.05
            hot[:5] = False
            rows[:n, 5] = np.where(hot, sp.rng.uniform(1.0, 2.0, n), rows[:n, 5])
            live[:n] = (np.arange(n) % 5 != 4) | (np.arange(n) < 5)
        rows[~live, 5] = 0.0
        tiles.append(rows)
    data = np.stack(tiles).astype(np.float32)
    parts = tuple(np.ascontiguousarray(data[..., a:b])
                  for a, b in ((0, 2), (2, 5), (5, 6), (6, 6 + d), (6 + d, 7 + d)))
    bg = np.array([[0.2, 0.1, 0.4][:d]], np.float32)
    return (*parts, bg, 3, 3 * ts, ts)


def gather_scene(n: int = 500_000, width: int = 1600, height: int = 900, seed: int = 0):
    """A scene at the static training cell's sizes (500k Gaussians,
    1600x900) for the layouts' pair gather: n Gaussians in a box in front of
    the camera at (0, 0, -4) looking at the origin (focal 0.7 x width), so
    they fill the frame; isotropic-ish scales of half the mean spacing and
    opacity 0.1 (3DGS's initial values), random rotations and colors.
    Returns (means [n, 3], scales [n, 3], quats [n, 4], colors [n, 3],
    opacities [n], focal), float32 numpy."""
    rng = np.random.RandomState(seed)
    half = np.array([3.2, 1.8, 1.5], np.float32)
    means = (rng.uniform(-1.0, 1.0, (n, 3)) * half).astype(np.float32)
    spacing = (float(np.prod(2 * half)) / n) ** (1.0 / 3.0)
    scales = (0.5 * spacing * np.exp(0.3 * rng.randn(n, 3))).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    colors = rng.rand(n, 3).astype(np.float32)
    opacities = np.full(n, 0.1, np.float32)
    return means, scales, quats, colors, opacities, 0.7 * width
