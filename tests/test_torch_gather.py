"""The layouts' pair gather (render/pair_gather.py) on the CPU: its plain
twins against `rows[src]` and against autograd's backward of it, on the
gradient the compositor's own backward gives each layout, for the
tile-grid, stream and window layouts. The values must be EQUAL and the
gradient `==` (autograd's index backward sums each row's slots in
increasing slot order, and the segmented sum adds the same nonzero terms in
the same order, leaving out only exact zeros).

Each case pins a rule of the pair -> slot map: empty tiles, a Gaussian
over many tiles, culled pairs and the clamped slot tail (`tail`); tiles
whose padded run overflows the slot capacity (`overflow`); tiles cut at
max_per_tile and pairs past max_pairs (`cut`); two scenes of different
crop sizes in one layout (`two_scenes`).
"""
import numpy as np
import pytest
import torch

from egogaussian_tpu_torch.ops.covariance import covariance_from_scaling_rotation
from egogaussian_tpu_torch.render import pair_gather as pg
from egogaussian_tpu_torch.render import tiled
from egogaussian_tpu_torch.render.camera import Camera, look_at
from egogaussian_tpu_torch.render.project import ProjectedGaussians, project_gaussians
from egogaussian_tpu_torch.render.tiled import TileConfig, scene_caps

CPU = torch.device("cpu")
W, H, TS = 64, 48, 16
LAYOUTS = {"tilegrid": tiled.tilegrid_layout_scenes, "stream": tiled.stream_layout_scenes,
           "window": tiled.window_layout_scenes}


@pytest.fixture(autouse=True)
def one_thread():
    """Autograd's CPU index backward sums a row's slots in slot order only
    on one thread (on more it reorders the sum)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _projection(seed: int, width: int, height: int, n: int = 80):
    """n Gaussians in the left two thirds of the frame (the right tiles stay
    empty), one of them broad enough to cover most tiles, opacities down to
    0.02 so the opacity-aware cull removes pairs."""
    rng = np.random.RandomState(seed)
    means = rng.randn(n, 3).astype(np.float32) * np.float32([0.5, 0.6, 0.5])
    means[:, 0] -= 0.6
    scales = np.exp(rng.randn(n, 3) * 0.4 - 2.3).astype(np.float32)
    means[0], scales[0] = (-0.6, 0.0, 0.0), (0.4, 0.5, 0.1)
    cov3d = covariance_from_scaling_rotation(torch.as_tensor(scales),
                                             torch.as_tensor(rng.randn(n, 4).astype(np.float32)))
    R, t = look_at(np.array([0.0, 0.0, -4.0]), np.zeros(3))
    cam = Camera.from_colmap(R, t, 70.0, 70.0, width, height, device=CPU)
    proj = project_gaussians(torch.as_tensor(means), cov3d, cam.viewmat, cam.fx, cam.fy, cam.cx,
                             cam.cy, width, height)
    colors = torch.as_tensor(rng.rand(n, 3).astype(np.float32))
    ops = torch.as_tensor(rng.uniform(0.02, 0.95, n).astype(np.float32))
    return proj, colors, ops


def _case(case: str):
    """(proj [S, N, ...], colors [S, N, 3], opacities [S, N], caps)."""
    if case == "two_scenes":
        sizes = [(W, H), (48, 32)]
        cfgs = [TileConfig(tile_size=TS, max_pairs=2048, max_per_tile=256, max_slots=4096),
                TileConfig(tile_size=TS, max_pairs=1024, max_per_tile=128, max_slots=2048)]
    else:
        cfg = {"tail": TileConfig(tile_size=TS, max_pairs=2048, max_per_tile=256,
                                  max_slots=8192),
               "overflow": TileConfig(tile_size=TS, max_pairs=2048, max_per_tile=256,
                                      max_slots=3 * 128),
               "cut": TileConfig(tile_size=TS, max_pairs=256, max_per_tile=24,
                                 max_slots=8192)}[case]
        sizes, cfgs = [(W, H)], [cfg]
    scenes = [_projection(7 + s, w, h) for s, (w, h) in enumerate(sizes)]
    proj = ProjectedGaussians(*(torch.stack(f) for f in zip(*(p for p, _, _ in scenes))))
    proj = ProjectedGaussians(*(x.detach().requires_grad_(x.is_floating_point()) for x in proj))
    colors = torch.stack([c for _, c, _ in scenes]).requires_grad_(True)
    ops = torch.stack([o for _, _, o in scenes]).requires_grad_(True)
    return proj, colors, ops, scene_caps(cfgs, sizes, CPU, proj.depths.shape[1])


def _assert_case_holds(case, kind, proj, ops, caps):
    """The rules the case is there to pin do occur in its layout."""
    (order, _, tile_sorted, starts, tile_cnt, dropped, (n_tx, n_ty)), pairs = (
        tiled.bin_scenes_pairs(proj, caps, ops))
    n_tiles = n_tx * n_ty
    p = torch.arange(tile_sorted.shape[1])
    total = pairs.offsets[:, -1] + pairs.counts[:, -1]
    emitted = p[None] < torch.minimum(total, caps.max_pairs)[:, None]
    culled = (torch.gather(tile_sorted, 1, torch.argsort(pairs.perm, dim=1)) == n_tiles) & emitted
    runs = tiled._padded_runs(proj, ops, caps)
    if case == "tail":
        assert bool((tile_cnt == 0).any()), "no empty tile"
        assert int(pairs.counts.max()) >= 6, "no Gaussian over many tiles"
        assert bool(culled.any()), "no culled pair"
        assert int((runs.starts2[:, -1] + runs.padded_cnt[:, -1]).max()) < caps.config.max_slots
    elif case == "overflow" and kind != "window":
        assert bool(runs.overflowed[tile_cnt > 0].any()), "no overflowed tile"
        assert int(runs.dropped.sum()) > 0
    elif case == "cut":
        assert bool((tile_cnt == caps.max_per_tile[:, None]).any()), "no tile cut at max_per_tile"
        assert bool((total > caps.max_pairs).all()), "no pair past max_pairs"
        assert int(dropped.sum()) > 0
    elif case == "two_scenes":
        assert len(set(caps.sizes)) == 2


def _recorded_gather(monkeypatch, kind, proj, colors, ops, caps):
    """Runs the layout and its compositor with a loss of random weights;
    returns (rows, index, transposed, vals, dvals)."""
    seen = {}
    real = tiled.gather_pairs

    def record(rows, index, transposed):
        vals = real(rows, index, transposed)
        vals.retain_grad()
        seen.update(rows=rows, index=index, transposed=transposed, vals=vals)
        return vals

    monkeypatch.setattr(tiled, "gather_pairs", record)
    lay = LAYOUTS[kind](proj, colors, ops, caps)
    bg = torch.tensor([[0.2, 0.1, 0.4]] * len(caps.sizes))
    image, alpha, depth = tiled._composite(lay, bg, caps)
    gen = torch.Generator().manual_seed(3)
    loss = sum(torch.sum(x * torch.rand(x.shape, generator=gen)) for x in (image, alpha, depth))
    loss.backward()
    return seen["rows"], seen["index"], seen["transposed"], seen["vals"], seen["vals"].grad


@pytest.mark.parametrize("case", ["tail", "overflow", "cut", "two_scenes"])
@pytest.mark.parametrize("kind", ["tilegrid", "stream", "window"])
def test_gather_matches_index_and_its_autograd(monkeypatch, kind, case):
    proj, colors, ops, caps = _case(case)
    _assert_case_holds(case, kind, proj, ops, caps)
    rows, index, transposed, vals, dvals = _recorded_gather(monkeypatch, kind, proj, colors,
                                                           ops, caps)
    assert transposed == (kind == "tilegrid")
    # forward: the layout's vals are rows[src] in the layout's shape
    ref = rows.detach()[index.src]
    if transposed:
        ref = ref.reshape(-1, 128, rows.shape[1]).transpose(1, 2)
    assert torch.equal(vals.detach().reshape(ref.shape), ref)
    # backward: the plain segmented sum against autograd's index backward
    leaf = rows.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(pg.gather_plain(leaf, index.src, transposed), leaf, dvals)
    got = pg.reduce_plain(dvals.contiguous(), index, rows.shape[1], transposed)
    assert bool((dvals != 0).any()) and bool((want != 0).any())
    assert torch.equal(got, want)
    # the Function's backward is the same sum
    (fn_grad,) = torch.autograd.grad(pg.gather_pairs(leaf, index, transposed), leaf, dvals)
    assert torch.equal(fn_grad, want)
    # every nonzero slot gradient belongs to a pair that holds the slot
    n_slot = index.src.shape[0]
    held = torch.zeros(n_slot, dtype=torch.bool)
    held[index.pair_slot[index.pair_slot >= 0]] = True
    assert not bool((pg._slot_rows(dvals, rows.shape[1], transposed) != 0).any(1)[~held].any())


def _layout_index(monkeypatch, kind):
    """(rows, index) the layout of kind gathers through, on the `tail` case."""
    proj, colors, ops, caps = _case("tail")
    seen = {}
    real = tiled.gather_pairs

    def record(rows, index, transposed):
        seen.update(rows=rows.detach(), index=index)
        return real(rows, index, transposed)

    monkeypatch.setattr(tiled, "gather_pairs", record)
    LAYOUTS[kind](proj, colors, ops, caps)
    return seen["rows"], seen["index"]


@pytest.mark.parametrize("kind", ["tilegrid", "stream", "window"])
def test_pair_slots_are_distinct_and_in_gaussian_order(monkeypatch, kind):
    """Each held slot belongs to one pair, a slot's source row is its pair's
    Gaussian, and a Gaussian's slots increase with its pairs."""
    _, idx = _layout_index(monkeypatch, kind)
    s_n, n = idx.order.shape
    mp = idx.pair_slot.shape[1]
    held = idx.pair_slot[idx.pair_slot >= 0]
    assert held.numel() > 0 and held.unique().numel() == held.numel()
    g_of_pair = tiled.pair_owner(idx.offsets, idx.counts, mp)
    row_of_pair = torch.gather(idx.order, 1, g_of_pair) + torch.arange(s_n)[:, None] * n
    ok = idx.pair_slot >= 0
    assert torch.equal(idx.src[idx.pair_slot[ok]], row_of_pair[ok])
    for s in range(s_n):
        for g in range(n):
            lo = int(idx.offsets[s, g])
            q = idx.pair_slot[s, lo:min(lo + int(idx.counts[s, g]), mp)]
            q = q[q >= 0]
            assert bool((q[1:] > q[:-1]).all())


def test_cpu_gather_counts_no_launch():
    proj, colors, ops, caps = _case("tail")
    pg.PairGather.reset_launch_counts()
    lay = tiled.tilegrid_layout_scenes(proj, colors, ops, caps)
    lay.vals.sum().backward()
    assert (pg.PairGather.gather_launches, pg.PairGather.reduce_launches) == (0, 0)


@pytest.mark.parametrize("bad", ["rows_dtype", "rows_count", "index_dtype", "ragged_chunks"])
def test_gather_rejects_what_the_kernel_does_not_take(monkeypatch, bad):
    rows, index = _layout_index(monkeypatch, "tilegrid")
    transposed = True
    if bad == "rows_dtype":
        rows = rows.double()
    elif bad == "rows_count":
        rows = rows[1:]
    elif bad == "index_dtype":
        index = index._replace(pair_slot=index.pair_slot.int())
    else:
        index = index._replace(src=index.src[1:])
    with pytest.raises(ValueError):
        pg.gather(rows, index, transposed)
