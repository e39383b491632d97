"""The port's FMA-peak probe and kernel bounds (egogaussian_tpu_torch/utils/
peak.py) on the CPU: the probe's twin against the TPU kernel's body
(bench.py:_vpu_peak_gflops, `kern`), the bound arithmetic, and the
covered-evaluation count against a brute-force count from the oracle's
alpha, on the layout whose pairs every compositor layout holds.

Tolerances: the twin rounds once per step (a fused multiply-add), the TPU
body twice (multiply, then add). In [1, 2), x * 1.0000001 (1 + 2^-23 in
float32) adds x * 2^-23, 1 to 2 ulps of x, and 1e-9 is 0.0084 ulp; the two
roundings differ only where the first lands within 0.0084 ulp below a
half ulp (x in [1.4916, 1.5)). On inputs in [1.0, 1.45), and on the ones
the TPU bench feeds it, they agree bit for bit after 64 steps, so the
check is exact: one step more or less moves every element by 1-2 ulps.
Counts are exact.
"""
import numpy as np
import pytest
import torch

from egogaussian_tpu_torch.ops.covariance import covariance_from_scaling_rotation
from egogaussian_tpu_torch.render.camera import Camera, look_at
from egogaussian_tpu_torch.render.oracle import pixel_alphas
from egogaussian_tpu_torch.render.project import project_gaussians
from egogaussian_tpu_torch.render.tiled import (
    TileConfig,
    stream_layout,
    tilegrid_layout,
    window_layout,
)
from egogaussian_tpu_torch.utils import peak

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 48, 32


def test_fma_chain_twin_matches_tpu_kernel_body():
    """bench.py:274-275, `x * 1.0000001 + 1e-9` n_loop times, in numpy
    float32, against the twin on the same seeded [256, 128] block, and on
    the bench's own block of ones."""
    x = np.random.RandomState(0).uniform(1.0, 1.45, (256, 128)).astype(np.float32)
    for block in (x, np.ones((256, 128), np.float32)):
        ref = block.copy()
        for _ in range(64):
            ref = ref * np.float32(1.0000001) + np.float32(1e-9)
        out = peak.fma_chain_plain(torch.as_tensor(block), 64)
        assert out.dtype == torch.float32 and out.shape == (256, 128)
        np.testing.assert_array_equal(out.numpy(), ref)
        # a chain one step short differs everywhere
        short = peak.fma_chain_plain(torch.as_tensor(block), 63).numpy()
        assert (short != ref).all()


def test_fma_chain_wrapper_takes_the_twin_on_the_cpu():
    peak.FmaChain.reset_launch_counts()
    x = torch.linspace(0.5, 1.5, 4 * 128).reshape(4, 128)
    assert torch.equal(peak.fma_chain(x, 10), peak.fma_chain_plain(x, 10))
    assert peak.FmaChain.launches == 0
    with pytest.raises(ValueError):
        peak.fma_chain(torch.ones(4, 64), 10)
    with pytest.raises(ValueError):
        peak.fma_peak_gflops(CPU)


def test_bound_arithmetic():
    """Instructions over 33.5e12/s (the published 67 TFLOP/s counts an FMA
    as two flops), bytes over 3.35e12 B/s, the larger one."""
    assert peak.FP32_INSTR_PER_S == 33.5e12
    assert peak.ops_per_eval("fwd", 3) == 26 and peak.ops_per_eval("bwd", 3) == 68
    assert peak.ops_per_eval("bwd2", 1) == 56 + 22
    ms, by = peak.bound("fwd", 3, 10**9, 10**6)
    assert by == "operations"
    assert ms == pytest.approx(10**9 * 26 / 33.5e12 * 1e3, rel=1e-12)
    ms, by = peak.bound("bwd", 1, 10, 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0, rel=1e-12)


def _scene(seed=11, n=60):
    rng = np.random.RandomState(seed)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
    means = t(rng.randn(n, 3))
    cov3d = covariance_from_scaling_rotation(t(np.exp(rng.randn(n, 3) * 0.3 - 2.5)),
                                             t(rng.randn(n, 4)))
    R, tr = look_at(np.array([0.0, 0.0, -4.0]), np.zeros(3))
    cam = Camera.from_colmap(R, tr, 60.0, 60.0, W, H, device=CPU)
    proj = project_gaussians(means, cov3d, cam.viewmat, cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    return proj, t(rng.rand(n, 3)), t(rng.uniform(0.3, 0.95, n))


def _brute_force(lay):
    """Every tile's pairs (read from its chunk slots) against every pixel
    of the tile through the oracle's pixel_alphas: pairs with alpha > 0."""
    ts, n_tx = lay.tile_size, lay.n_tx
    total = 0
    for t in range(lay.meta.shape[1]):
        start, cnt = int(lay.meta[0, t]), int(lay.meta[1, t])
        if cnt == 0:
            continue
        rows = lay.vals[start:start + -(-cnt // 128)].transpose(1, 2).reshape(-1, lay.vals.shape[1])
        rows = rows[:cnt]
        ys, xs = torch.meshgrid(torch.arange(ts, dtype=torch.float32) + (t // n_tx) * ts + 0.5,
                                torch.arange(ts, dtype=torch.float32) + (t % n_tx) * ts + 0.5,
                                indexing="ij")
        alpha = pixel_alphas(rows[:, 0:2], rows[:, 2:5], rows[:, 5], xs, ys,
                             torch.ones(cnt, dtype=torch.bool))
        total += int((alpha > 0).sum())
    return total


@pytest.mark.parametrize("tile_size", [16, 32])
def test_covered_evaluations_match_brute_force(tile_size, monkeypatch):
    proj, colors, ops = _scene()
    cfg = TileConfig(max_per_tile=256, max_pairs=8192, tile_size=tile_size)
    lay = tilegrid_layout(proj, colors, ops, W, H, cfg)
    assert int(lay.dropped) == 0
    monkeypatch.setattr(peak, "TILE_BATCH", 2)  # several batches of tiles at ts 16
    got = peak.covered_evaluations(lay.meta, lay.vals, tile_size, lay.n_tx)
    assert got == _brute_force(lay)
    # fewer than the dense count (pairs x pixels), more than none
    assert 0 < got < int(lay.meta[1].sum()) * tile_size * tile_size


@pytest.mark.parametrize("tile_size", [16, 32])
def test_layouts_hold_the_same_pairs(tile_size):
    """The stream layout and the gather window of one binning hold the
    tile-grid layout's pairs in its order, so the covered count of the
    tile-grid layout is every compositor's (chip_smoke.py's bounds of rows
    4-9)."""
    proj, colors, ops = _scene(seed=12)
    cfg = TileConfig(max_per_tile=256, max_pairs=8192, tile_size=tile_size)
    lay = tilegrid_layout(proj, colors, ops, W, H, cfg)
    slay = stream_layout(proj, colors, ops, W, H, TileConfig(
        max_per_tile=256, max_pairs=8192, tile_size=tile_size, compositor="stream"))
    wlay = window_layout(proj, colors, ops, W, H, cfg)
    assert int(lay.dropped) == int(slay.dropped) == int(wlay.dropped) == 0
    ch = slay.vals.shape[1]
    assert torch.equal(slay.vals.reshape(-1, 128, ch).transpose(1, 2), lay.vals[:, :ch])
    assert torch.equal(wlay.counts.long(), lay.meta[1].long())
    for t in range(lay.meta.shape[1]):
        start, cnt = int(lay.meta[0, t]), int(lay.meta[1, t])
        rows = lay.vals[start:start + -(-cnt // 128)].transpose(1, 2).reshape(-1, lay.vals.shape[1])
        assert torch.equal(wlay.data[t, :cnt], rows[:cnt, :ch])
    assert 0 < peak.covered_evaluations(lay.meta, lay.vals, tile_size, lay.n_tx)
