"""The compositor CUDA kernels (tile-grid forward, both tile-grid backward
flavors, the stream pair, the chunked and simple windowed pairs) and the
layouts' pair gather against their plain twins and the oracle, and the tile-grid, stream and both
windowed pairs against their cull-off instances, on the card. Marked `cuda`; without a
CUDA device every test skips.

On a machine with a GPU (no JAX needed there):
    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py

Tolerances: the JAX suite's cross-backend bounds (tests/test_pallas_raster.py):
forward 3e-4 (image, alpha) and 3e-3 (depth); gradients atol 2e-4,
rtol 1e-3; the exact-total render's gradients within 5e-6 of the oracle
(:301-347).
"""
import dataclasses

import numpy as np
import pytest
import torch

from egogaussian_tpu_torch.ops.covariance import covariance_from_scaling_rotation
from egogaussian_tpu_torch.render import cuda_raster as cr
from egogaussian_tpu_torch.render import stream_raster as sr
from egogaussian_tpu_torch.render import window_raster as wr
from egogaussian_tpu_torch.render.api import render
from egogaussian_tpu_torch.render.camera import Camera, look_at
from egogaussian_tpu_torch.render.probe_layouts import (
    SIMPLE_PROBE_ROWS,
    quadrant_scene,
    simple_window_probe,
    stream_probe,
    window_probe,
)
from egogaussian_tpu_torch.render.tiled import (
    TileConfig,
    stream_layout,
    tilegrid_layout,
    window_layout,
)
from egogaussian_tpu_torch.render.project import project_gaussians

pytestmark = pytest.mark.cuda
W, H = 48, 32


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _scene(dev, n=60, seed=11):
    rng = np.random.RandomState(seed)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    means = t(rng.randn(n, 3))
    cov3d = covariance_from_scaling_rotation(t(np.exp(rng.randn(n, 3) * 0.3 - 2.5)),
                                             t(rng.randn(n, 4)))
    return means, cov3d, t(rng.rand(n, 3)), t(rng.uniform(0.3, 0.95, n))


def _camera(dev):
    R, t = look_at(np.array([0.0, 0.0, -4.0]), np.zeros(3))
    return Camera.from_colmap(R, t, 60.0, 60.0, W, H, device=dev)


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("d", [3, 1])
def test_kernels_match_plain_twins(dev, d, tile_size):
    means, cov3d, colors, ops = _scene(dev)
    cam = _camera(dev)
    proj = project_gaussians(means, cov3d, cam.viewmat, cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    lay = tilegrid_layout(proj, colors[:, :d], ops, W, H,
                          TileConfig(max_per_tile=256, max_pairs=8192, tile_size=tile_size))
    meta, vals = lay.meta, lay.vals.detach().contiguous()
    bg = torch.rand((1, d), device=dev)
    cr.TileGridCompositor.reset_launch_counts()
    k_out = cr.tilegrid_forward(meta, vals, bg, tile_size, lay.n_tx)
    p_out = cr.composite_tilegrid_plain_fwd(meta, vals, bg, tile_size, lay.n_tx)
    for k, p, tol in zip(k_out, p_out, (3e-4, 3e-4, 3e-3)):
        torch.testing.assert_close(k, p, atol=tol, rtol=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cots = [torch.randn(o.shape, generator=gen, device=dev) * 1e-2 for o in p_out]
    saved = [o.detach() for o in p_out]
    fit = int(meta[2, 0])
    k_d = cr.tilegrid_backward(meta, vals, bg, *saved, *cots, tile_size, lay.n_tx)[:fit]
    p_d = cr.composite_tilegrid_plain_bwd(meta, vals, bg, *saved, *cots, tile_size,
                                          lay.n_tx)[:fit]
    torch.testing.assert_close(k_d, p_d, atol=2e-4, rtol=1e-3)
    torch.cuda.synchronize()
    assert cr.TileGridCompositor.fwd_launches[d] == 1
    assert cr.TileGridCompositor.bwd_launches[d] == 1


def test_backward_repeats_bit_for_bit(dev):
    """Fixed-order reductions, no float atomics: two runs are identical."""
    means, cov3d, colors, ops = _scene(dev, n=400, seed=3)
    cam = _camera(dev)
    proj = project_gaussians(means, cov3d, cam.viewmat, cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    lay = tilegrid_layout(proj, colors, ops, W, H, TileConfig(max_pairs=16384, tile_size=16))
    vals = lay.vals.detach().contiguous()
    bg = torch.zeros((1, 3), device=dev)
    out = cr.tilegrid_forward(lay.meta, vals, bg, 16, lay.n_tx)
    cots = [torch.ones_like(o) for o in out]
    a = cr.tilegrid_backward(lay.meta, vals, bg, *out, *cots, 16, lay.n_tx)
    b = cr.tilegrid_backward(lay.meta, vals, bg, *out, *cots, 16, lay.n_tx)
    fit = int(lay.meta[2, 0])
    assert torch.equal(a[:fit], b[:fit])


def test_cuda_render_grads_match_oracle(dev):
    means, cov3d, colors, ops = _scene(dev, seed=14)
    cam = _camera(dev)
    bg = torch.tensor([0.3, 0.2, 0.1], device=dev)
    target = torch.rand((3, H, W), generator=torch.Generator(device=dev).manual_seed(15),
                        device=dev)

    def grads(backend):
        args = [x.clone().requires_grad_(True) for x in (means, colors, ops)]
        r = render(cam, args[0], cov3d, args[2], bg, colors_precomp=args[1], backend=backend,
                   tile_config=TileConfig(max_per_tile=256, max_pairs=8192))
        loss = (torch.mean((r.image - target) ** 2) + 0.3 * torch.mean(r.alpha)
                + 0.1 * torch.mean(r.depth))
        return torch.autograd.grad(loss, args)

    for a, b in zip(grads("cuda"), grads("oracle")):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-3)


def _project(dev, means, cov3d):
    cam = _camera(dev)
    return project_gaussians(means, cov3d, cam.viewmat, cam.fx, cam.fy, cam.cx, cam.cy, W, H)


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("d", [3, 1])
def test_exact_total_kernel_matches_twin(dev, d, tile_size):
    means, cov3d, colors, ops = _scene(dev, n=300, seed=5)
    lay = tilegrid_layout(_project(dev, means, cov3d), colors[:, :d], ops, W, H,
                          TileConfig(max_pairs=16384, tile_size=tile_size))
    meta, vals = lay.meta, lay.vals.detach().contiguous()
    bg = torch.rand((1, d), device=dev)
    out = cr.composite_tilegrid_plain_fwd(meta, vals, bg, tile_size, lay.n_tx)
    gen = torch.Generator(device=dev).manual_seed(1)
    cots = [torch.randn(o.shape, generator=gen, device=dev) * 1e-2 for o in out]
    fit = int(meta[2, 0])
    cr.TileGridCompositor.reset_launch_counts()
    k_e = cr.tilegrid_backward(meta, vals, bg, *out, *cots, tile_size, lay.n_tx,
                               exact_total=True)[:fit]
    p_e = cr.composite_tilegrid_plain_bwd(meta, vals, bg, *out, *cots, tile_size, lay.n_tx,
                                          exact_total=True)[:fit]
    k_d = cr.tilegrid_backward(meta, vals, bg, *out, *cots, tile_size, lay.n_tx)[:fit]
    torch.testing.assert_close(k_e, p_e, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(k_e, k_d, atol=2e-4, rtol=1e-3)
    torch.cuda.synchronize()
    assert cr.TileGridCompositor.bwd_exact_launches[d] == 1
    assert cr.TileGridCompositor.bwd_launches[d] == 1
    # what tells the flavors apart: the exact kernel rebuilds nothing from
    # the saved outputs, so zeroing them leaves its gradient bit-identical
    zeros = [torch.zeros_like(o) for o in out]
    assert torch.equal(k_e, cr.tilegrid_backward(meta, vals, bg, *zeros, *cots, tile_size,
                                                 lay.n_tx, exact_total=True)[:fit])
    assert not torch.equal(k_d, cr.tilegrid_backward(meta, vals, bg, *zeros, *cots, tile_size,
                                                     lay.n_tx)[:fit])


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("d", [3, 1])
def test_stream_kernels_match_twins(dev, d, tile_size):
    means, cov3d, colors, ops = _scene(dev, n=300, seed=6)
    lay = stream_layout(_project(dev, means, cov3d), colors[:, :d], ops, W, H,
                        TileConfig(max_pairs=16384, tile_size=tile_size, compositor="stream"))
    meta, vals = lay.meta, lay.vals.detach().contiguous()
    n_tiles = lay.n_tx * lay.n_ty
    bg = torch.rand((1, d), device=dev)
    sr.StreamCompositor.reset_launch_counts()
    k_out = sr.stream_forward(meta, vals, bg, tile_size, lay.n_tx, n_tiles)
    p_out = sr.composite_stream_plain_fwd(meta, vals, bg, tile_size, lay.n_tx, n_tiles)
    owned = ~lay.empty  # the kernel leaves tiles that own no slot unwritten
    for k, p, tol in zip(k_out, p_out, (3e-4, 3e-4, 3e-3, 3e-4)):
        torch.testing.assert_close(k[owned], p[owned], atol=tol, rtol=0)
    gen = torch.Generator(device=dev).manual_seed(2)
    cots = [torch.randn(o.shape, generator=gen, device=dev) * 1e-2 for o in p_out[:3]]
    k_d = sr.stream_backward(meta, vals, bg, p_out[3], *cots, tile_size, lay.n_tx)
    p_d = sr.composite_stream_plain_bwd(meta, vals, bg, p_out[3], *cots, tile_size, lay.n_tx)
    torch.testing.assert_close(k_d, p_d, atol=2e-4, rtol=1e-3)
    torch.cuda.synchronize()
    assert sr.StreamCompositor.fwd_launches[d] == 1
    assert sr.StreamCompositor.bwd_launches[d] == 1


@pytest.mark.parametrize("d", [3, 1])
def test_stream_scene_launch_equals_one_scene_launches(dev, d):
    """Two scenes (the second at twice the binning capacities) in one
    stream layout and one launch of each stream kernel against each
    scene's one-scene launch, bit for bit: the forward on each scene's
    tiles that own a slot, the backward on each scene's own slots (zeros
    past them); one launch of each kernel counted."""
    from egogaussian_tpu_torch.render.project import ProjectedGaussians
    from egogaussian_tpu_torch.render.tiled import scene_caps, stream_layout_scenes

    projs, cols, opss, cfgs = [], [], [], []
    for seed in (6, 7):
        means, cov3d, colors, ops = _scene(dev, n=300, seed=seed)
        projs.append(_project(dev, means, cov3d))
        cols.append(colors[:, :d])
        opss.append(ops)
    base = TileConfig(max_pairs=16384, tile_size=32, compositor="stream")
    cfgs = [base, TileConfig(max_pairs=32768, max_per_tile=2048, tile_size=32,
                             compositor="stream")]
    bg = torch.rand((2, d), device=dev)
    stk = ProjectedGaussians(*(torch.stack(list(x)) for x in zip(*projs)))
    lay = stream_layout_scenes(stk, torch.stack(cols), torch.stack(opss),
                               scene_caps(cfgs, [(W, H)] * 2, dev, 300))
    n = lay.n_tx * lay.n_ty
    vals = lay.vals.detach().contiguous()
    sr.StreamCompositor.reset_launch_counts()
    out = sr.stream_forward(lay.meta, vals, bg, 32, lay.n_tx, 2 * n)
    gen = torch.Generator(device=dev).manual_seed(3)
    cots = [torch.randn(o.shape, generator=gen, device=dev) * 1e-2 for o in out[:3]]
    dv = sr.stream_backward(lay.meta, vals, bg, out[3], *cots, 32, lay.n_tx)
    torch.cuda.synchronize()
    assert sr.StreamCompositor.fwd_launches[d] == sr.StreamCompositor.bwd_launches[d] == 1
    per = lay.meta.shape[1] // 2 * 128
    for s in range(2):
        one = stream_layout(projs[s], cols[s], opss[s], W, H, cfgs[s])
        v1 = one.vals.detach().contiguous()
        o1 = sr.stream_forward(one.meta, v1, bg[s:s + 1].contiguous(), 32, one.n_tx, n)
        owned = ~one.empty
        for a, b in zip(out, o1):
            assert torch.equal(a[s * n:(s + 1) * n][owned], b[owned])
        d1 = sr.stream_backward(one.meta, v1, bg[s:s + 1].contiguous(), o1[3],
                                *(c[s * n:(s + 1) * n].contiguous() for c in cots), 32,
                                one.n_tx)
        assert torch.equal(dv[s * per:s * per + v1.shape[0]], d1)
        assert not dv[s * per + v1.shape[0]:(s + 1) * per].any()


def _window_split(counts, data):
    """The simple windowed pair's five inputs from a chunked window, op
    zeroed at and past each tile's count."""
    data = data.detach()
    d = data.shape[2] - 7
    rows = torch.arange(data.shape[1], device=data.device)
    live = (rows[None, :] < counts[:, None].long())[..., None]
    op = torch.where(live, data[..., 5:6], torch.zeros_like(data[..., 5:6]))
    return [x.contiguous() for x in (data[..., 0:2], data[..., 2:5], op, data[..., 6:6 + d],
                                     data[..., 6 + d:7 + d])]


@pytest.mark.parametrize("flavor", ["exact_total", "stream", "window_chunked", "window"])
def test_new_backwards_repeat_bit_for_bit(dev, flavor):
    """Fixed-order reductions, no float atomics: two runs are identical."""
    means, cov3d, colors, ops = _scene(dev, n=400, seed=3)
    proj = _project(dev, means, cov3d)
    bg = torch.zeros((1, 3), device=dev)
    if flavor.startswith("window"):
        lay = window_layout(proj, colors, ops, W, H, TileConfig(max_pairs=16384, tile_size=16))
        data = lay.data.detach().contiguous()
        out = wr.window_chunked_forward(lay.counts, data, bg, 16, lay.n_tx)
        cots = [torch.ones_like(o) for o in out[:3]]
        if flavor == "window_chunked":
            a, b = (wr.window_chunked_backward(lay.counts, data, bg, out[3], *cots, 16,
                                               lay.n_tx) for _ in range(2))
        else:
            parts = _window_split(lay.counts, lay.data)
            a, b = (torch.cat(wr.window_backward(*parts, bg, *cots, 16, lay.n_tx), dim=2)
                    for _ in range(2))
    elif flavor == "stream":
        lay = stream_layout(proj, colors, ops, W, H,
                            TileConfig(max_pairs=16384, tile_size=16, compositor="stream"))
        vals = lay.vals.detach().contiguous()
        out = sr.stream_forward(lay.meta, vals, bg, 16, lay.n_tx, lay.n_tx * lay.n_ty)
        cots = [torch.ones_like(o) for o in out[:3]]
        a, b = (sr.stream_backward(lay.meta, vals, bg, out[3], *cots, 16, lay.n_tx)
                for _ in range(2))
    else:
        lay = tilegrid_layout(proj, colors, ops, W, H, TileConfig(max_pairs=16384, tile_size=16))
        vals = lay.vals.detach().contiguous()
        out = cr.tilegrid_forward(lay.meta, vals, bg, 16, lay.n_tx)
        cots = [torch.ones_like(o) for o in out]
        fit = int(lay.meta[2, 0])
        a, b = (cr.tilegrid_backward(lay.meta, vals, bg, *out, *cots, 16, lay.n_tx,
                                     exact_total=True)[:fit] for _ in range(2))
    assert torch.equal(a, b)


@pytest.mark.parametrize("flavor", ["stream", "exact_total"])
def test_flavor_render_grads_match_oracle(dev, flavor):
    """The stream render (forward and gradients) and the exact-total render
    (gradients within 5e-6, on the JAX suite's 64x48 / 300-Gaussian
    scene) against the oracle."""
    w, h = 64, 48
    rng = np.random.RandomState(0)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    n = 300
    means = t(rng.randn(n, 3))
    cov3d = covariance_from_scaling_rotation(t(np.exp(rng.randn(n, 3) * 0.3 - 1.6)),
                                             t(rng.randn(n, 4)))
    colors, ops = t(rng.rand(n, 3)), t(rng.uniform(0.3, 0.99, n))
    R, tr = look_at(np.array([0.0, 0.0, -4.0]), np.zeros(3))
    cam = Camera.from_colmap(R, tr, 60.0, 60.0, w, h, device=dev)
    bg = t([0.2, 0.1, 0.3])
    target = t(rng.rand(3, h, w))
    cfg = TileConfig(max_pairs=16384, max_per_tile=1024, max_slots=16384,
                     compositor="stream" if flavor == "stream" else "tilegrid",
                     bwd_exact_total=flavor == "exact_total")

    def run(backend):
        args = [x.clone().requires_grad_(True) for x in (means, colors, ops)]
        r = render(cam, args[0], cov3d, args[2], bg, colors_precomp=args[1], backend=backend,
                   tile_config=cfg)
        loss = (torch.mean((r.image - target) ** 2) + 0.1 * torch.mean(r.alpha)
                + 0.01 * torch.mean(r.depth))
        return r, torch.autograd.grad(loss, args)

    cr.TileGridCompositor.reset_launch_counts()
    sr.StreamCompositor.reset_launch_counts()
    rk, gk = run("cuda")
    ro, go = run("oracle")
    for f, tol in (("image", 3e-4), ("alpha", 3e-4), ("depth", 3e-3)):
        torch.testing.assert_close(getattr(rk, f), getattr(ro, f), atol=tol, rtol=0)
    for a, b in zip(gk, go):
        if flavor == "exact_total":
            torch.testing.assert_close(a, b, atol=5e-6, rtol=0)
        else:
            torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-3)
    torch.cuda.synchronize()
    if flavor == "stream":
        assert sr.StreamCompositor.fwd_launches[3] == sr.StreamCompositor.bwd_launches[3] == 1
    else:
        assert cr.TileGridCompositor.bwd_exact_launches[3] == 1


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("d", [3, 1])
def test_window_kernels_match_twins(dev, d, tile_size):
    """The four windowed kernels against their twins on one window (tiles
    up to ~200 rows deep, so a tile spans two 128-row chunks), each counted
    once; the simple pair against the chunked pair."""
    means, cov3d, colors, ops = _scene(dev, n=300, seed=8)
    lay = window_layout(_project(dev, means, cov3d), colors[:, :d], ops, W, H,
                        TileConfig(max_pairs=16384, max_per_tile=300, tile_size=tile_size))
    counts, data = lay.counts, lay.data.detach().contiguous()
    assert data.shape[1] == 384
    bg = torch.rand((1, d), device=dev)
    wr.WindowChunkedCompositor.reset_launch_counts()
    wr.WindowCompositor.reset_launch_counts()
    k_out = wr.window_chunked_forward(counts, data, bg, tile_size, lay.n_tx)
    p_out = wr.composite_window_chunked_plain_fwd(counts, data, bg, tile_size, lay.n_tx)
    for k, p, tol in zip(k_out, p_out, (3e-4, 3e-4, 3e-3, 3e-4)):
        torch.testing.assert_close(k, p, atol=tol, rtol=0)
    gen = torch.Generator(device=dev).manual_seed(4)
    cots = [torch.randn(o.shape, generator=gen, device=dev) * 1e-2 for o in p_out[:3]]
    k_d = wr.window_chunked_backward(counts, data, bg, p_out[3], *cots, tile_size, lay.n_tx)
    p_d = wr.composite_window_chunked_plain_bwd(counts, data, bg, p_out[3], *cots, tile_size,
                                                lay.n_tx)
    torch.testing.assert_close(k_d, p_d, atol=2e-4, rtol=1e-3)
    parts = _window_split(lay.counts, lay.data)
    ks_out = wr.window_forward(*parts, bg, tile_size, lay.n_tx)
    ps_out = wr.composite_window_plain_fwd(*parts, bg, tile_size, lay.n_tx)
    for k, p, c, tol in zip(ks_out, ps_out, k_out, (3e-4, 3e-4, 3e-3)):
        torch.testing.assert_close(k, p, atol=tol, rtol=0)
        torch.testing.assert_close(k, c, atol=tol, rtol=0)
    ks_d = torch.cat(wr.window_backward(*parts, bg, *cots, tile_size, lay.n_tx), dim=2)
    ps_d = torch.cat(wr.composite_window_plain_bwd(*parts, bg, *cots, tile_size, lay.n_tx),
                     dim=2)
    torch.testing.assert_close(ks_d, ps_d, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(ks_d, k_d, atol=2e-4, rtol=1e-3)
    # the same window cut to 383 rows (every row past 300 is masked): not a
    # multiple of 4, so the kernels stage by plain loads; the same outputs
    cut = [x[:, :383].contiguous() for x in parts]
    kc_out = wr.window_forward(*cut, bg, tile_size, lay.n_tx)
    for k, p, c, tol in zip(kc_out, wr.composite_window_plain_fwd(*cut, bg, tile_size, lay.n_tx),
                            ks_out, (3e-4, 3e-4, 3e-3)):
        torch.testing.assert_close(k, p, atol=tol, rtol=0)
        torch.testing.assert_close(k, c, atol=tol, rtol=0)
    kc_d = torch.cat(wr.window_backward(*cut, bg, *cots, tile_size, lay.n_tx), dim=2)
    pc_d = torch.cat(wr.composite_window_plain_bwd(*cut, bg, *cots, tile_size, lay.n_tx), dim=2)
    torch.testing.assert_close(kc_d, pc_d, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(kc_d, ks_d[:, :383], atol=2e-4, rtol=1e-3)
    torch.cuda.synchronize()
    assert wr.WindowChunkedCompositor.fwd_launches[d] == 1
    assert wr.WindowChunkedCompositor.bwd_launches[d] == 1
    assert wr.WindowCompositor.fwd_launches[d] == wr.WindowCompositor.bwd_launches[d] == 2


def test_tiled_render_matches_oracle(dev):
    """render(backend="tiled") (the chunked windowed kernels) against the
    oracle: forward and gradients of the JAX suite's test loss."""
    means, cov3d, colors, ops = _scene(dev, seed=16)
    cam = _camera(dev)
    bg = torch.tensor([0.3, 0.2, 0.1], device=dev)
    target = torch.rand((3, H, W), generator=torch.Generator(device=dev).manual_seed(17),
                        device=dev)

    def run(backend):
        args = [x.clone().requires_grad_(True) for x in (means, colors, ops)]
        r = render(cam, args[0], cov3d, args[2], bg, colors_precomp=args[1], backend=backend)
        loss = (torch.mean((r.image - target) ** 2) + 0.3 * torch.mean(r.alpha)
                + 0.1 * torch.mean(r.depth))
        return r, torch.autograd.grad(loss, args)

    wr.WindowChunkedCompositor.reset_launch_counts()
    rk, gk = run("tiled")
    ro, go = run("oracle")
    for f, tol in (("image", 3e-4), ("alpha", 3e-4), ("depth", 3e-3)):
        torch.testing.assert_close(getattr(rk, f), getattr(ro, f), atol=tol, rtol=0)
    for a, b in zip(gk, go):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-3)
    torch.cuda.synchronize()
    assert wr.WindowChunkedCompositor.fwd_launches[3] == 1
    assert wr.WindowChunkedCompositor.bwd_launches[3] == 1


def _deep_layout(dev, d, tile_size):
    """1,000 Gaussians at 48x32: tiles of 170-630 pairs, two to five chunks."""
    means, cov3d, colors, ops = _scene(dev, n=1000, seed=9)
    lay = tilegrid_layout(_project(dev, means, cov3d), colors[:, :d], ops, W, H,
                          TileConfig(max_pairs=16384, tile_size=tile_size))
    return lay.meta, lay.vals.detach().contiguous(), lay.n_tx


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("d", [3, 1])
def test_tilegrid_cull_is_exact(dev, d, tile_size):
    """The redesigned pair (one cluster per tile, the per-warp reach-box
    cull) against the same kernels with the cull compiled out: forward and
    both backward flavors bit for bit, and against the twins."""
    meta, vals, n_tx = _deep_layout(dev, d, tile_size)
    bg = torch.rand((1, d), device=dev)
    out = cr.tilegrid_forward(meta, vals, bg, tile_size, n_tx)
    for a, b in zip(out, cr.tilegrid_forward_nocull(meta, vals, bg, tile_size, n_tx)):
        assert torch.equal(a, b)
    p_out = cr.composite_tilegrid_plain_fwd(meta, vals, bg, tile_size, n_tx)
    for k, p, tol in zip(out, p_out, (3e-4, 3e-4, 3e-3)):
        torch.testing.assert_close(k, p, atol=tol, rtol=0)
    gen = torch.Generator(device=dev).manual_seed(2)
    cots = [torch.randn(o.shape, generator=gen, device=dev) * 1e-2 for o in out]
    fit = int(meta[2, 0])
    for exact in (False, True):
        k_d = cr.tilegrid_backward(meta, vals, bg, *out, *cots, tile_size, n_tx,
                                   exact_total=exact)[:fit]
        n_d = cr.tilegrid_backward_nocull(meta, vals, bg, *out, *cots, tile_size, n_tx,
                                          exact_total=exact)[:fit]
        assert torch.equal(k_d, n_d)
        p_d = cr.composite_tilegrid_plain_bwd(meta, vals, bg, *out, *cots, tile_size, n_tx,
                                              exact_total=exact)[:fit]
        torch.testing.assert_close(k_d, p_d, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("exact_total", [False, True])
def test_tilegrid_backwards_repeat_bit_for_bit(dev, exact_total):
    """Both flavors at ts 32 (four CTAs per tile, the cluster-ordered sum):
    two runs are identical."""
    meta, vals, n_tx = _deep_layout(dev, 3, 32)
    bg = torch.zeros((1, 3), device=dev)
    out = cr.tilegrid_forward(meta, vals, bg, 32, n_tx)
    cots = [torch.ones_like(o) for o in out]
    fit = int(meta[2, 0])
    a, b = (cr.tilegrid_backward(meta, vals, bg, *out, *cots, 32, n_tx,
                                 exact_total=exact_total)[:fit] for _ in range(2))
    assert torch.equal(a, b)


@pytest.mark.parametrize("d", [3, 1])
def test_tile_wide_saturation_vote(dev, d):
    """probe_layouts.quadrant_scene: one quadrant of a tile saturates after two
    chunks while the rest stays live. The third chunk's gradient rows are
    zero exactly where the twin's are: nonzero for the splats seen only in
    the saturated quadrant (the vote is the tile's, not the quadrant's), and
    all zero in the other tile's skipped chunk."""
    meta, vals, bg, n_tx, _, _ = (torch.as_tensor(x, device=dev) if not isinstance(x, int)
                                  else x for x in quadrant_scene(d))
    out = cr.composite_tilegrid_plain_fwd(meta, vals, bg, 32, n_tx)
    for k, p, tol in zip(cr.tilegrid_forward(meta, vals, bg, 32, n_tx), out, (3e-4, 3e-4, 3e-3)):
        torch.testing.assert_close(k, p, atol=tol, rtol=0)
    gen = torch.Generator(device=dev).manual_seed(3)
    cots = [torch.randn(o.shape, generator=gen, device=dev) * 1e-3 for o in out]
    for exact in (False, True):
        k_d = cr.tilegrid_backward(meta, vals, bg, *out, *cots, 32, n_tx, exact_total=exact)
        p_d = cr.composite_tilegrid_plain_bwd(meta, vals, bg, *out, *cots, 32, n_tx,
                                              exact_total=exact)
        torch.testing.assert_close(k_d, p_d, atol=2e-4, rtol=1e-3)
        assert torch.equal(k_d[[2, 4]] == 0, p_d[[2, 4]] == 0)
        assert bool((p_d[2, :7 + d, :20] != 0).any(dim=0).all())
        assert bool((k_d[4] == 0).all())


def _deep_window(dev, d, tile_size):
    """1,000 Gaussians at 48x32 as a gather window: tiles of 170-630 rows."""
    means, cov3d, colors, ops = _scene(dev, n=1000, seed=9)
    lay = window_layout(_project(dev, means, cov3d), colors[:, :d], ops, W, H,
                        TileConfig(max_pairs=16384, tile_size=tile_size))
    return lay.counts, lay.data.detach().contiguous(), torch.rand((1, d), device=dev), lay.n_tx


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("d", [3, 1])
def test_window_chunked_cull_is_exact(dev, d, tile_size):
    """The redesigned chunked windowed pair (a 16x16 quadrant per CTA, at
    ts 32 four per tile and the backward as a cluster, the per-warp
    reach-box cull) on render/probe_layouts.py:window_probe and on a deep
    window: forward and backward against the cull-off instances bit for
    bit, the backward run twice bit for bit, and both against the twins."""
    counts, data, bg, n_tx, _, _ = window_probe(d, tile_size)
    probe = tuple(torch.as_tensor(x, device=dev) for x in (counts, data, bg)) + (n_tx,)
    for counts, data, bg, n_tx in (probe, _deep_window(dev, d, tile_size)):
        out = wr.window_chunked_forward(counts, data, bg, tile_size, n_tx)
        for a, b in zip(out, wr.window_chunked_forward_nocull(counts, data, bg, tile_size, n_tx)):
            assert torch.equal(a, b)
        p_out = wr.composite_window_chunked_plain_fwd(counts, data, bg, tile_size, n_tx)
        for k, p, tol in zip(out, p_out, (3e-4, 3e-4, 3e-3, 3e-4)):
            torch.testing.assert_close(k, p, atol=tol, rtol=0)
        gen = torch.Generator(device=dev).manual_seed(5)
        cots = [torch.randn(o.shape, generator=gen, device=dev) * 1e-2 for o in out[:3]]
        k_d = wr.window_chunked_backward(counts, data, bg, out[3], *cots, tile_size, n_tx)
        assert torch.equal(k_d, wr.window_chunked_backward_nocull(counts, data, bg, out[3], *cots,
                                                                  tile_size, n_tx))
        assert torch.equal(k_d, wr.window_chunked_backward(counts, data, bg, out[3], *cots,
                                                           tile_size, n_tx))
        p_d = wr.composite_window_chunked_plain_bwd(counts, data, bg, out[3], *cots, tile_size,
                                                    n_tx)
        torch.testing.assert_close(k_d, p_d, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("d", [3, 1])
def test_window_simple_cull_is_exact(dev, d, tile_size):
    """The redesigned simple windowed pair (a 16x16 quadrant per CTA, at
    ts 32 four per tile and the backward as a cluster, the per-warp
    reach-box cull, all-masked chunks skipped) on render/probe_layouts.py:
    simple_window_probe at 300 and 258 rows and on a deep window: forward
    and backward against the cull-off instances bit for bit, the backward
    run twice bit for bit, and both against the twins."""
    windows = []
    for m in SIMPLE_PROBE_ROWS:
        *parts, bg, n_tx, _, _ = simple_window_probe(d, tile_size, m)
        windows.append(([torch.as_tensor(x, device=dev) for x in parts],
                        torch.as_tensor(bg, device=dev), n_tx))
    counts, data, bg, n_tx = _deep_window(dev, d, tile_size)
    windows.append((_window_split(counts, data), bg, n_tx))
    for parts, bg, n_tx in windows:
        out = wr.window_forward(*parts, bg, tile_size, n_tx)
        for a, b in zip(out, wr.window_forward_nocull(*parts, bg, tile_size, n_tx)):
            assert torch.equal(a, b)
        for k, p, tol in zip(out, wr.composite_window_plain_fwd(*parts, bg, tile_size, n_tx),
                             (3e-4, 3e-4, 3e-3)):
            torch.testing.assert_close(k, p, atol=tol, rtol=0)
        gen = torch.Generator(device=dev).manual_seed(6)
        cots = [torch.randn(o.shape, generator=gen, device=dev) * 1e-2 for o in out]
        k_d = torch.cat(wr.window_backward(*parts, bg, *cots, tile_size, n_tx), dim=2)
        n_d = torch.cat(wr.window_backward_nocull(*parts, bg, *cots, tile_size, n_tx), dim=2)
        r_d = torch.cat(wr.window_backward(*parts, bg, *cots, tile_size, n_tx), dim=2)
        assert torch.equal(k_d, n_d) and torch.equal(k_d, r_d)
        p_d = torch.cat(wr.composite_window_plain_bwd(*parts, bg, *cots, tile_size, n_tx), dim=2)
        torch.testing.assert_close(k_d, p_d, atol=2e-4, rtol=1e-3)


def _deep_stream(dev, d, tile_size):
    """1,000 Gaussians at 48x32 as a stream layout (runs of 2-5 chunks)."""
    means, cov3d, colors, ops = _scene(dev, n=1000, seed=9)
    lay = stream_layout(_project(dev, means, cov3d), colors[:, :d], ops, W, H,
                        TileConfig(max_pairs=16384, tile_size=tile_size, compositor="stream"))
    return (lay.meta, lay.vals.detach().contiguous(), torch.rand((1, d), device=dev), lay.n_tx,
            lay.n_tx * lay.n_ty)


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("d", [3, 1])
def test_stream_cull_is_exact(dev, d, tile_size):
    """The redesigned stream pair (the chunked windowed pair's body over a
    grid of tiles, each finding its run of slots by a warp search) on
    render/probe_layouts.py:stream_probe, whole and cut at the slot
    capacity, and on a deep layout: on the tiles that own a slot the
    forward equals its cull-off instance bit for bit; the backward equals
    its cull-off instance and a second run bit for bit; both match the
    twins; every padding slot's gradient is zero."""
    cases = [_deep_stream(dev, d, tile_size)]
    for cut in (False, True):
        meta, vals, bg, n_tx, _, _ = stream_probe(d, tile_size, cut)
        cases.append(tuple(torch.as_tensor(x, device=dev) for x in (meta, vals, bg))
                     + (n_tx, n_tx))
    for meta, vals, bg, n_tx, n_tiles in cases:
        written = torch.zeros(n_tiles, dtype=torch.bool, device=dev)
        written[meta[0].long()] = True
        out = sr.stream_forward(meta, vals, bg, tile_size, n_tx, n_tiles)
        for a, b in zip(out, sr.stream_forward_nocull(meta, vals, bg, tile_size, n_tx, n_tiles)):
            assert torch.equal(a[written], b[written])
        p_out = sr.composite_stream_plain_fwd(meta, vals, bg, tile_size, n_tx, n_tiles)
        real = torch.zeros_like(written)
        real[meta[0].long()[meta[1] < meta[2]]] = True
        for k, p, tol in zip(out, p_out, (3e-4, 3e-4, 3e-3, 3e-4)):
            torch.testing.assert_close(k[real], p[real], atol=tol, rtol=0)
        gen = torch.Generator(device=dev).manual_seed(5)
        cots = [torch.randn(o.shape, generator=gen, device=dev) * 1e-2 for o in out[:3]]
        k_d = sr.stream_backward(meta, vals, bg, out[3], *cots, tile_size, n_tx)
        assert torch.equal(k_d, sr.stream_backward_nocull(meta, vals, bg, out[3], *cots,
                                                          tile_size, n_tx))
        assert torch.equal(k_d, sr.stream_backward(meta, vals, bg, out[3], *cots, tile_size,
                                                   n_tx))
        p_d = sr.composite_stream_plain_bwd(meta, vals, bg, out[3], *cots, tile_size, n_tx)
        torch.testing.assert_close(k_d, p_d, atol=2e-4, rtol=1e-3)
        pad = (meta[1] >= meta[2]).repeat_interleave(128)
        assert not k_d[pad].any()


def test_fma_chain_matches_twin(dev):
    """The FMA-peak probe against its twin at n_loop 1,000, bit for bit
    (each step moves x by 1-2 ulp, so a skipped step shows), and the
    measured rate is a positive number."""
    from egogaussian_tpu_torch.utils import peak

    x = torch.as_tensor(np.random.RandomState(0).uniform(1.0, 1.45, (64, 128)).astype(np.float32),
                        device=dev)
    peak.FmaChain.reset_launch_counts()
    k = peak.fma_chain(x, 1000)
    torch.cuda.synchronize()
    assert peak.FmaChain.launches == 1
    assert torch.equal(k, peak.fma_chain_plain(x, 1000))
    assert peak.fma_peak_gflops(dev, n_loop=10_000) > 0


@pytest.mark.parametrize("d", [3, 1])
@pytest.mark.parametrize("tile_size", [16, 32])
def test_scene_axis_launch_equals_one_scene_launches(dev, d, tile_size):
    """Two scenes (the second at twice the binning capacities) in one
    launch of the tile-grid pair (both backward flavors) and the chunked
    windowed pair against each scene's one-scene launch, bit for bit;
    each wrapper counts one launch per call."""
    from egogaussian_tpu_torch.render.project import ProjectedGaussians
    from egogaussian_tpu_torch.render.tiled import (
        scene_caps,
        tilegrid_layout_scenes,
        window_layout_scenes,
    )

    cam = _camera(dev)
    scenes = []
    for seed in (11, 12):
        means, cov3d, cols, ops = _scene(dev, seed=seed)
        proj = project_gaussians(means, cov3d, cam.viewmat, cam.fx, cam.fy, cam.cx, cam.cy,
                                 W, H)
        scenes.append((proj, cols[:, :d].contiguous(), ops))
    cfg = TileConfig(max_per_tile=256, max_pairs=8192, tile_size=tile_size)
    cfgs = [cfg, TileConfig(max_per_tile=512, max_pairs=16384, max_slots=16384,
                            tile_size=tile_size)]
    bgs = [torch.full((d,), 0.2, device=dev), torch.full((d,), 0.6, device=dev)]
    caps = scene_caps(cfgs, [(W, H)] * 2, dev, 60)
    stk = ProjectedGaussians(*(torch.stack(list(x)) for x in zip(*(s[0] for s in scenes))))
    cols = torch.stack([s[1] for s in scenes])
    ops = torch.stack([s[2] for s in scenes])
    lay = tilegrid_layout_scenes(stk, cols, ops, caps)
    wlay = window_layout_scenes(stk, cols, ops, caps)
    bg = torch.stack(bgs)
    ts, n_tx, n_t = lay.tile_size, lay.n_tx, lay.n_tx * lay.n_ty
    vals, data = lay.vals.detach().contiguous(), wlay.data.detach().contiguous()
    cr.TileGridCompositor.reset_launch_counts()
    out = cr.tilegrid_forward(lay.meta, vals, bg, ts, n_tx)
    assert cr.TileGridCompositor.fwd_launches[d] == 1
    gen = torch.Generator(device=dev).manual_seed(3)
    cot = [torch.randn(x.shape, generator=gen, device=dev) for x in out]
    dv = {e: cr.tilegrid_backward(lay.meta, vals, bg, *out, *cot, ts, n_tx, exact_total=e)
          for e in (False, True)}
    wout = wr.window_chunked_forward(wlay.counts, data, bg, ts, n_tx)
    wdd = wr.window_chunked_backward(wlay.counts, data, bg, wout[3], *cot, ts, n_tx)
    sps = vals.shape[0] // 2
    for s, ((p, c, o), cfg_s, b) in enumerate(zip(scenes, cfgs, bgs)):
        one = tilegrid_layout(p, c, o, W, H, cfg_s)
        v1 = one.vals.detach().contiguous()
        o1 = cr.tilegrid_forward(one.meta, v1, b[None], ts, n_tx)
        sl = slice(s * n_t, (s + 1) * n_t)
        assert all(torch.equal(a[sl], b1) for a, b1 in zip(out, o1))
        fit = int(one.meta[2, 0])
        for e in (False, True):
            d1 = cr.tilegrid_backward(one.meta, v1, b[None], *o1, *(x[sl] for x in cot), ts,
                                      n_tx, exact_total=e)
            assert torch.equal(dv[e][s * sps:s * sps + fit], d1[:fit])
        w1 = window_layout(p, c, o, W, H, cfg_s)
        wd = w1.data.detach().contiguous()
        wo1 = wr.window_chunked_forward(w1.counts, wd, b[None], ts, n_tx)
        assert all(torch.equal(a[sl], b1) for a, b1 in zip(wout, wo1))
        wd1 = wr.window_chunked_backward(w1.counts, wd, b[None], wo1[3], *(x[sl] for x in cot),
                                         ts, n_tx)
        assert torch.equal(wdd[sl, :wd.shape[1]], wd1)
        assert not bool(wdd[sl, wd.shape[1]:].any())


@pytest.mark.parametrize("kind", ["tilegrid", "stream", "window"])
def test_pair_gather_at_the_cells_sizes(dev, kind, monkeypatch):
    """render/pair_gather.py on the card at the static training cell's sizes
    (probe_layouts.gather_scene: 500k Gaussians, 1600x900, ts 32, estimated
    capacities): the gather kernel against rows[src], the reduce kernel
    against its plain twin and against autograd's CUDA index backward of
    rows[src] on the gradient of the layout's own compositor, bit for bit
    (torch.equal: up to the sign of a zero); one launch of each per layout
    forward and backward."""
    from egogaussian_tpu_torch.render import pair_gather as pg
    from egogaussian_tpu_torch.render import tiled
    from egogaussian_tpu_torch.render.probe_layouts import gather_scene
    from egogaussian_tpu_torch.render.project import ProjectedGaussians

    width, height = 1600, 900
    means, scales, quats, colors, ops, focal = gather_scene(width=width, height=height)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    R, tr = look_at(np.array([0.0, 0.0, -4.0]), np.zeros(3))
    cam = Camera.from_colmap(R, tr, focal, focal, width, height, device=dev)
    proj = project_gaussians(t(means), covariance_from_scaling_rotation(t(scales), t(quats)),
                             cam.viewmat, cam.fx, cam.fy, cam.cx, cam.cy, width, height)
    cfg = tiled.estimate_tile_config(proj.means2d, proj.radii, width, height, tile_size=32,
                                     opacities=t(ops))
    if kind == "stream":
        cfg = dataclasses.replace(cfg, compositor="stream")
    caps = tiled.scene_caps([cfg], [(width, height)], dev, means.shape[0])
    lead = ProjectedGaussians(*(x.detach()[None].requires_grad_(x.is_floating_point())
                                for x in proj))
    seen = {}
    real = tiled.gather_pairs

    def record(rows, index, transposed):
        vals = real(rows, index, transposed)
        vals.retain_grad()
        seen.update(rows=rows.detach(), index=index, transposed=transposed, vals=vals)
        return vals

    monkeypatch.setattr(tiled, "gather_pairs", record)
    pg.PairGather.reset_launch_counts()
    fn = {"tilegrid": tiled.tilegrid_layout_scenes, "stream": tiled.stream_layout_scenes,
          "window": tiled.window_layout_scenes}[kind]
    lay = fn(lead, t(colors)[None], t(ops)[None], caps)
    image, alpha, depth = tiled._composite(lay, torch.zeros((1, 3), device=dev), caps)
    gen = torch.Generator(device=dev).manual_seed(0)
    sum(torch.sum(x * torch.rand(x.shape, device=dev, generator=gen))
        for x in (image, alpha, depth)).backward()
    torch.cuda.synchronize()
    assert (pg.PairGather.gather_launches, pg.PairGather.reduce_launches) == (1, 1)
    rows, index, transposed = seen["rows"], seen["index"], seen["transposed"]
    dvals = seen["vals"].grad
    assert torch.equal(seen["vals"].detach(), pg.gather_plain(rows, index.src, transposed))
    leaf = rows.clone().requires_grad_(True)
    (lib,) = torch.autograd.grad(pg.gather_plain(leaf, index.src, transposed), leaf, dvals)
    got = pg.reduce(dvals, index, rows.shape[1], transposed)
    assert pg.PairGather.reduce_launches == 2
    assert bool((lib != 0).any())
    assert torch.equal(got, pg.reduce_plain(dvals, index, rows.shape[1], transposed))
    assert torch.equal(got, lib)
