"""Tile-grid CUDA kernels against their plain twins and the oracle, on the
card. Marked `cuda`; without a CUDA device every test skips.

On a machine with a GPU (no JAX needed there):
    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py

Tolerances: the JAX suite's cross-backend bounds (tests/test_pallas_raster.py):
forward 3e-4 (image, alpha) and 3e-3 (depth); gradients atol 2e-4,
rtol 1e-3.
"""
import numpy as np
import pytest
import torch

from egogaussian_tpu_torch.ops.covariance import covariance_from_scaling_rotation
from egogaussian_tpu_torch.render import cuda_raster as cr
from egogaussian_tpu_torch.render.api import render
from egogaussian_tpu_torch.render.camera import Camera, look_at
from egogaussian_tpu_torch.render.tiled import TileConfig, tilegrid_layout
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
