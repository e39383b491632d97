"""Port render path: projection, oracle and binning against JAX; the
tile-grid plain twins against autograd, capacity overflow, the saturation
skip, and the wrapper's dispatch rules.

Tolerances: projection and binning inputs are elementwise float32 math in
the same order (atol 1e-5 on pixel coordinates); binning outputs are
integers and must be EQUAL. The oracle's forward sums 60 log-space terms
per pixel (atol 1e-6) and its gradients carry the summation-order
difference of the reductions (atol 1e-6 on values of scale 1e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egogaussian_tpu.ops import covariance_from_scaling_rotation as j_cov
from egogaussian_tpu.render.api import render as j_render
from egogaussian_tpu.render.camera import Camera as JCamera
from egogaussian_tpu.render.project import project_gaussians as j_project
from egogaussian_tpu.render.tiled import TileConfig as JTileConfig
from egogaussian_tpu.render.tiled import bin_pairs as j_bin_pairs
from egogaussian_tpu_torch.ops.covariance import covariance_from_scaling_rotation as t_cov
from egogaussian_tpu_torch.render import cuda_raster as cr
from egogaussian_tpu_torch.render.api import render as t_render
from egogaussian_tpu_torch.render.camera import Camera, look_at
from egogaussian_tpu_torch.render.project import project_gaussians as t_project
from egogaussian_tpu_torch.render.tiled import TileConfig, bin_pairs, tilegrid_layout

torch.set_num_threads(1)
CPU = torch.device("cpu")


def scene(n=60, seed=0, spread=1.0):
    rng = np.random.RandomState(seed)
    return dict(
        means=(spread * rng.randn(n, 3)).astype(np.float32),
        scales=np.exp(rng.randn(n, 3) * 0.3 - 2.5).astype(np.float32),
        quats=rng.randn(n, 4).astype(np.float32),
        colors=rng.rand(n, 3).astype(np.float32),
        ops=rng.uniform(0.3, 0.95, n).astype(np.float32),
    )


def cameras(width=48, height=32, focal=60.0):
    R, t = look_at(np.array([0.0, 0.0, -4.0]), np.zeros(3))
    return (JCamera.from_colmap(R, t, focal, focal, width, height),
            Camera.from_colmap(R, t, focal, focal, width, height, device=CPU))


def projections(s, width=48, height=32):
    jc, tc = cameras(width, height)
    pj = j_project(jnp.asarray(s["means"]), j_cov(jnp.asarray(s["scales"]), jnp.asarray(s["quats"])),
                   jc.viewmat, jc.fx, jc.fy, jc.cx, jc.cy, width, height)
    pt = t_project(torch.as_tensor(s["means"]), t_cov(torch.as_tensor(s["scales"]),
                                                      torch.as_tensor(s["quats"])),
                   tc.viewmat, tc.fx, tc.fy, tc.cx, tc.cy, width, height)
    return pj, pt


def test_projection_matches_jax():
    pj, pt = projections(scene(200, seed=1, spread=1.5))
    for f in ("means2d", "conics", "depths", "cov2d"):
        np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(pt.radii.numpy(), np.asarray(pj.radii))


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("cull", [True, False])
def test_bin_pairs_pair_for_pair(tile_size, cull):
    s = scene(120, seed=2)
    pj, pt = projections(s)
    jcfg = JTileConfig(max_per_tile=16, max_pairs=4096, tile_size=tile_size)
    tcfg = TileConfig(max_per_tile=16, max_pairs=4096, tile_size=tile_size)
    ops = s["ops"] if cull else None
    bj = j_bin_pairs(pj, 48, 32, jcfg, opacities=None if ops is None else jnp.asarray(ops))
    bt = bin_pairs(pt, 48, 32, tcfg, opacities=None if ops is None else torch.as_tensor(ops))
    for name, a, b in zip(("order", "g_sorted", "tile_sorted", "starts", "tile_cnt", "dropped"),
                          bj[:6], bt[:6]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert bt[6] == bj[6]
    # max_per_tile=16 clamps the deepest tiles: the drop count is exercised
    assert int(bt[5]) > 0


def test_oracle_matches_jax():
    s = scene(60, seed=3)
    jc, tc = cameras()
    bg = np.array([0.2, 0.1, 0.4], np.float32)

    def jloss(m, c, o, sc, q):
        r = j_render(jc, m, j_cov(sc, q), o, jnp.asarray(bg), colors_precomp=c, backend="oracle")
        return jnp.mean(r.image ** 2) + 0.3 * jnp.mean(r.alpha) + 0.1 * jnp.mean(r.depth), r

    args = [s[k] for k in ("means", "colors", "ops", "scales", "quats")]
    (lj, rj), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*args)
    ta = [torch.tensor(a, requires_grad=True) for a in args]
    rt = t_render(tc, ta[0], t_cov(ta[3], ta[4]), ta[2], torch.as_tensor(bg),
                  colors_precomp=ta[1], backend="oracle")
    lt = torch.mean(rt.image ** 2) + 0.3 * torch.mean(rt.alpha) + 0.1 * torch.mean(rt.depth)
    for f in ("image", "alpha", "depth"):
        np.testing.assert_allclose(getattr(rt, f).detach().numpy(), np.asarray(getattr(rj, f)),
                                   atol=1e-6, err_msg=f)
    for a, b in zip(gj, torch.autograd.grad(lt, ta)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=1e-4)


def _layout(d=3, tile_size=16, n=60, seed=4, cfg=None):
    s = scene(n, seed=seed)
    _, pt = projections(s)
    cols = torch.as_tensor(s["colors"][:, :d])
    cfg = cfg or TileConfig(max_per_tile=256, max_pairs=8192, tile_size=tile_size)
    return tilegrid_layout(pt, cols, torch.as_tensor(s["ops"]), 48, 32, cfg)


@pytest.mark.parametrize("d", [3, 1])
@pytest.mark.parametrize("tile_size", [16, 32])
def test_bwd_twin_matches_autograd_of_fwd_twin(d, tile_size):
    """The forward-sweep, rebuilt-total backward twin equals autograd
    through the forward twin (float32 reassociation: atol 1e-6, rtol 1e-4)."""
    lay = _layout(d, tile_size)
    bg = torch.rand((1, d), generator=torch.Generator().manual_seed(0))
    vals = lay.vals.detach().clone().requires_grad_(True)
    outs = cr.composite_tilegrid_plain_fwd(lay.meta, vals, bg, tile_size, lay.n_tx)
    gen = torch.Generator().manual_seed(1)
    cots = [torch.randn(o.shape, generator=gen) for o in outs]
    (auto,) = torch.autograd.grad(outs, vals, cots)
    twin = cr.composite_tilegrid_plain_bwd(lay.meta, lay.vals.detach(), bg,
                                           *[o.detach() for o in outs], *cots,
                                           tile_size, lay.n_tx)
    np.testing.assert_allclose(twin.numpy(), auto.numpy(), atol=1e-6, rtol=1e-4)
    assert np.abs(auto.numpy()).max() > 1e-3  # the check is not vacuous


def test_capacity_overflow_masked_and_counted():
    """Slot capacity of ONE chunk: every tile past the first overflows, is
    rendered as background with zero alpha, and its pairs are counted."""
    s = scene(60, seed=21)
    _, tc = cameras()
    bg = torch.tensor([0.25, 0.5, 0.75])
    cfg = TileConfig(max_per_tile=128, max_pairs=128, tile_size=16)
    res = t_render(tc, torch.as_tensor(s["means"]),
                   t_cov(torch.as_tensor(s["scales"]), torch.as_tensor(s["quats"])),
                   torch.as_tensor(s["ops"]), bg, colors_precomp=torch.as_tensor(s["colors"]),
                   backend="cuda", tile_config=cfg)
    assert torch.isfinite(res.image).all()
    assert int(res.dropped_pairs) > 0
    assert (res.alpha == 0).any()
    # an overflowed tile is exact background
    lay = _layout(3, 16, seed=21, cfg=cfg)
    over = (lay.meta[1] == 0).nonzero().flatten()
    t = int(over[-1])
    ty, tx = divmod(t, lay.n_tx)
    tile = res.image[:, ty * 16:(ty + 1) * 16, tx * 16:(tx + 1) * 16]
    assert torch.equal(tile, bg[:, None, None].expand_as(tile))


def test_saturation_skip_zeroes_tail_gradients():
    """A 140-deep stack of broad alpha~0.2 splats: chunk 2 sits behind
    T < 1e-7, so the tile-wide skip leaves its gradients exactly zero while
    the front layer matches the oracle (the JAX suite's
    TestSaturationEarlySkip, on the port)."""
    n = 140
    z = np.linspace(0.0, 2.0, n).astype(np.float32)
    means = torch.as_tensor(np.stack([np.zeros(n), np.zeros(n), z], 1).astype(np.float32))
    quats = torch.zeros(n, 4)
    quats[:, 0] = 1.0
    cov3d = t_cov(torch.full((n, 3), 2.0), quats)
    colors = torch.rand((n, 3), generator=torch.Generator().manual_seed(31), requires_grad=True)
    ops = torch.full((n,), 0.2)
    bg = torch.tensor([0.3, 0.2, 0.1])
    _, tc = cameras(32, 32)
    cfg = TileConfig(max_per_tile=256, max_pairs=8192, tile_size=16)

    def loss(backend):
        r = t_render(tc, means, cov3d, ops, bg, colors_precomp=colors,
                     backend=backend, tile_config=cfg if backend == "cuda" else None)
        return torch.mean((r.image - 0.5) ** 2) + 0.1 * torch.mean(r.depth), r

    lo, ro = loss("oracle")
    lc, rc = loss("cuda")
    assert int(rc.dropped_pairs) == 0
    np.testing.assert_allclose(rc.image.detach().numpy(), ro.image.detach().numpy(), atol=3e-4)
    (go,) = torch.autograd.grad(lo, colors)
    (gc,) = torch.autograd.grad(lc, colors)
    np.testing.assert_allclose(gc[:64].numpy(), go[:64].numpy(), atol=2e-5, rtol=1e-3)
    assert (gc[130:] == 0).all(), "tail gradients nonzero: the skip never ran"
    assert go[130:].abs().max() < 1e-8


def test_cpu_tensors_do_not_count_launches():
    cr.TileGridCompositor.reset_launch_counts()
    lay = _layout(3, 16)
    vals = lay.vals.detach().clone().requires_grad_(True)
    bg = torch.zeros(1, 3)
    img, alpha, depth = cr.TileGridCompositor.apply(lay.meta, vals, bg, 16, lay.n_tx)
    (img.sum() + alpha.sum() + depth.sum()).backward()
    assert vals.grad is not None and vals.grad.abs().max() > 0
    assert cr.TileGridCompositor.fwd_launches == {1: 0, 3: 0}
    assert cr.TileGridCompositor.bwd_launches == {1: 0, 3: 0}


@pytest.mark.parametrize("bad", ["meta_dtype", "vals_rows", "bg_dtype", "noncontig",
                                 "tile_size", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    lay = _layout(3, 16)
    meta, vals, bg, ts = lay.meta, lay.vals.detach(), torch.zeros(1, 3), 16
    if bad == "meta_dtype":
        meta = meta.to(torch.int64)
    elif bad == "vals_rows":
        vals = vals[:, :8].contiguous()
    elif bad == "bg_dtype":
        bg = bg.double()
    elif bad == "noncontig":
        vals = vals.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "tile_size":
        ts = 8
    elif bad == "device":  # neither CPU nor CUDA: no twin, no kernel
        meta, vals, bg = meta.to("meta"), vals.to("meta"), bg.to("meta")
    with pytest.raises(ValueError):
        cr.tilegrid_forward(meta, vals, bg, ts, lay.n_tx)
