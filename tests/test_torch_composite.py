"""The port's tile-grid composite (layout + plain twins on the CPU) against
the JAX `tilegrid` Pallas kernels in interpret mode, through the public
render API of each package: forward outputs and gradients of a loss that
touches image, alpha and depth, at D = 3 (RGB) and D = 1 (label), tile
sizes 16 and 32; and the capacity-overflow case.

Tolerance: the port's twins walk transmittance with a sequential cumprod
where the TPU kernel uses a lane-doubling product and MXU accumulation,
so the two differ by float32 reassociation only: forward atol 1e-6 (values
in [0, 1]; depth 1e-5 at z ~ 4), gradients atol 1e-7 + rtol 1e-4 (values
~1e-2). The JAX suite's own cross-backend bounds (3e-4 fwd, 2e-4 grads)
are two orders looser.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egogaussian_tpu.ops import covariance_from_scaling_rotation as j_cov
from egogaussian_tpu.render.api import render as j_render
from egogaussian_tpu.render.api import render_label as j_render_label
from egogaussian_tpu.render.camera import Camera as JCamera
from egogaussian_tpu.render.tiled import TileConfig as JTileConfig
from egogaussian_tpu_torch.ops.covariance import covariance_from_scaling_rotation as t_cov
from egogaussian_tpu_torch.render.api import render as t_render
from egogaussian_tpu_torch.render.api import render_label as t_render_label
from egogaussian_tpu_torch.render.camera import Camera, look_at
from egogaussian_tpu_torch.render.tiled import TileConfig

torch.set_num_threads(1)
W, H = 48, 32


def _scene(seed, n=60):
    rng = np.random.RandomState(seed)
    return [
        rng.randn(n, 3).astype(np.float32),                       # means
        rng.rand(n, 3).astype(np.float32),                        # colors
        rng.uniform(0.3, 0.95, n).astype(np.float32),             # opacities
        np.exp(rng.randn(n, 3) * 0.3 - 2.5).astype(np.float32),   # scales
        rng.randn(n, 4).astype(np.float32),                       # quats
    ]


def _cams():
    R, t = look_at(np.array([0.0, 0.0, -4.0]), np.zeros(3))
    return (JCamera.from_colmap(R, t, 60.0, 60.0, W, H),
            Camera.from_colmap(R, t, 60.0, 60.0, W, H, device=torch.device("cpu")))


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("d", [3, 1])
def test_composite_matches_jax_tilegrid(d, tile_size):
    args = _scene(seed=10 + d + tile_size)
    args[1] = args[1][:, :d]
    bg = np.array([0.2, 0.1, 0.4], np.float32)[:d]
    target = np.random.RandomState(5).rand(d, H, W).astype(np.float32)
    jc, tc = _cams()
    jcfg = JTileConfig(max_per_tile=256, max_pairs=8192, tile_size=tile_size)
    tcfg = TileConfig(max_per_tile=256, max_pairs=8192, tile_size=tile_size)

    def jloss(m, c, o, s, q):
        r = j_render(jc, m, j_cov(s, q), o, jnp.asarray(bg), colors_precomp=c,
                     backend="pallas", tile_config=jcfg)
        loss = (jnp.mean((r.image - target) ** 2) + 0.3 * jnp.mean(r.alpha)
                + 0.1 * jnp.mean(r.depth))
        return loss, r

    (_, rj), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*args)
    ta = [torch.tensor(a, requires_grad=True) for a in args]
    rt = t_render(tc, ta[0], t_cov(ta[3], ta[4]), ta[2], torch.as_tensor(bg),
                  colors_precomp=ta[1], backend="cuda", tile_config=tcfg)
    lt = (torch.mean((rt.image - torch.as_tensor(target)) ** 2) + 0.3 * torch.mean(rt.alpha)
          + 0.1 * torch.mean(rt.depth))
    assert int(rt.dropped_pairs) == int(rj.dropped_pairs) == 0
    for f, atol in (("image", 1e-6), ("alpha", 1e-6), ("depth", 1e-5)):
        np.testing.assert_allclose(getattr(rt, f).detach().numpy(), np.asarray(getattr(rj, f)),
                                   atol=atol, err_msg=f)
    for name, a, b in zip(("means", "colors", "opacities", "scales", "quats"), gj,
                          torch.autograd.grad(lt, ta)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-7, rtol=1e-4,
                                   err_msg=f"grad {name}")


def test_capacity_overflow_matches_jax():
    """One-chunk slot capacity: the same tiles overflow in both packages,
    the same pairs are counted, and the image is the same."""
    args = _scene(seed=21)
    bg = np.array([0.25, 0.5, 0.75], np.float32)
    jc, tc = _cams()
    rj = j_render(jc, jnp.asarray(args[0]), j_cov(jnp.asarray(args[3]), jnp.asarray(args[4])),
                  jnp.asarray(args[2]), jnp.asarray(bg), colors_precomp=jnp.asarray(args[1]),
                  backend="pallas",
                  tile_config=JTileConfig(max_per_tile=128, max_pairs=128, tile_size=16))
    rt = t_render(tc, torch.as_tensor(args[0]),
                  t_cov(torch.as_tensor(args[3]), torch.as_tensor(args[4])),
                  torch.as_tensor(args[2]), torch.as_tensor(bg),
                  colors_precomp=torch.as_tensor(args[1]), backend="cuda",
                  tile_config=TileConfig(max_per_tile=128, max_pairs=128, tile_size=16))
    assert int(rt.dropped_pairs) == int(rj.dropped_pairs) > 0
    np.testing.assert_allclose(rt.image.numpy(), np.asarray(rj.image), atol=1e-6)
    np.testing.assert_array_equal(rt.alpha.numpy() == 0, np.asarray(rj.alpha) == 0)


def test_render_label_matches_jax():
    """The label render (D = 1 through the tile-grid layout and twins) and
    its gradient, which reaches the labels and not the detached geometry,
    against the JAX package's render_label."""
    means, _, ops, scales, quats = _scene(seed=31)
    labels = np.random.RandomState(32).randn(len(means)).astype(np.float32)
    target = np.random.RandomState(33).rand(1, H, W).astype(np.float32)
    jc, tc = _cams()

    def jloss(lbl, m):
        img = j_render_label(jc, m, j_cov(jnp.asarray(scales), jnp.asarray(quats)),
                             jnp.asarray(ops), lbl, backend="pallas")
        return jnp.mean((img - target) ** 2), img

    (_, ij), (gl_j, gm_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        labels, means)
    tl = torch.tensor(labels, requires_grad=True)
    tm = torch.tensor(means, requires_grad=True)
    it = t_render_label(tc, tm, t_cov(torch.as_tensor(scales), torch.as_tensor(quats)),
                        torch.as_tensor(ops), tl, backend="cuda",
                        tile_config=TileConfig(max_per_tile=256, max_pairs=8192, tile_size=16))
    loss = torch.mean((it - torch.as_tensor(target)) ** 2)
    loss.backward()
    assert tm.grad is None and not np.asarray(gm_j).any()
    np.testing.assert_allclose(it.detach().numpy(), np.asarray(ij), atol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(gl_j), atol=1e-7, rtol=1e-4)
    assert np.abs(np.asarray(gl_j)).max() > 1e-4


@pytest.mark.parametrize("d", [3, 1])
def test_quadrant_scene_matches_jax_tilegrid(d):
    """render/probe_layouts.py:quadrant_scene, the layout that pins the
    tile-wide saturation vote, through the port's tile-grid twins and the
    JAX tile-grid kernel in interpret mode, both backward flavors: the
    same outputs, and the later chunks' gradient rows zero at the same
    places (tile 0's quadrant-only splats live, tile 1's skipped chunk all
    zeros), so the card checks that hold the kernels to the twins on this
    layout hold them to the TPU kernel's vote. Gradients reach 0.18 here
    (the steep splats), 18x the file's other scenes, so their atol is 2e-5
    of the largest one (float32 reassociation; 8e-6 measured)."""
    import egogaussian_tpu.render.pallas_raster as j_pallas
    from egogaussian_tpu_torch.render import cuda_raster as cr
    from egogaussian_tpu_torch.render.probe_layouts import quadrant_scene

    meta, vals, bg, n_tx, _, _ = quadrant_scene(d)
    tm, tv, tb = (torch.as_tensor(x) for x in (meta, vals, bg))
    out = cr.composite_tilegrid_plain_fwd(tm, tv, tb, 32, n_tx)
    rng = np.random.RandomState(3)
    cots = [(rng.randn(*o.shape) * 1e-3).astype(np.float32) for o in out]
    for exact in (False, True):
        comp = j_pallas.make_tilegrid_compositor(vals.shape[0], meta.shape[1], d, 32, n_tx,
                                                 interpret=True, exact_total=exact)
        jout, vjp = jax.vjp(lambda v: comp(jnp.asarray(meta), v, jnp.asarray(bg)),
                            jnp.asarray(vals))
        for a, b, atol in zip(out, jout, (1e-6, 1e-6, 1e-5)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)
        (gj,) = vjp(tuple(jnp.asarray(c) for c in cots))
        gj = np.asarray(gj)
        gt = cr.composite_tilegrid_plain_bwd(tm, tv, tb, *[o.detach() for o in out],
                                             *(torch.as_tensor(c) for c in cots), 32, n_tx,
                                             exact_total=exact).numpy()
        np.testing.assert_allclose(gt, gj, atol=2e-5 * np.abs(gj).max(), rtol=1e-4)
        np.testing.assert_array_equal(gt[[2, 4]] == 0, gj[[2, 4]] == 0)
        assert (gj[2, :7 + d, :20] != 0).any(axis=0).all()
        assert (gj[4] == 0).all()
