"""The port's stream compositor and exact-total tile-grid backward (layouts
and plain twins on the CPU) against the JAX package's Pallas kernels in
interpret mode and the port's oracle, through the public render API.

  * the stream layout is the JAX layout int for int (meta [4, n_slots]);
    its gathered pair rows hold the same projected values;
  * stream forward and gradients at the JAX suite's 48x32 / 60-Gaussian
    scene, D = 3 and 1, tile sizes 16 and 32, and a slot capacity that
    overflows inside a tile's run;
  * the exact-total backward on the 64x48 / 300-Gaussian scene, and that
    it reads none of the saved outputs the default flavor rebuilds from;
  * crop-window heights that leave the bottom tile row partial, for both
    compositors;
  * render/probe_layouts.py:stream_probe (empty tiles between runs, a run
    of exactly two chunks, a one-pair tile, the pure-padding tail, a run cut
    at the slot capacity, opaque rows past each count) through the twins
    against the JAX stream kernel in interpret mode;
  * the stream pair with a scene axis (two scenes in one layout) against
    JAX's composite_pallas vmapped over the scenes.

Tolerances: against the oracle, the JAX suite's cross-backend bounds
(tests/test_pallas_raster.py:34-36, :77-79: forward 3e-4 / 3e-3 depth,
gradients atol 2e-4 + rtol 1e-3; exact-total gradients atol 5e-6,
:301-347). Against the JAX kernels, float32 reassociation only: the JAX
stream kernel forms its log-space prefix and suffix sums by lane
doubling and the twins by cumsum, so forward values agree to 2e-6 (depth
2e-5 at z ~ 4) and gradients to atol 1e-6 + rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egogaussian_tpu.render.pallas_raster as j_pallas
from egogaussian_tpu.ops import covariance_from_scaling_rotation as j_cov
from egogaussian_tpu.render.api import render as j_render
from egogaussian_tpu.render.camera import Camera as JCamera
from egogaussian_tpu.render.tiled import TileConfig as JTileConfig
from egogaussian_tpu_torch.ops.covariance import covariance_from_scaling_rotation as t_cov
from egogaussian_tpu_torch.render import cuda_raster as cr
from egogaussian_tpu_torch.render import stream_raster as sr
from egogaussian_tpu_torch.render.api import render as t_render
from egogaussian_tpu_torch.render.camera import Camera, look_at
from egogaussian_tpu_torch.render.probe_layouts import stream_probe
from egogaussian_tpu_torch.render.project import project_gaussians as t_project
from egogaussian_tpu_torch.render.tiled import TileConfig, stream_layout, tilegrid_layout

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _scene(seed, n=60, log_scale=-2.5):
    rng = np.random.RandomState(seed)
    return [
        rng.randn(n, 3).astype(np.float32),                            # means
        rng.rand(n, 3).astype(np.float32),                             # colors
        rng.uniform(0.3, 0.95, n).astype(np.float32),                  # opacities
        np.exp(rng.randn(n, 3) * 0.3 + log_scale).astype(np.float32),  # scales
        rng.randn(n, 4).astype(np.float32),                            # quats
    ]


def _cams(width, height):
    R, t = look_at(np.array([0.0, 0.0, -4.0]), np.zeros(3))
    return (JCamera.from_colmap(R, t, 60.0, 60.0, width, height),
            Camera.from_colmap(R, t, 60.0, 60.0, width, height, device=CPU))


def _loss_terms(res, target, w_alpha, w_depth, xp):
    return (xp.mean((res.image - target) ** 2) + w_alpha * xp.mean(res.alpha)
            + w_depth * xp.mean(res.depth))


def _jax_run(args, bg, target, width, height, backend, cfg, weights=(0.3, 0.1)):
    jc, _ = _cams(width, height)

    def loss(m, c, o, s, q):
        r = j_render(jc, m, j_cov(s, q), o, jnp.asarray(bg), colors_precomp=c,
                     backend=backend, tile_config=cfg)
        return _loss_terms(r, target, *weights, jnp), r

    (_, r), g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*args)
    return r, g


def _port_run(args, bg, target, width, height, backend, cfg, weights=(0.3, 0.1)):
    _, tc = _cams(width, height)
    ta = [torch.tensor(a, requires_grad=True) for a in args]
    r = t_render(tc, ta[0], t_cov(ta[3], ta[4]), ta[2], torch.as_tensor(bg),
                 colors_precomp=ta[1], backend=backend, tile_config=cfg)
    loss = _loss_terms(r, torch.as_tensor(target), *weights, torch)
    return r, torch.autograd.grad(loss, ta)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_fwd(rt, ref, tol):
    for f, atol in zip(("image", "alpha", "depth"), tol):
        np.testing.assert_allclose(_np(getattr(rt, f)), _np(getattr(ref, f)),
                                   atol=atol, rtol=0, err_msg=f)


def _assert_grads(gt, gref, atol, rtol):
    for name, a, b in zip(("means", "colors", "opacities", "scales", "quats"), gref, gt):
        np.testing.assert_allclose(_np(b), _np(a), atol=atol, rtol=rtol,
                                   err_msg=f"grad {name}")


@pytest.mark.parametrize("tile_size", [16, 32])
def test_stream_layout_matches_jax(monkeypatch, tile_size):
    """meta equal int for int; the pair rows hold the same projected
    values (the two packages project in float32 in the same order)."""
    args = _scene(seed=40 + tile_size)
    w, h = 48, 32
    captured = {}
    orig = j_pallas.make_stream_compositor

    def spy(*a, **k):
        comp = orig(*a, **k)

        def run(meta, vals, bg):
            captured["meta"], captured["vals"] = np.asarray(meta), np.asarray(vals)
            return comp(meta, vals, bg)
        return run

    monkeypatch.setattr(j_pallas, "make_stream_compositor", spy)
    kw = dict(max_per_tile=256, max_pairs=8192, tile_size=tile_size, compositor="stream")
    jc, tc = _cams(w, h)
    j_render(jc, jnp.asarray(args[0]), j_cov(jnp.asarray(args[3]), jnp.asarray(args[4])),
             jnp.asarray(args[2]), jnp.zeros(3), colors_precomp=jnp.asarray(args[1]),
             backend="pallas", tile_config=JTileConfig(**kw))
    proj = t_project(torch.as_tensor(args[0]), t_cov(torch.as_tensor(args[3]),
                                                    torch.as_tensor(args[4])),
                     tc.viewmat, tc.fx, tc.fy, tc.cx, tc.cy, w, h)
    lay = stream_layout(proj, torch.as_tensor(args[1]), torch.as_tensor(args[2]), w, h,
                        TileConfig(**kw))
    meta = lay.meta.numpy()
    assert meta.shape == captured["meta"].shape and meta.shape[0] == 4
    np.testing.assert_array_equal(meta, captured["meta"])
    assert (meta[1] < meta[2]).any() and (meta[1] >= meta[2]).any()  # real and padding slots
    np.testing.assert_allclose(lay.vals.detach().numpy(), captured["vals"], atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("d", [3, 1])
def test_stream_matches_jax_and_oracle(d, tile_size):
    args = _scene(seed=50 + d + tile_size)
    args[1] = args[1][:, :d]
    bg = np.array([0.2, 0.1, 0.4], np.float32)[:d]
    w, h = 48, 32
    target = np.random.RandomState(6).rand(d, h, w).astype(np.float32)
    kw = dict(max_per_tile=256, max_pairs=8192, tile_size=tile_size, compositor="stream")
    rj, gj = _jax_run([jnp.asarray(a) for a in args], bg, target, w, h, "pallas",
                      JTileConfig(**kw))
    ro, go = _port_run(args, bg, target, w, h, "oracle", None)
    rt, gt = _port_run(args, bg, target, w, h, "cuda", TileConfig(**kw))
    assert int(rt.dropped_pairs) == int(rj.dropped_pairs) == 0
    _assert_fwd(rt, rj, (2e-6, 2e-6, 2e-5))
    _assert_grads(gt, gj, 1e-6, 1e-4)
    _assert_fwd(rt, ro, (3e-4, 3e-4, 3e-3))
    _assert_grads(gt, go, 2e-4, 1e-3)


def test_stream_capacity_overflow_matches_jax():
    """A slot capacity that ends inside a tile's run: that tile's slots are
    composited but masked, later tiles own no slot; the same pairs are
    counted as dropped and the image and gradients match JAX."""
    args = _scene(seed=61, n=600, log_scale=-2.0)
    bg = np.array([0.25, 0.5, 0.75], np.float32)
    w, h = 48, 32
    target = np.random.RandomState(7).rand(3, h, w).astype(np.float32)
    kw = dict(max_per_tile=512, max_pairs=8192, max_slots=640, tile_size=16,
              compositor="stream")
    rj, gj = _jax_run([jnp.asarray(a) for a in args], bg, target, w, h, "pallas",
                      JTileConfig(**kw))
    rt, gt = _port_run(args, bg, target, w, h, "cuda", TileConfig(**kw))
    assert int(rt.dropped_pairs) == int(rj.dropped_pairs) > 0
    _assert_fwd(rt, rj, (2e-6, 2e-6, 2e-5))
    _assert_grads(gt, gj, 1e-6, 1e-4)


@pytest.mark.parametrize("d,ts,cut", [(3, 32, False), (1, 32, True), (3, 16, True),
                                      (1, 16, False)])
def test_stream_probe_twins_match_jax_kernel(d, ts, cut):
    """render/probe_layouts.py:stream_probe through the port's twins against
    the JAX stream kernel in interpret mode: the forward on the tiles whose
    run holds a real chunk (the kernels leave tiles that own no slot
    unwritten, and the caller masks the empty ones), the gradients through
    the VJP on every slot (zeros at the padding). Tolerances as
    test_stream_matches_jax_and_oracle's."""
    meta, vals, bg, n_tx, _, _ = stream_probe(d, ts, cut)
    n_tiles, p = n_tx, ts * ts
    rng = np.random.RandomState(9)
    cots = [(rng.randn(n_tiles, p, c) * 1e-2).astype(np.float32) for c in (d, 1, 1)]
    comp = j_pallas.make_stream_compositor(meta.shape[1], n_tiles, d, ts, n_tx, interpret=True)
    j_out, vjp = jax.vjp(lambda v: comp(jnp.asarray(meta), v, jnp.asarray(bg)),
                         jnp.asarray(vals))
    (j_d,) = vjp(tuple(jnp.asarray(c) for c in cots))
    t_meta, t_vals, t_bg = (torch.as_tensor(x) for x in (meta, vals, bg))
    t_out = sr.stream_forward(t_meta, t_vals, t_bg, ts, n_tx, n_tiles)
    t_d = sr.stream_backward(t_meta, t_vals, t_bg, t_out[3], *(torch.as_tensor(c) for c in cots),
                             ts, n_tx)
    real = sorted({int(t) for t, r, c in meta[:3].T if r < c})
    assert real == [0, 2, 4]
    for name, a, b, atol in zip(("image", "alpha", "depth"), j_out, t_out, (2e-6, 2e-6, 2e-5)):
        np.testing.assert_allclose(b.numpy()[real], np.asarray(a)[real], atol=atol, rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), atol=1e-6, rtol=1e-4)
    assert float(t_out[1][4].max()) > 0.5  # the deep tile is composited
    pad = np.repeat(meta[1] >= meta[2], 128)
    assert not t_d.numpy()[pad].any() and np.abs(t_d.numpy()[~pad]).max() > 1e-4


def test_exact_total_matches_jax_and_oracle():
    """The two-sweep backward (TileConfig.bwd_exact_total) on the JAX
    suite's 64x48 / 300-Gaussian scene: within 5e-6 of the oracle and of
    the JAX exact-total kernel, and equal to the default backward's
    gradients to float32 rounding."""
    rng = np.random.RandomState(70)
    n, w, h = 300, 64, 48
    args = [
        rng.randn(n, 3).astype(np.float32),
        rng.rand(n, 3).astype(np.float32),
        rng.uniform(0.3, 0.99, n).astype(np.float32),
        np.exp(rng.randn(n, 3) * 0.3 - 1.6).astype(np.float32),
        rng.randn(n, 4).astype(np.float32),
    ]
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    target = rng.rand(3, h, w).astype(np.float32)
    weights = (0.1, 0.01)
    kw = dict(max_pairs=16384, max_per_tile=1024, max_slots=16384)
    _, gj = _jax_run([jnp.asarray(a) for a in args], bg, target, w, h, "pallas",
                     JTileConfig(bwd_exact_total=True, **kw), weights)
    _, go = _port_run(args, bg, target, w, h, "oracle", None, weights)
    _, gd = _port_run(args, bg, target, w, h, "cuda", TileConfig(**kw), weights)
    _, ge = _port_run(args, bg, target, w, h, "cuda",
                      TileConfig(bwd_exact_total=True, **kw), weights)
    _assert_grads(ge, go, 5e-6, 0)
    _assert_grads(ge, gj, 5e-6, 0)
    _assert_grads(ge, gd, 1e-6, 1e-4)


def test_exact_total_twin_reads_no_saved_outputs():
    """The exact-total backward takes its totals from its own pre-sweep:
    with the saved image, alpha and depth zeroed its gradient is
    bit-identical, while the default flavor's moves."""
    args = _scene(seed=71, n=200, log_scale=-1.6)
    _, tc = _cams(48, 32)
    proj = t_project(torch.as_tensor(args[0]), t_cov(torch.as_tensor(args[3]),
                                                    torch.as_tensor(args[4])),
                     tc.viewmat, tc.fx, tc.fy, tc.cx, tc.cy, 48, 32)
    lay = tilegrid_layout(proj, torch.as_tensor(args[1]), torch.as_tensor(args[2]), 48, 32,
                          TileConfig(max_per_tile=1024, max_pairs=16384))
    meta, vals = lay.meta, lay.vals.detach()
    bg = torch.tensor([[0.2, 0.1, 0.3]])
    out = cr.tilegrid_forward(meta, vals, bg, 16, lay.n_tx)
    gen = torch.Generator().manual_seed(3)
    cots = [torch.randn(o.shape, generator=gen) * 1e-2 for o in out]
    zeros = [torch.zeros_like(o) for o in out]
    fit = int(meta[2, 0])

    def bwd(saved, exact):
        return cr.tilegrid_backward(meta, vals, bg, *saved, *cots, 16, lay.n_tx,
                                    exact_total=exact)[:fit]

    assert fit > 0
    assert torch.equal(bwd(out, True), bwd(zeros, True))
    assert not torch.equal(bwd(out, False), bwd(zeros, False))


@pytest.mark.parametrize("compositor", ["tilegrid", "stream"])
def test_partial_tile_crop_heights(compositor):
    """Crop windows are 128 wide and 8-row multiples high, so at tile size
    32 the bottom tile row is partial (here 40 = 32 + 8 rows): the port's
    cropped render and gradients match the JAX package's."""
    args = _scene(seed=80, n=80)
    bg = np.zeros(3, np.float32)
    w, h, cw, ch = 160, 96, 128, 40
    target = np.random.RandomState(8).rand(3, ch, cw).astype(np.float32)
    kw = dict(max_per_tile=256, max_pairs=8192, tile_size=32, compositor=compositor)
    jc, tc = _cams(w, h)

    def jloss(m, c, o, s, q):
        r = j_render(jc, m, j_cov(s, q), o, jnp.asarray(bg), colors_precomp=c,
                     backend="pallas", tile_config=JTileConfig(**kw), crop_size=(cw, ch))
        return _loss_terms(r, target, 0.3, 0.1, jnp), r

    (_, rj), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *[jnp.asarray(a) for a in args])
    ta = [torch.tensor(a, requires_grad=True) for a in args]
    rt = t_render(tc, ta[0], t_cov(ta[3], ta[4]), ta[2], torch.as_tensor(bg),
                  colors_precomp=ta[1], backend="cuda", tile_config=TileConfig(**kw),
                  crop_size=(cw, ch))
    gt = torch.autograd.grad(_loss_terms(rt, torch.as_tensor(target), 0.3, 0.1, torch), ta)
    assert rt.image.shape == (3, ch, cw)
    np.testing.assert_array_equal(rt.crop_offset.numpy(), np.asarray(rj.crop_offset))
    np.testing.assert_array_equal(rt.crop_outside.numpy(), np.asarray(rj.crop_outside))
    assert float(rt.alpha.detach().max()) > 0.1  # the window holds part of the scene
    _assert_fwd(rt, rj, (2e-6, 2e-6, 2e-5))
    _assert_grads(gt, gj, 1e-6, 1e-4)


def test_stream_wrapper_dispatch_and_checks():
    """CPU tensors take the twins and count no launch; malformed inputs
    raise."""
    args = _scene(seed=90)
    _, tc = _cams(48, 32)
    proj = t_project(torch.as_tensor(args[0]), t_cov(torch.as_tensor(args[3]),
                                                    torch.as_tensor(args[4])),
                     tc.viewmat, tc.fx, tc.fy, tc.cx, tc.cy, 48, 32)
    lay = stream_layout(proj, torch.as_tensor(args[1]), torch.as_tensor(args[2]), 48, 32,
                        TileConfig(max_per_tile=256, max_pairs=8192, compositor="stream"))
    bg = torch.zeros((1, 3))
    n_tiles = lay.n_tx * lay.n_ty
    sr.StreamCompositor.reset_launch_counts()
    out = sr.stream_forward(lay.meta, lay.vals.detach(), bg, 16, lay.n_tx, n_tiles)
    assert [tuple(o.shape) for o in out] == [(n_tiles, 256, 3), (n_tiles, 256, 1),
                                             (n_tiles, 256, 1), (n_tiles, 1, 256)]
    assert sr.StreamCompositor.fwd_launches == {1: 0, 3: 0}
    with pytest.raises(ValueError):
        sr.stream_forward(lay.meta[:3].contiguous(), lay.vals.detach(), bg, 16, lay.n_tx,
                          n_tiles)
    with pytest.raises(ValueError):
        sr.stream_forward(lay.meta, lay.vals.detach()[:, :8].contiguous(), bg, 16, lay.n_tx,
                          n_tiles)
    with pytest.raises(ValueError):
        TileConfig(compositor="scatter")
    # every slot of the backward is written: padding slots come back zero
    cots = [torch.ones_like(o) for o in out[:3]]
    dv = sr.stream_backward(lay.meta, lay.vals.detach(), bg, out[3], *cots, 16, lay.n_tx)
    pad = (lay.meta[1] >= lay.meta[2]).repeat_interleave(128)
    assert dv.shape == lay.vals.shape
    assert not dv[pad].any() and dv[~pad].abs().sum() > 0


def test_stream_scene_axis_matches_jax_vmapped_composite():
    """The stream pair with a scene axis (render/tiled.py composite_scenes,
    compositor="stream", the twins) against JAX's own lockstep form of it:
    composite_pallas with compositor="stream" vmapped over two scenes
    (interpret mode), the scenes' splats drawn from one numpy seed, one
    shared TileConfig (vmap shares it), two backgrounds. Forward and the
    gradients of every splat field within test_stream_matches_jax_and_
    oracle's bounds (float32 reassociation only: JAX's log-space prefix
    and suffix sums by lane doubling, the twins' by cumsum)."""
    from egogaussian_tpu.render.project import ProjectedGaussians as JProj
    from egogaussian_tpu.render.tiled import composite_pallas
    from egogaussian_tpu_torch.render.project import ProjectedGaussians
    from egogaussian_tpu_torch.render.tiled import composite_scenes, scene_caps

    w, h, n = 48, 32, 80
    rng = np.random.RandomState(71)
    mu = (rng.rand(2, n, 2) * np.array([w, h])).astype(np.float32)
    con = np.stack([rng.rand(2, n) * 0.3 + 0.05, (rng.rand(2, n) - 0.5) * 0.02,
                    rng.rand(2, n) * 0.3 + 0.05], -1).astype(np.float32)
    depth = (rng.rand(2, n) * 5 + 1).astype(np.float32)
    radii = (rng.rand(2, n) * 8 + 1).astype(np.int32)
    cols = rng.rand(2, n, 3).astype(np.float32)
    ops = (rng.rand(2, n) * 0.9).astype(np.float32)
    bg = np.array([[0.2, 0.1, 0.4], [0.6, 0.3, 0.0]], np.float32)
    target = rng.rand(2, 3, h, w).astype(np.float32)
    kw = dict(max_per_tile=256, max_pairs=4096, tile_size=16, compositor="stream")

    def j_loss(m, c, cl, o):
        out = jax.vmap(lambda m1, c1, d1, r1, cl1, o1, b1: composite_pallas(
            JProj(m1, c1, d1, r1, c1), cl1, o1, b1, w, h, JTileConfig(**kw),
            interpret=True))(m, c, jnp.asarray(depth), jnp.asarray(radii), cl, o,
                             jnp.asarray(bg))
        return _loss_terms(out, target, 0.3, 0.1, jnp), out

    (_, rj), gj = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(x) for x in (mu, con, cols, ops)))
    ta = [torch.tensor(x, requires_grad=True) for x in (mu, con, cols, ops)]
    proj = ProjectedGaussians(ta[0], ta[1], torch.as_tensor(depth), torch.as_tensor(radii),
                              ta[1])
    cfg = TileConfig(**kw)
    rt = composite_scenes(proj, ta[2], ta[3], torch.as_tensor(bg),
                          scene_caps([cfg, cfg], [(w, h)] * 2, CPU, n), "cuda")
    gt = torch.autograd.grad(_loss_terms(rt, torch.as_tensor(target), 0.3, 0.1, torch), ta)
    assert [int(x) for x in rt.dropped_pairs] == [int(x) for x in rj.dropped_pairs] == [0, 0]
    alpha = rt.alpha.detach()
    assert float(alpha.min()) < 0.5 < float(alpha.max())  # background shows through
    _assert_fwd(rt, rj, (2e-6, 2e-6, 2e-5))
    for name, a, b in zip(("means2d", "conics", "colors", "opacities"), gj, gt):
        np.testing.assert_allclose(_np(b), _np(a), atol=1e-6, rtol=1e-4, err_msg=f"grad {name}")
