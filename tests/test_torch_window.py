"""The port's tiled backend (gather window + the windowed compositors'
plain twins on the CPU) against the JAX package: `bin_gaussians`, the
chunked and simple windowed Pallas kernels in interpret mode, JAX's XLA
`composite_tiled` through the public render API, and `backend="auto"`.

Tolerances:
  * bin_gaussians: exact, index for index, on one projection.
  * twins vs the JAX kernels (same algorithm; the kernels take their
    prefix sums as HIGHEST-precision triangular matmuls, the twins as
    cumsums): forward atol 1e-5; gradients within the JAX suite's
    cross-backend bounds atol 2e-4 + rtol 1e-3 (tests/test_pallas_raster.py).
  * composite_tiled vs JAX composite_tiled (same function, different
    algorithm: XLA log-space cumsum over the whole window and autodiff,
    against the chunked kernel's twins): forward atol 1e-5; gradients
    within the suite's cross-backend bounds. The kernels apply no clamp
    mask on `power`, where autodiff splits a tie 1/2 : 1/2; the bound
    covers that case, which these random scenes do not reach.
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
from egogaussian_tpu.render.project import project_gaussians as j_project
from egogaussian_tpu.render.tiled import TileConfig as JTileConfig
from egogaussian_tpu.render.tiled import bin_gaussians as j_bin_gaussians
from egogaussian_tpu_torch.ops.covariance import covariance_from_scaling_rotation as t_cov
from egogaussian_tpu_torch.render import window_raster as wr
from egogaussian_tpu_torch.render.api import render as t_render
from egogaussian_tpu_torch.render.camera import Camera, look_at
from egogaussian_tpu_torch.render.cuda_raster import ALPHA_EPS, _chunk_alphas, _pixel_coords
from egogaussian_tpu_torch.render.probe_layouts import (
    PROBE_GATE,
    SIMPLE_PROBE_CLAMP,
    SIMPLE_PROBE_ROWS,
    simple_window_probe,
    window_probe,
)
from egogaussian_tpu_torch.render.project import ProjectedGaussians
from egogaussian_tpu_torch.render.project import project_gaussians as t_project
from egogaussian_tpu_torch.render.tiled import TileConfig, bin_gaussians, window_layout

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 64, 48
FWD_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3


def _scene(seed, n=300):
    """The JAX suite's 64x48 / 300-Gaussian scene shape (tiles up to ~200
    pairs deep at ts 32, ~150 at ts 16)."""
    rng = np.random.RandomState(seed)
    return [
        rng.randn(n, 3).astype(np.float32),                          # means
        rng.rand(n, 3).astype(np.float32),                           # colors
        rng.uniform(0.3, 0.99, n).astype(np.float32),                # opacities
        np.exp(rng.randn(n, 3) * 0.3 - 1.6).astype(np.float32),      # scales
        rng.randn(n, 4).astype(np.float32),                          # quats
    ]


def _cams(width=W, height=H):
    R, t = look_at(np.array([0.0, 0.0, -4.0]), np.zeros(3))
    return (JCamera.from_colmap(R, t, 60.0, 60.0, width, height),
            Camera.from_colmap(R, t, 60.0, 60.0, width, height, device=CPU))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_proj(args, width=W, height=H):
    jc, _ = _cams(width, height)
    return j_project(jnp.asarray(args[0]), j_cov(jnp.asarray(args[3]), jnp.asarray(args[4])),
                     jc.viewmat, jc.fx, jc.fy, jc.cx, jc.cy, width, height)


def _port_proj(args, width=W, height=H):
    _, tc = _cams(width, height)
    return t_project(torch.as_tensor(args[0]),
                     t_cov(torch.as_tensor(args[3]), torch.as_tensor(args[4])),
                     tc.viewmat, tc.fx, tc.fy, tc.cx, tc.cy, width, height)


@pytest.mark.parametrize("tile_size,max_per_tile", [(16, 1024), (32, 100)])
def test_bin_gaussians_matches_jax(tile_size, max_per_tile):
    """order, tile_gather (with the clip at max_pairs - 1), tile_mask and
    dropped equal JAX's on the same projection; max_per_tile=100 clamps
    the deep tiles and counts the loss."""
    args = _scene(seed=3)
    jp = _jax_proj(args)
    proj = ProjectedGaussians(*(torch.as_tensor(np.array(x)) for x in jp))
    kw = dict(tile_size=tile_size, max_per_tile=max_per_tile, max_pairs=8192)
    jout = j_bin_gaussians(jp, W, H, JTileConfig(**kw), opacities=jnp.asarray(args[2]))
    tout = bin_gaussians(proj, W, H, TileConfig(**kw), opacities=torch.as_tensor(args[2]))
    for name, a, b in zip(("order", "tile_gather", "tile_mask", "dropped"), jout[:4], tout[:4]):
        np.testing.assert_array_equal(_np(b), np.asarray(a), err_msg=name)
    assert tout[4] == tuple(jout[4])
    assert (int(tout[3]) > 0) == (max_per_tile == 100)


def _window(args, d, ts, max_per_tile, empty_tile=False):
    """The port's window of one scene (colors cut to d channels), with
    tile 0 emptied (count 0) on request."""
    proj = _port_proj(args)
    cols = torch.as_tensor(args[1][:, :d])
    lay = window_layout(proj, cols, torch.as_tensor(args[2]), W, H,
                        TileConfig(tile_size=ts, max_per_tile=max_per_tile, max_pairs=8192))
    counts = lay.counts.clone()
    if empty_tile:
        counts[0] = 0
    return lay, counts, lay.data.detach().contiguous()


def _split(data, counts, d):
    rows = torch.arange(data.shape[1])
    live = (rows[None, :] < counts[:, None].long())[..., None]
    op = torch.where(live, data[..., 5:6], torch.zeros_like(data[..., 5:6]))
    return [x.contiguous() for x in (data[..., 0:2], data[..., 2:5], op, data[..., 6:6 + d],
                                     data[..., 6 + d:7 + d])]


def _cotangents(shapes, seed):
    rng = np.random.RandomState(seed)
    return [torch.as_tensor(rng.randn(*s).astype(np.float32)) for s in shapes]


@pytest.mark.parametrize("d,ts,max_per_tile", [(3, 16, 256), (1, 32, 256), (3, 32, 100),
                                               (1, 16, 100)])
def test_window_twins_match_jax_kernels(d, ts, max_per_tile):
    """Both windowed pairs through the port's public builders (autograd
    Functions, twins on the CPU) against make_tile_compositor_chunked /
    make_tile_compositor(interpret=True) on the same window: tiles deeper
    than 128 rows, an emptied tile, and max_per_tile=100 (window widened
    to 128 rows, the last 28 masked)."""
    lay, counts, data = _window(_scene(seed=5), d, ts, max_per_tile, empty_tile=True)
    n_tiles, m, _ = data.shape
    assert m % 128 == 0 and m >= max_per_tile
    assert int(counts.max()) > 128 or max_per_tile == 100
    assert int(counts.max()) <= max_per_tile
    p = ts * ts
    bg = torch.as_tensor(np.array([[0.2, 0.1, 0.3]], np.float32)[:, :d])
    cots = _cotangents([(n_tiles, p, d), (n_tiles, p, 1), (n_tiles, p, 1)], seed=ts + d)
    jcots = tuple(jnp.asarray(c.numpy()) for c in cots)

    # chunked pair
    jfn = j_pallas.make_tile_compositor_chunked(n_tiles, m, d, ts, lay.n_tx, interpret=True)
    jout, jvjp = jax.vjp(lambda x: jfn(jnp.asarray(counts.numpy()), x, jnp.asarray(bg.numpy())),
                         jnp.asarray(data.numpy()))
    (jd,) = jvjp(jcots)
    tdata = data.clone().requires_grad_(True)
    tbg = bg.clone().requires_grad_(True)
    tout = wr.make_tile_compositor_chunked(n_tiles, m, d, ts, lay.n_tx)(counts, tdata, tbg)
    td, tdbg = torch.autograd.grad(tout, (tdata, tbg), grad_outputs=cots)
    for name, a, b in zip(("image", "alpha", "depth"), jout, tout):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=FWD_ATOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(_np(td), np.asarray(jd), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    assert not td[0].any(), "the emptied tile's rows get no gradient"
    n_chunks = (counts.long() + 127) // 128
    rows = torch.arange(m)[None, :]
    assert not td[rows >= counts[:, None].long()].any(), "rows at or past the count are zero"
    assert not td[rows >= n_chunks[:, None] * 128].any()
    assert not tdbg.any()

    # simple pair on the same window
    parts = _split(data, counts, d)
    jfs = j_pallas.make_tile_compositor(n_tiles, m, d, ts, lay.n_tx, interpret=True)
    jsout, jsvjp = jax.vjp(lambda *a: jfs(*a, jnp.asarray(bg.numpy())),
                           *[jnp.asarray(x.numpy()) for x in parts])
    jsg = jsvjp(jcots)
    tparts = [x.clone().requires_grad_(True) for x in parts]
    tsout = wr.make_tile_compositor(n_tiles, m, d, ts, lay.n_tx)(*tparts, tbg)
    tsg = torch.autograd.grad(tsout, (*tparts, tbg), grad_outputs=cots)
    for name, a, b in zip(("image", "alpha", "depth"), jsout, tsout):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=FWD_ATOL, rtol=0, err_msg=name)
    for name, a, b in zip(("mu", "con", "op", "col", "z"), jsg, tsg[:5]):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
    assert not tsg[5].any()
    # the two pairs compute one function
    for a, b in zip(tout, tsout):
        np.testing.assert_allclose(_np(b), _np(a), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(_np(torch.cat(tsg[:5], dim=2)), _np(td), atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)


@pytest.mark.parametrize("d,ts", [(3, 32), (1, 32), (3, 16), (1, 16)])
def test_probe_window_twins_match_jax_kernel(d, ts):
    """render/probe_layouts.py:window_probe through the chunked pair's
    twins (the port's make_tile_compositor_chunked and its autograd
    Function on the CPU) against JAX's make_tile_compositor_chunked
    (interpret=True): a tile three chunks
    deep, footprints across the quadrant and warp-patch edges, live rows
    past each count, an empty tile, and pairs on either side of the 1/255
    gate. The probe's own properties are checked first."""
    counts_np, data_np, bg_np, n_tx, _, _ = window_probe(d, ts)
    counts, data, bg = (torch.as_tensor(x) for x in (counts_np, data_np, bg_np))
    n_tiles, m, _ = data.shape
    p = ts * ts
    assert int(counts[0]) > 2 * 128 and int(counts[1]) == 0 and m % 128 == 0
    # the gate pair: alpha exactly 1/255 at its pixel and 0 elsewhere; the
    # pair one ulp below: 0 everywhere
    t, row, gx, gy = PROBE_GATE
    px, py = _pixel_coords(n_tiles, ts, n_tx, CPU)
    blk = data[t:t + 1, row:row + 2].transpose(1, 2)
    alpha = _chunk_alphas(blk, px[t:t + 1], py[t:t + 1], torch.ones(1, 2, dtype=torch.bool))[0]
    gate = np.float32(ALPHA_EPS)
    assert float(alpha[0, gy * ts + gx, 0]) == gate
    assert int(torch.count_nonzero(alpha[0, :, 0])) == 1 and not alpha[0, :, 1].any()

    cots = _cotangents([(n_tiles, p, d), (n_tiles, p, 1), (n_tiles, p, 1)], seed=20 + d + ts)
    jfn = j_pallas.make_tile_compositor_chunked(n_tiles, m, d, ts, n_tx, interpret=True)
    jout, jvjp = jax.vjp(lambda x: jfn(jnp.asarray(counts_np), x, jnp.asarray(bg_np)),
                         jnp.asarray(data_np))
    (jd,) = jvjp(tuple(jnp.asarray(c.numpy()) for c in cots))
    tdata = data.clone().requires_grad_(True)
    tout = wr.make_tile_compositor_chunked(n_tiles, m, d, ts, n_tx)(counts, tdata, bg)
    (td,) = torch.autograd.grad(tout, (tdata,), grad_outputs=cots)
    for name, a, b in zip(("image", "alpha", "depth"), jout, tout):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=FWD_ATOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(_np(td), np.asarray(jd), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    # the live rows past each count are masked: no gradient, and the empty
    # tile is bg
    rows = torch.arange(m)[None, :]
    assert not td[rows >= counts[:, None].long()].any()
    assert td[0, :int(counts[0])].any(dim=1).float().mean() > 0.9
    np.testing.assert_array_equal(_np(tout[0][1]), np.broadcast_to(bg_np, (p, d)))
    assert not tout[1][1].any()


# the simple probe against JAX: the tolerances the card holds the kernels
# to (chip_smoke.py FWD_TOL, the JAX suite's cross-backend bounds)
PROBE_FWD_TOL = {"image": 3e-4, "alpha": 3e-4, "depth": 3e-3}


@pytest.mark.parametrize("m", SIMPLE_PROBE_ROWS)
@pytest.mark.parametrize("ts", [32, 16])
@pytest.mark.parametrize("d", [3, 1])
def test_simple_probe_twins_match_jax_kernel(d, ts, m):
    """render/probe_layouts.py:simple_window_probe through the simple pair's
    twins (the port's make_tile_compositor and its autograd Function on the
    CPU) against JAX's make_tile_compositor (interpret=True): window rows
    not a multiple of 128 (300) or of 4 (258), masked rows among live ones,
    an all-masked chunk between live chunks, an all-masked tile, alphas at
    the 0.99 clamp and on either side of 1/255, a mean on a pixel centre
    and power clamped at 0. Forward within PROBE_FWD_TOL, gradients within
    atol 2e-4 + rtol 1e-3. The probe's own properties are checked first.

    JAX's builder refuses windows of more than 256 rows that are not a
    multiple of 256 (`_cumsum_rows` cuts the window into 256-row blocks and
    its tail block's product does not type-check), so its kernel runs on
    the probe padded with masked rows to the next multiple of 256: a masked
    row moves no output and gets zero gradient, which is checked on the
    padding."""
    *parts_np, bg_np, n_tx, _, _ = simple_window_probe(d, ts, m)
    parts = [torch.as_tensor(x) for x in parts_np]
    bg = torch.as_tensor(bg_np)
    mu, con, op = parts[:3]
    n_tiles, p = mu.shape[0], ts * ts
    assert m % 128 and (m % 4 == 0) == (m == 300)
    chunk_live = [[bool(op[t, c * 128:(c + 1) * 128].any()) for c in range(3)] for t in range(3)]
    assert chunk_live == [[True, False, True], [False] * 3, [True, True, False]]
    assert not op[0, :128].all() and not op[2, 5:200].all()
    px, py = _pixel_coords(n_tiles, ts, n_tx, CPU)
    blk = torch.cat([mu, con, op], dim=2)[2:3].transpose(1, 2)
    alpha, raw, power, dx, dy = _chunk_alphas(blk, px[2:3], py[2:3],
                                              torch.ones(1, m, dtype=torch.bool))
    _, gx, gy = PROBE_GATE[1:]
    assert float(alpha[0, gy * ts + gx, 0]) == np.float32(ALPHA_EPS)
    assert int(torch.count_nonzero(alpha[0, :, 0])) == 1 and not alpha[0, :, 1].any()
    _, centred, clamped, indefinite = SIMPLE_PROBE_CLAMP
    assert bool(((dx[0, :, centred] == 0) & (dy[0, :, centred] == 0)).any())
    assert float(alpha[0, :, clamped].max()) == np.float32(0.99)
    q = -0.5 * (con[2, indefinite, 0] * dx ** 2 + con[2, indefinite, 2] * dy ** 2)
    assert bool((q[0, :, indefinite] - con[2, indefinite, 1] * dx[0, :, indefinite]
                 * dy[0, :, indefinite] > 0).any())
    assert float(power[0, :, indefinite].max()) == 0.0

    cots = _cotangents([(n_tiles, p, d), (n_tiles, p, 1), (n_tiles, p, 1)], seed=40 + d + ts)
    jbg = jnp.asarray(bg_np)
    with pytest.raises(TypeError, match="contracting dimensions"):
        j_pallas.make_tile_compositor(n_tiles, m, d, ts, n_tx, interpret=True)(
            *(jnp.asarray(x) for x in parts_np), jbg)
    m_pad = -(-m // 256) * 256
    padded = [np.pad(x, ((0, 0), (0, m_pad - m), (0, 0))) for x in parts_np]  # op = 0: masked
    jfn = j_pallas.make_tile_compositor(n_tiles, m_pad, d, ts, n_tx, interpret=True)
    jout, jvjp = jax.vjp(lambda *x: jfn(*x, jbg), *(jnp.asarray(x) for x in padded))
    jgrads = [np.asarray(g) for g in jvjp(tuple(jnp.asarray(c.numpy()) for c in cots))]
    assert not any(g[:, m:].any() for g in jgrads)
    jgrads = [g[:, :m] for g in jgrads]
    tparts = [x.clone().requires_grad_(True) for x in parts]
    tout = wr.make_tile_compositor(n_tiles, m, d, ts, n_tx)(*tparts, bg)
    tgrads = torch.autograd.grad(tout, tparts, grad_outputs=cots)
    for name, a, b in zip(("image", "alpha", "depth"), jout, tout):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=PROBE_FWD_TOL[name], rtol=0,
                                   err_msg=name)
    for name, a, b in zip(("mu", "con", "op", "col", "z"), jgrads, tgrads):
        np.testing.assert_allclose(_np(b), a, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)
    # masked rows get no gradient but dop (JAX's: exp(power) * dalpha); the
    # all-masked tile is bg
    masked = op[..., 0] == 0
    for g in tgrads[:2] + tgrads[3:]:
        assert not g[masked].any()
    np.testing.assert_array_equal(_np(tout[0][1]), np.broadcast_to(bg_np, (p, d)))
    assert not tout[1][1].any() and not tgrads[2][1].any()


def _loss_terms(res, target, xp):
    return (xp.mean((res.image - target) ** 2) + 0.3 * xp.mean(res.alpha)
            + 0.1 * xp.mean(res.depth))


@pytest.mark.parametrize("case", ["ts16", "ts32_mpt100", "crop_partial"])
def test_composite_tiled_matches_jax(case):
    """render(backend="tiled") against JAX's, values and gradients of the
    JAX suite's test loss: 256-row windows at ts 16, a clamped
    max_per_tile=100 at ts 32 (pairs dropped and counted alike), and a
    48x40 crop window (40/16 = 2.5: the bottom tile row is partial)."""
    args = _scene(seed=9)
    # 256 rows hold the deepest ts-16 tile (~150 pairs) and keep JAX's
    # per-tile XLA loop small
    kw = dict(ts16=dict(tile_size=16, max_per_tile=256),
              ts32_mpt100=dict(tile_size=32, max_per_tile=100),
              crop_partial=dict(tile_size=16, max_per_tile=256))[case]
    crop = (48, 40) if case == "crop_partial" else None
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    cw, ch = crop or (W, H)
    target = np.random.RandomState(1).rand(3, ch, cw).astype(np.float32)
    jc, tc = _cams()

    def jloss(m, c, o, s, q):
        r = j_render(jc, m, j_cov(s, q), o, jnp.asarray(bg), colors_precomp=c, backend="tiled",
                     tile_config=JTileConfig(**kw), crop_size=crop)
        return _loss_terms(r, target, jnp), r

    (_, rj), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *[jnp.asarray(a) for a in args])
    ta = [torch.tensor(a, requires_grad=True) for a in args]
    rt = t_render(tc, ta[0], t_cov(ta[3], ta[4]), ta[2], torch.as_tensor(bg),
                  colors_precomp=ta[1], backend="tiled", tile_config=TileConfig(**kw),
                  crop_size=crop)
    gt = torch.autograd.grad(_loss_terms(rt, torch.as_tensor(target), torch), ta)
    assert rt.image.shape == (3, ch, cw)
    assert int(rt.dropped_pairs) == int(rj.dropped_pairs)
    assert (int(rt.dropped_pairs) > 0) == (case == "ts32_mpt100")
    if crop:
        np.testing.assert_array_equal(_np(rt.crop_offset), np.asarray(rj.crop_offset))
    for f in ("image", "alpha", "depth"):
        np.testing.assert_allclose(_np(getattr(rt, f)), np.asarray(getattr(rj, f)),
                                   atol=FWD_ATOL, rtol=0, err_msg=f)
    for name, a, b in zip(("means", "colors", "opacities", "scales", "quats"), gj, gt):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"grad {name}")


def test_auto_backend_is_tiled_like_jax():
    """backend="auto" with no tile config is the tiled backend, as in JAX:
    one tile 1,500 pairs deep is clamped at the default max_per_tile
    (1,024) and the loss is counted, so the image and dropped_pairs match
    JAX's "auto" (the oracle would drop nothing)."""
    rng = np.random.RandomState(2)
    n = 1500
    means = np.concatenate([rng.uniform(-0.05, 0.05, (n, 2)), rng.uniform(-1, 1, (n, 1))],
                           axis=1).astype(np.float32)
    scales = np.full((n, 3), 0.01, np.float32)
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    colors = rng.rand(n, 3).astype(np.float32)
    ops = rng.uniform(0.05, 0.2, n).astype(np.float32)
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    jc, tc = _cams()
    rj = j_render(jc, jnp.asarray(means), j_cov(jnp.asarray(scales), jnp.asarray(quats)),
                  jnp.asarray(ops), jnp.asarray(bg), colors_precomp=jnp.asarray(colors),
                  backend="auto")
    rt = t_render(tc, torch.as_tensor(means),
                  t_cov(torch.as_tensor(scales), torch.as_tensor(quats)),
                  torch.as_tensor(ops), torch.as_tensor(bg),
                  colors_precomp=torch.as_tensor(colors), backend="auto")
    assert int(rj.dropped_pairs) > 0
    assert int(rt.dropped_pairs) == int(rj.dropped_pairs)
    for f in ("image", "alpha", "depth"):
        np.testing.assert_allclose(_np(getattr(rt, f)), np.asarray(getattr(rj, f)),
                                   atol=FWD_ATOL, rtol=0, err_msg=f)


def test_window_wrappers_check_inputs():
    """The wrappers raise on what the kernels do not take: a window whose
    rows are not a multiple of 128, a channel count or tile size the
    library was not built for, and a device with no kernel."""
    counts = torch.zeros(2, dtype=torch.int32)
    bg = torch.zeros(1, 3)
    with pytest.raises(ValueError, match="multiple of 128"):
        wr.window_chunked_forward(counts, torch.zeros(2, 100, 10), bg, 16, 2)
    with pytest.raises(ValueError, match="channel count"):
        wr.window_chunked_forward(counts, torch.zeros(2, 128, 9), torch.zeros(1, 2), 16, 2)
    with pytest.raises(ValueError, match="tile size"):
        wr.window_chunked_forward(counts, torch.zeros(2, 128, 10), bg, 8, 2)
    parts = [torch.zeros(2, 5, c) for c in (2, 3, 1, 3, 1)]
    with pytest.raises(ValueError, match="no windowed compositor"):
        wr.window_forward(*[x.to("meta") for x in parts], bg.to("meta"), 16, 2)
    img, alpha, depth = wr.window_forward(*parts, bg, 16, 2)
    assert img.shape == (2, 256, 3) and not alpha.any() and not depth.any()
    # the cull-off check instances have no CPU twin
    with pytest.raises(ValueError, match="CUDA tensors only"):
        wr.window_chunked_forward_nocull(counts, torch.zeros(2, 128, 10), bg, 16, 2)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        wr.window_forward_nocull(*parts, bg, 16, 2)
    cots = [torch.zeros(2, 256, c) for c in (3, 1, 1)]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        wr.window_backward_nocull(*parts, bg, *cots, 16, 2)
