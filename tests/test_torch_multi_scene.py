"""The scene lockstep's steps (parallel/multi_scene.py) and the scene axis
of the compositors, on the CPU:

  * each plain twin with a scene axis (the tile-grid pair in both backward
    flavors, the chunked windowed pair; D = 3 and 1) against one-scene
    twin calls, bit for bit, through the whole scene-batched render
    (binning, layouts, compositor, the gathers' backward): two scenes
    whose binning capacities differ (one's max_pairs, max_per_tile and
    slot capacity doubled) and two crop sizes, so each scene drops, lays
    out and composites exactly what it does alone;
  * the stepped functions against JAX's on the same numpy-seeded inputs,
    its Pallas kernels in interpret mode, two scenes with per-scene
    xyz-rate factors: multi_scene_train_step against JAX's own (jitted,
    vmapped); coarse_step_traced (every flag combination at one warm-up
    and one post-warm-up iteration) against JAX's; multi_scene_static_step
    (std, entropy and label modes), multi_scene_coarse_step,
    multi_scene_fine_step and multi_scene_fine_all_step lane by lane
    against JAX's single-scene steps, which JAX's lockstep vmaps (each of
    the port's lanes equals its one-scene run bit for bit,
    tests/test_torch_scene_trainer.py; JAX's vmap over the interpret-mode
    kernels compiles for up to twenty minutes each on the CPU). Tolerances
    are those the port's other single-step comparisons with JAX use:
    parameters 2e-5 absolute, losses 1e-5 relative, screen radii and
    visibility counts equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egogaussian_tpu.config import Config as JConfig
from egogaussian_tpu.data import readers as j_readers
from egogaussian_tpu.models import adam_init as j_adam_init
from egogaussian_tpu.models import from_points as j_from_points
from egogaussian_tpu.models.pose import empty_pose_sequence as j_empty_seq
from egogaussian_tpu.models.pose import identity_pose as j_identity_pose
from egogaussian_tpu.parallel import multi_scene as j_ms
from egogaussian_tpu.train.common import auto_tile_config as j_auto_tile_config
from egogaussian_tpu.train.coarse_pose import coarse_step_traced as j_coarse_step_traced
from egogaussian_tpu_torch.config import Config
from egogaussian_tpu_torch.data import make_synthetic_video, stack_cameras
from egogaussian_tpu_torch.models import adam_init, from_jax_arrays
from egogaussian_tpu_torch.models.pose import empty_pose_sequence, identity_pose
from egogaussian_tpu_torch.parallel import multi_scene as ms
from egogaussian_tpu_torch.render.project import ProjectedGaussians
from egogaussian_tpu_torch.render.tiled import (
    TileConfig,
    composite_cuda,
    composite_scenes,
    composite_tiled,
    estimate_tile_config,
    scene_caps,
)
from egogaussian_tpu_torch.train.common import auto_tile_config
from egogaussian_tpu_torch.train.coarse_pose import coarse_step_traced
from tests.test_torch_static import _jax_cameras

torch.set_num_threads(1)
CPU = torch.device("cpu")
PARAMS = ("xyz", "log_scales", "quats", "opacity_logit", "features_dc", "label")
W, H = 64, 48


# ---------------------------------------------------------------------------
# the scene axis of the compositors
# ---------------------------------------------------------------------------

def _splats(seed, n=300, d=3, w=W, h=H):
    g = torch.Generator().manual_seed(seed)
    mu = torch.rand(n, 2, generator=g) * torch.tensor([w, h])
    con = torch.stack([torch.rand(n, generator=g) * 0.3 + 0.05,
                       (torch.rand(n, generator=g) - 0.5) * 0.02,
                       torch.rand(n, generator=g) * 0.3 + 0.05], 1)
    radii = (torch.rand(n, generator=g) * 8 + 1).to(torch.int32)
    proj = ProjectedGaussians(mu, con, torch.rand(n, generator=g) * 5 + 1, radii, con)
    return proj, torch.rand(n, d, generator=g), torch.rand(n, generator=g) * 0.9


def _grads_of(out):
    return (out.image.sum() + 0.5 * out.alpha.sum() + (out.depth * out.image[..., :1, :, :]).sum())


@pytest.mark.parametrize("d", [3, 1])
@pytest.mark.parametrize("flavor", ["tilegrid", "tilegrid_exact", "chunked", "stream"])
def test_scene_axis_twins_equal_one_scene_twins(flavor, d):
    """Two scenes in one layout and one twin call per pass against each
    scene rendered alone at its own capacities and size: image, alpha,
    depth, dropped pairs and every input gradient bit for bit; the pixels
    of the smaller scene past its own size are its background."""
    scenes = [_splats(1, d=d), _splats(2, d=d, w=48, h=40)]
    sizes = [(W, H), (48, 40)]
    base = [estimate_tile_config(p.means2d, p.radii, w, h, tile_size=16, opacities=o)
            for (p, _, o), (w, h) in zip(scenes, sizes)]
    base[1] = TileConfig(tile_size=16, max_pairs=base[1].max_pairs * 2,
                         max_per_tile=base[1].max_per_tile * 2,
                         max_slots=base[1].max_slots * 2)
    cfgs = [dataclasses.replace(c, bwd_exact_total=flavor == "tilegrid_exact",
                                compositor="stream" if flavor == "stream" else "tilegrid")
            for c in base]
    backend = "tiled" if flavor == "chunked" else "cuda"
    bg = torch.rand(2, d, generator=torch.Generator().manual_seed(3))
    singles = []
    for (p, c, o), cfg, b, (w, h) in zip(scenes, cfgs, bg, sizes):
        mu, con, cols, op = (x.clone().requires_grad_(True) for x in (p.means2d, p.conics, c, o))
        fn = composite_tiled if backend == "tiled" else composite_cuda
        out = fn(p._replace(means2d=mu, conics=con), cols, op, b, w, h, cfg)
        _grads_of(out).backward()
        singles.append((out, mu.grad, con.grad, cols.grad, op.grad))
    stk = ProjectedGaussians(*(torch.stack([a, b]) for a, b in zip(scenes[0][0], scenes[1][0])))
    mu, con = stk.means2d.clone().requires_grad_(True), stk.conics.clone().requires_grad_(True)
    cols = torch.stack([scenes[0][1], scenes[1][1]]).requires_grad_(True)
    op = torch.stack([scenes[0][2], scenes[1][2]]).requires_grad_(True)
    caps = scene_caps(cfgs, sizes, CPU, 300)
    out = composite_scenes(stk._replace(means2d=mu, conics=con), cols, op, bg, caps, backend)
    _grads_of(out).backward()
    for s, ((one, gmu, gcon, gcol, gop), (w, h)) in enumerate(zip(singles, sizes)):
        assert torch.equal(out.image[s, :, :h, :w], one.image)
        assert torch.equal(out.alpha[s, :, :h, :w], one.alpha)
        assert torch.equal(out.depth[s, :, :h, :w], one.depth)
        assert int(out.dropped_pairs[s]) == int(one.dropped_pairs)
        for a, b in ((mu.grad[s], gmu), (con.grad[s], gcon), (cols.grad[s], gcol),
                     (op.grad[s], gop)):
            assert torch.equal(a, b)
    # the second scene's pixels past its own 48x40 are background only
    assert torch.equal(out.image[1, :, 40:, :], bg[1][:, None, None].expand(d, 8, W))
    assert torch.equal(out.alpha[1, :, :, 48:], torch.zeros(1, H, 16))


def test_stream_compositor_takes_one_scene_only():
    """The stream pair (rows 4-5) with a scene axis, named for the refusal
    it replaced: two scenes in one stream layout and one twin call per pass
    at ts 32 equal each scene through the one-scene stream layout and twin
    calls bit for bit (every meta row of a scene is its own layout's, its
    tiles and slots offset by the scenes before it; the shared capacity's
    slots past its own are padding or its overflowed, masked tiles'),
    where the second
    scene's slot capacity ends inside a tile's run (its later tiles
    overflow, are masked and count as dropped) and the first scene's is
    twice its own need; image, alpha, depth, dropped pairs and the vals
    gradient (the masked tiles' cotangents zero, as in the render; the
    shared capacity's slots past a scene's own get none)."""
    from egogaussian_tpu_torch.render import stream_raster as sr
    from egogaussian_tpu_torch.render.tiled import stream_layout, stream_layout_scenes

    scenes = [_splats(4, n=400), _splats(5, n=400)]
    base = [estimate_tile_config(p.means2d, p.radii, W, H, tile_size=32, opacities=o)
            for p, _, o in scenes]
    cfgs = [TileConfig(tile_size=32, max_pairs=base[0].max_pairs,
                       max_per_tile=base[0].max_per_tile, max_slots=base[0].max_slots * 2,
                       compositor="stream"),
            TileConfig(tile_size=32, max_pairs=base[1].max_pairs,
                       max_per_tile=base[1].max_per_tile, max_slots=256, compositor="stream")]
    bg = torch.rand(2, 3, generator=torch.Generator().manual_seed(6))
    cots = None
    singles = []
    for (p, c, o), cfg, b in zip(scenes, cfgs, bg):
        lay = stream_layout(p, c, o, W, H, cfg)
        n = lay.n_tx * lay.n_ty
        vals = lay.vals.detach().contiguous()
        out = sr.stream_forward(lay.meta, vals, b[None], 32, lay.n_tx, n)
        if cots is None:
            g = torch.Generator().manual_seed(7)
            cots = [torch.rand(x.shape, generator=g) for x in out[:3]]
        # the render masks the tiles that own no chunk (empty or
        # overflowed), so their cotangents are zero
        own_cots = [torch.where(lay.empty[:, None, None], 0.0, c) for c in cots]
        dv = sr.stream_backward(lay.meta, vals, b[None], out[3], *own_cots, 32, lay.n_tx)
        singles.append((lay, out, dv, own_cots))
    assert int(singles[1][0].dropped) > 0 and int(singles[0][0].dropped) == 0
    stk = ProjectedGaussians(*(torch.stack([a, b]) for a, b in zip(scenes[0][0], scenes[1][0])))
    lay = stream_layout_scenes(stk, torch.stack([scenes[0][1], scenes[1][1]]),
                               torch.stack([scenes[0][2], scenes[1][2]]),
                               scene_caps(cfgs, [(W, H)] * 2, CPU, 400))
    n = lay.n_tx * lay.n_ty
    vals = lay.vals.detach().contiguous()
    out = sr.stream_forward(lay.meta, vals, bg, 32, lay.n_tx, 2 * n)
    dv = sr.stream_backward(lay.meta, vals, bg, out[3],
                            *(torch.cat([a, b]) for a, b in zip(singles[0][3], singles[1][3])),
                            32, lay.n_tx)
    n_slots = lay.meta.shape[1] // 2
    for s, (one, one_out, one_dv, _) in enumerate(singles):
        meta = lay.meta[:, s * n_slots:(s + 1) * n_slots]
        k = one.meta.shape[1]
        assert torch.equal(meta[0, :k] - s * n, one.meta[0])
        assert torch.equal(meta[1:3, :k], one.meta[1:3])
        assert torch.equal(meta[3, :k] - s * n_slots, one.meta[3])
        # past the scene's own capacity: pure padding, or slots of tiles
        # that overflowed it (masked, as alone)
        tail = meta[:, k:].to(torch.int64)
        assert bool(((tail[1] >= tail[2]) | lay.empty[tail[0]]).all())
        assert int(lay.dropped[s]) == int(one.dropped)
        assert torch.equal(lay.empty[s * n:(s + 1) * n], one.empty)
        own = ~one.empty
        for a, b in zip(out[:3], one_out[:3]):
            assert torch.equal(a[s * n:(s + 1) * n][own], b[own])
        rows = slice(s * n_slots * 128, s * n_slots * 128 + k * 128)
        assert torch.equal(dv[rows], one_dv)
        assert not dv[s * n_slots * 128:(s + 1) * n_slots * 128][k * 128:].any()


@pytest.mark.parametrize("x_grad", [True, False])
def test_rotated_covariance_scene_axis_equals_one_scene_calls(x_grad):
    """The object covariance's extra rotation with a scene axis (one
    forward for both scenes; X's gradient summed over each scene's own
    rows) against each scene alone at its own row count, 3,000 and 4,096
    rows in a 4,096-row stack: covariances and the scales', quats' and
    (where X takes a gradient, as in stages 2-3) X's gradients bit for
    bit."""
    from egogaussian_tpu_torch.ops.covariance import (
        covariance_from_scaling_rotation_rotated as rotated)

    g = torch.Generator().manual_seed(8)
    n, rows = 4096, (3000, 4096)
    scales = torch.rand(2, n, 3, generator=g) * 0.1
    quats = torch.randn(2, n, 4, generator=g)
    X = torch.linalg.qr(torch.randn(2, 3, 3, generator=g))[0]
    mask = torch.rand(2, n, generator=g) > 0.5
    w = torch.randn(2, n, 6, generator=g)

    def run(sc, q, x, m, wt, r=None):
        sc, q = sc.clone().requires_grad_(True), q.clone().requires_grad_(True)
        x = x.clone().requires_grad_(x_grad)
        y = rotated(sc, q, x, m, rows=r)
        (y * wt).sum().backward()
        return y.detach(), sc.grad, q.grad, x.grad

    stk = run(scales, quats, X, mask, w, rows)
    for s, c in enumerate(rows):
        one = run(scales[s, :c], quats[s, :c], X[s], mask[s, :c], w[s, :c])
        for a, b in zip(stk[:3], one[:3]):
            assert torch.equal(a[s, :c], b)
        assert (stk[3] is None) == (not x_grad)
        if x_grad:
            assert torch.equal(stk[3][s], one[3])


def test_stack_and_unstack_keep_each_scene():
    """Models of different capacities pad with dead rows and come back cut
    to their own capacity, spatial_lr_scale per scene; one scene stacks as
    views."""
    from egogaussian_tpu_torch.models.gaussians import from_points

    rng = np.random.RandomState(0)
    a = from_points(rng.randn(10, 3).astype(np.float32), rng.rand(10, 3).astype(np.float32),
                    CPU, capacity=16, spatial_lr_scale=2.0)
    b = from_points(rng.randn(20, 3).astype(np.float32), rng.rand(20, 3).astype(np.float32),
                    CPU, capacity=32, spatial_lr_scale=3.0)
    stk = ms.stack_scenes([a, b])
    assert stk.params.xyz.shape == (2, 32, 3) and stk.spatial_lr_scale == (2.0, 3.0)
    assert not bool(stk.aux.alive[0, 16:].any())
    a2, b2 = ms.unstack_scenes(stk, 2, [16, 32])
    for m, m2 in ((a, a2), (b, b2)):
        assert m2.capacity == m.capacity and m2.spatial_lr_scale == m.spatial_lr_scale
        for k, v in m.params.as_dict().items():
            assert torch.equal(getattr(m2.params, k), v)
    one = ms.stack_scenes([a])
    assert one.params.xyz.data_ptr() == a.params.xyz.data_ptr()


# ---------------------------------------------------------------------------
# the stepped functions against JAX's
# ---------------------------------------------------------------------------

def _fields(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


@pytest.fixture(scope="module")
def scenes():
    """Two scenes at 32x24, 6 frames each (videos seeds 0 and 1), 60 and 50
    Gaussians in a capacity of 128, half of them object Gaussians, in both
    packages; each package stacks them itself."""
    out = []
    for seed, n in ((0, 60), (1, 50)):
        vid = make_synthetic_video(CPU, width=32, height=24, n_bg=40, n_obj=12,
                                   frames_static=2, frames_dynamic=2, seed=seed)
        cams = [dataclasses.replace(c, gt_image=torch.round(c.gt_image * 255) / 255)
                for c in vid.cameras[:6]]
        rng = np.random.RandomState(seed)
        jm = j_from_points(rng.randn(n, 3).astype(np.float32),
                           rng.rand(n, 3).astype(np.float32), capacity=128)
        jm = dataclasses.replace(jm, aux=dataclasses.replace(
            jm.aux, is_object=jnp.asarray(np.arange(128) % 2 == 0, jnp.int32)))
        tm = from_jax_arrays(_fields(jm.params), _fields(jm.aux), CPU, sh_degree=jm.sh_degree)
        jb = j_readers.stack_cameras(_jax_cameras(cams))
        tb = stack_cameras(cams, CPU)
        out.append(dict(jm=jm, tm=tm, jb=jb, tb=tb))
    jtile = j_auto_tile_config(out[0]["jm"], out[0]["jb"].camera(0))
    ttile = auto_tile_config(out[0]["tm"], out[0]["tb"].camera(0))
    stk = dict(
        jm=j_ms.stack_scenes([s["jm"] for s in out]),
        jo=j_ms.stack_scenes([j_adam_init(s["jm"].params) for s in out]),
        jb=j_ms.stack_scenes([s["jb"] for s in out]),
        tm=ms.stack_scenes([s["tm"] for s in out]),
        to=ms.stack_scenes([adam_init(s["tm"].params) for s in out]),
        tb=ms.stack_scenes([s["tb"] for s in out]),
        jtile=jtile, ttile=ttile)
    return stk


def _assert_models(tm, jm, atol=2e-5, aux=("denom", "max_radii2d")):
    for k in PARAMS:
        np.testing.assert_allclose(getattr(tm.params, k).detach().numpy(),
                                   np.asarray(getattr(jm.params, k)), atol=atol, rtol=0,
                                   err_msg=k)
    for k in aux:
        np.testing.assert_array_equal(getattr(tm.aux, k).numpy(), np.asarray(getattr(jm.aux, k)),
                                      err_msg=k)


MULT = (1.0, 1.3)


def _lane(tree, s):
    return jax.tree_util.tree_map(lambda x: x[s], tree)


@pytest.mark.parametrize("mode", ["std", "entropy", "label"])
def test_multi_scene_static_step_matches_jax(scenes, mode):
    """Two scenes, two frames each, per-scene xyz-rate factors: the port's
    step (one batched render per frame slot) lane by lane against JAX's
    single-scene step at the lane's spatial_lr_scale (the xyz rate is
    linear in it), the body JAX's lockstep vmaps."""
    from egogaussian_tpu.train.static import _static_step as j_static_step

    p = scenes
    fidxs = np.array([[0, 3], [5, 1]], np.int32)
    tout = ms.multi_scene_static_step(
        p["tm"], p["to"], p["tb"], torch.as_tensor(fidxs), p["tb"].hand_masks, 120,
        xyz_lr_mult=torch.tensor(MULT), mode=mode, backend="tiled", tile_config=p["ttile"],
        opt_cfg=Config().opt, label_lr=0.05)
    tm, _, tloss, tradii, tdrop = tout
    lanes = ms.unstack_scenes(tm, 2)
    for s in range(2):
        jm = dataclasses.replace(_lane(p["jm"], s), spatial_lr_scale=MULT[s])
        jb = _lane(p["jb"], s)
        jm, _, jloss, jradii, jdrop = j_static_step(
            jm, _lane(p["jo"], s), jb, jnp.asarray(fidxs[s]), jb.hand_masks, jnp.int32(120),
            mode=mode, backend="tiled", tile_config=p["jtile"], opt_cfg=JConfig().opt,
            label_lr=0.05)
        np.testing.assert_allclose(float(tloss[s]), float(jloss), rtol=1e-5)
        np.testing.assert_array_equal(tradii[:, s].numpy(), np.asarray(jradii))
        assert int(tdrop[s]) == int(jdrop)
        _assert_models(lanes[s], jm)
        np.testing.assert_allclose(lanes[s].aux.xyz_gradient_accum.numpy(),
                                   np.asarray(jm.aux.xyz_gradient_accum), atol=1e-5, rtol=0)


def test_multi_scene_train_step_matches_jax(scenes):
    """JAX's plain lockstep step (each scene's mean loss over its frames,
    per-scene learning-rate trees) against the port's."""
    from egogaussian_tpu.models.optim import gaussian_lr_tree as j_lr_tree
    from egogaussian_tpu_torch.models.optim import gaussian_lr_tree

    p = scenes
    fidxs = np.array([[1, 2], [4, 0]], np.int32)
    jlr = j_lr_tree(p["jm"].params, jnp.int32(5), JConfig().opt, 1.0, label_lr=0.0)
    jlrs = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), jlr)
    jm, _, jloss = jax.jit(j_ms.multi_scene_train_step)(p["jm"], p["jo"], p["jb"],
                                                       jnp.asarray(fidxs), jlrs)
    lr = gaussian_lr_tree(5, Config().opt, 1.0, label_lr=0.0)
    tm, _, tloss = ms.multi_scene_train_step(p["tm"], p["to"], p["tb"], torch.as_tensor(fidxs),
                                             lr)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-5)
    _assert_models(tm, jm, aux=())


def _pose_problem(p):
    pose = identity_pose(CPU)
    pose = dataclasses.replace(pose, translation=torch.tensor([0.05, -0.02, 0.01]))
    jpose = dataclasses.replace(j_identity_pose(),
                                translation=jnp.asarray([0.05, -0.02, 0.01], jnp.float32))
    f = p["tb"].viewmats.shape[1]
    return pose, jpose, f


@pytest.mark.parametrize("it", [50, 25_600])
def test_coarse_step_traced_matches_jax(scenes, it):
    """Every (train_pose, first_frame) combination at a warm-up and a
    post-warm-up iteration, grad_params as the single-scene driver sets it,
    with nonzero pose moments so a skipped pose update shows."""
    p = scenes
    one = ms.unstack_scenes(p["tm"], 2)[0]
    jone = _lane(p["jm"], 0)
    tb = ms.unstack_scenes(p["tb"], 2)[0]
    jb = _lane(p["jb"], 0)
    pose, jpose, f = _pose_problem(p)
    cfg, jcfg = Config(), JConfig()
    for train_pose in (True, False):
        for first_frame in (True, False):
            grad_params = first_frame or it >= cfg.coarse.warm_up_iter
            popt = adam_init(pose)
            popt = dataclasses.replace(popt, mu=popt.mu.__class__(
                translation=popt.mu.translation + 0.01, rot6d=popt.mu.rot6d + 0.01),
                nu=popt.nu.__class__(translation=popt.nu.translation + 0.02,
                                     rot6d=popt.nu.rot6d + 0.02))
            jpopt = j_adam_init(jpose)
            jpopt = dataclasses.replace(
                jpopt, mu=jax.tree_util.tree_map(lambda x: x + 0.01, jpopt.mu),
                nu=jax.tree_util.tree_map(lambda x: x + 0.02, jpopt.nu))
            tT = torch.eye(4).expand(f + 1, 4, 4)
            tR = torch.eye(3).expand(f + 1, 3, 3)
            jout = j_coarse_step_traced(
                jone, j_adam_init(jone.params), jpose, jpopt, jb, jnp.int32(1),
                jnp.tile(jnp.eye(4)[None], (f + 1, 1, 1)), jnp.tile(jnp.eye(3)[None], (f + 1, 1, 1)),
                jnp.int32(0), jnp.int32(it), jnp.int32(0), jnp.asarray(train_pose),
                jnp.asarray(first_frame), grad_params=grad_params, opt_cfg=jcfg.opt,
                coarse_cfg=jcfg.coarse, backend="tiled", tile_config=p["jtile"])
            tout = coarse_step_traced(
                one, adam_init(one.params), pose, popt, tb, 1, tT, tR, 0, it,
                torch.zeros((), dtype=torch.int64), torch.tensor(train_pose),
                torch.tensor(first_frame), grad_params=grad_params, opt_cfg=cfg.opt,
                coarse_cfg=cfg.coarse, backend="tiled", tile_config=p["ttile"])
            msg = f"train_pose={train_pose} first_frame={first_frame}"
            np.testing.assert_allclose(float(tout[4]), float(jout[4]), rtol=1e-5, err_msg=msg)
            _assert_models(tout[0], jout[0], aux=())
            for k in ("translation", "rot6d"):
                np.testing.assert_allclose(getattr(tout[2], k).numpy(),
                                           np.asarray(getattr(jout[2], k)), atol=1e-6, rtol=0,
                                           err_msg=f"{msg} pose {k}")
                for m in ("mu", "nu"):
                    np.testing.assert_allclose(
                        getattr(getattr(tout[3], m), k).numpy(),
                        np.asarray(getattr(getattr(jout[3], m), k)), atol=1e-6, rtol=0,
                        err_msg=f"{msg} pose Adam {m}.{k}")


def test_multi_scene_coarse_step_matches_jax(scenes):
    """Two scenes with opposite per-scene flags (one trains its pose, the
    other is its phase's first frame) and per-scene xyz-rate factors, lane
    by lane against JAX's single-scene traced step with the lane's
    parameter-gradient gate and xyz-rate factor, the body JAX's lockstep
    vmaps."""
    p = scenes
    pose, jpose, f = _pose_problem(p)
    cfg, jcfg = Config(), JConfig()
    cams, fixed, it = [1, 3], [0, 2], 100
    train, first = [True, False], [False, True]
    tout = ms.multi_scene_coarse_step(
        p["tm"], p["to"], ms.stack_scenes([pose, pose]),
        ms.stack_scenes([adam_init(pose), adam_init(pose)]), p["tb"], cams,
        torch.eye(4).expand(2, f + 1, 4, 4), torch.eye(3).expand(2, f + 1, 3, 3), fixed, it,
        torch.zeros(2, dtype=torch.int64), train_poses=train,
        first_frames=first, grad_params=True, xyz_lr_mult=torch.tensor(MULT),
        opt_cfg=cfg.opt, coarse_cfg=cfg.coarse, backend="tiled", tile_config=p["ttile"])
    lanes = ms.unstack_scenes(tout[0], 2)
    poses = ms.unstack_scenes(tout[2], 2)
    for s in range(2):
        jm = _lane(p["jm"], s)
        gate = jnp.float32(first[s] or it >= jcfg.coarse.warm_up_iter)
        jout = j_coarse_step_traced(
            jm, _lane(p["jo"], s), jpose, j_adam_init(jpose), _lane(p["jb"], s),
            jnp.int32(cams[s]), jnp.tile(jnp.eye(4)[None], (f + 1, 1, 1)),
            jnp.tile(jnp.eye(3)[None], (f + 1, 1, 1)), jnp.int32(fixed[s]), jnp.int32(it),
            jnp.int32(0), jnp.asarray(train[s]), jnp.asarray(first[s]), grad_params=True,
            param_grad_gate=gate, xyz_lr_mult=jnp.float32(MULT[s]), opt_cfg=jcfg.opt,
            coarse_cfg=jcfg.coarse, backend="tiled", tile_config=p["jtile"])
        np.testing.assert_allclose(float(tout[4][s]), float(jout[4]), rtol=1e-5)
        _assert_models(lanes[s], jout[0], aux=("denom",))
        for k in ("translation", "rot6d"):
            np.testing.assert_allclose(getattr(poses[s], k).numpy(),
                                       np.asarray(getattr(jout[2], k)), atol=1e-6, rtol=0,
                                       err_msg=f"lane {s} {k}")


def test_multi_scene_fine_steps_match_jax(scenes):
    """Stage 3's step on two lanes (one loads and trains its frame's delta,
    the other renders at its accumulated pose) at a post-window iteration,
    then stage 5's step with the opacity clamp on, each lane against JAX's
    single-scene step on the same lane (JAX's lockstep vmaps that step;
    its vmap over the interpret-mode kernel compiles for minutes on the
    CPU)."""
    from egogaussian_tpu.train.fine_all import _fine_all_step as j_fine_all_step
    from egogaussian_tpu.train.fine_obj import _fine_obj_step as j_fine_obj_step

    p = scenes
    f = p["tb"].viewmats.shape[1]
    cfg, jcfg = Config(), JConfig()
    it = cfg.fine.densify_until_iter + 5
    delta = [0.02, 0.0, -0.01]
    seq = empty_pose_sequence(f).update_frame(1, dataclasses.replace(
        identity_pose(CPU), translation=torch.tensor(delta)))
    jseq = j_empty_seq(f).update_frame(1, dataclasses.replace(
        j_identity_pose(), translation=jnp.asarray(delta, jnp.float32)))
    cams, train = [1, 2], [True, False]
    tout = ms.multi_scene_fine_step(
        p["tm"], p["to"], ms.stack_scenes([seq, seq]),
        ms.stack_scenes([adam_init(identity_pose(CPU))] * 2), p["tb"], cams, it,
        torch.zeros(2, dtype=torch.int64), train_poses=train, xyz_lr_mult=torch.tensor(MULT),
        opt_cfg=cfg.opt, fine_cfg=cfg.fine, backend="tiled", tile_config=p["ttile"])
    lanes = ms.unstack_scenes(tout[0], 2)
    seqs = ms.unstack_scenes(tout[2], 2)
    jmodels = []
    for s in range(2):
        jm = dataclasses.replace(_lane(p["jm"], s), spatial_lr_scale=MULT[s])
        jb = _lane(p["jb"], s)
        jout = j_fine_obj_step(jm, j_adam_init(jm.params), jseq, j_adam_init(j_identity_pose()),
                               jb, jnp.int32(cams[s]), jnp.int32(it), jnp.int32(0),
                               train_pose=train[s], opt_cfg=jcfg.opt, fine_cfg=jcfg.fine,
                               backend="tiled", tile_config=p["jtile"])
        np.testing.assert_allclose(float(tout[4][s]), float(jout[4]), rtol=1e-5)
        _assert_models(lanes[s], jout[0], aux=("denom",))
        for k in ("translations", "rotations"):
            np.testing.assert_allclose(getattr(seqs[s], k).numpy(),
                                       np.asarray(getattr(jout[2], k)), atol=1e-6, rtol=0)
        jmodels.append((jout[0], jout[1], jb))

    accT = torch.stack([seq.accum_T(), seq.accum_T()])
    accR = torch.stack([seq.accum_R(), seq.accum_R()])
    tm5, _, tloss5, _ = ms.multi_scene_fine_all_step(
        tout[0], tout[1], p["tb"], [1, 4], accT, accR, 7, True,
        torch.zeros(2, dtype=torch.int64), xyz_lr_mult=torch.tensor(MULT), backend="tiled",
        tile_config=p["ttile"], opt_cfg=cfg.opt)
    for s, (jm, jo, jb) in enumerate(jmodels):
        jm5, _, jloss5, _ = j_fine_all_step(
            jm, jo, jb, jnp.int32([1, 4][s]), jseq.accum_T(), jseq.accum_R(), jnp.int32(7),
            jnp.asarray(True), 0, lambda_dssim=0.2, backend="tiled", tile_config=p["jtile"],
            opt_cfg=jcfg.opt)
        np.testing.assert_allclose(float(tloss5[s]), float(jloss5), rtol=1e-5)
        _assert_models(ms.unstack_scenes(tm5, 2)[s], jm5, aux=())
