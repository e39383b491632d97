"""The port's distributed layer (`egogaussian_tpu_torch/parallel/`, the mesh
of `train_static`, `train_background`, `run_pipeline` and the training
CLI) on gloo ranks on the CPU, spawned by parallel/launch.py:spawn (rank
bodies in tests/_torch_dist_workers.py, which imports no JAX). JAX runs in
this process only, on its 8-device virtual CPU mesh (tests/conftest.py):

  * make_mesh on a 2x2 grid: coordinates, each axis's subgroup, replicate
    and shard_batch (blocks against the indices of JAX's
    NamedSharding(P("data")) shards);
  * _dp_frame_batch with JAX's cases;
  * _dp_static_step at D = 2 and 4 on 8 frames, modes std, entropy and
    label, against the port's _static_step on the same frames and against
    JAX's _dp_static_step at the same D, within JAX's own bounds between
    its DP and single steps (tests/test_parallel.py: loss rtol 1e-5,
    params 2e-5, xyz_gradient_accum 1e-5; denom, radii, max_radii2d and
    the drop count exact); every rank's result bit for bit rank 0's;
  * make_dp_train_step on 8 ranks against JAX's 8-way step and its
    single-device step (loss rtol 1e-5, xyz 1e-5);
  * train_background on 2 ranks with densify, opacity reset and a
    checkpoint inside the run: the checkpoint and the PLY written by rank 0
    alone, and a run stopped after the checkpoint and called again equal
    to the unbroken run bit for bit.

The training CLI's --mesh 2 is held in
test_torch_pipeline.py::test_train_cli_on_exported_dataset, the
multi-video CLI's scene and data axes in test_torch_train_multi.py.
"""
import dataclasses
import datetime
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egogaussian_tpu.config import Config as JConfig
from egogaussian_tpu.data import readers as j_readers
from egogaussian_tpu.models import adam_init as j_adam_init
from egogaussian_tpu.models import from_points as j_from_points
from egogaussian_tpu.models.optim import gaussian_lr_tree as j_lr_tree
from egogaussian_tpu.parallel import make_dp_train_step as j_make_dp_train_step
from egogaussian_tpu.parallel import make_mesh as j_make_mesh
from egogaussian_tpu.parallel import replicate as j_replicate
from egogaussian_tpu.parallel import shard_batch as j_shard_batch
from egogaussian_tpu.parallel.data_parallel import data_parallel_train_step as j_dp_step
from egogaussian_tpu.train.common import auto_tile_config as j_auto_tile_config
from egogaussian_tpu.train.static import _dp_static_step as j_dp_static_step
from egogaussian_tpu_torch.config import Config
from egogaussian_tpu_torch.data import make_synthetic_video, stack_cameras
from egogaussian_tpu_torch.models import adam_init, from_jax_arrays
from egogaussian_tpu_torch.models.optim import gaussian_lr_tree
from egogaussian_tpu_torch.parallel.launch import spawn
from egogaussian_tpu_torch.train.common import auto_tile_config
from egogaussian_tpu_torch.train.static import _dp_frame_batch, _static_step
from tests import _torch_dist_workers as workers
from tests.test_torch_static import _jax_cameras

torch.set_num_threads(1)
CPU = torch.device("cpu")
MODES = ("std", "entropy", "label")
PARAMS = ("xyz", "log_scales", "quats", "opacity_logit", "features_dc", "label")


# every wait of these tests' ranks, and their whole run, ends here: a rank
# that stops answering fails its own test instead of holding the suite
RANK_LIMIT = datetime.timedelta(minutes=5)


def _gloo(fn, n_data, *args, n_scene=1):
    return spawn(fn, n_scene, n_data, "gloo", CPU, args=args, timeout=RANK_LIMIT)


@pytest.fixture(scope="module")
def problem():
    """tests/test_parallel.py's scene: 8 frames at 32x24, 60 Gaussians in a
    capacity of 128; the same frames and model in both packages."""
    vid = make_synthetic_video(CPU, width=32, height=24, n_bg=40, n_obj=12, frames_static=4,
                               frames_dynamic=2, seed=0)
    cams = [dataclasses.replace(c, gt_image=torch.round(c.gt_image * 255) / 255)
            for c in vid.cameras[:8]]
    rng = np.random.RandomState(0)
    jm = j_from_points(rng.randn(60, 3).astype(np.float32), rng.rand(60, 3).astype(np.float32),
                       capacity=128)
    fields = lambda x: {f.name: np.asarray(getattr(x, f.name))  # noqa: E731
                        for f in dataclasses.fields(x)}
    tm = from_jax_arrays(fields(jm.params), fields(jm.aux), CPU, sh_degree=jm.sh_degree)
    jb = j_readers.stack_cameras(_jax_cameras(cams))
    tb = stack_cameras(cams, CPU)
    return dict(jm=jm, jb=jb, jtile=j_auto_tile_config(jm, jb.camera(0)), tm=tm, tb=tb,
                ttile=auto_tile_config(tm, tb.camera(0)))


def test_mesh_coordinates_subgroups_replicate_and_shard_batch():
    """A 2x2 grid: rank = s * 2 + d; the data subgroup is the scene row,
    the scene subgroup the data column; replicate gives the row's first
    rank's tensors; shard_batch gives each data rank the rows of JAX's
    shard on the same device index."""
    rows = np.arange(12 * 2).reshape(12, 2)
    jmesh = j_make_mesh(n_data=2, devices=jax.devices()[:2])
    jax_blocks = [np.asarray(s.data).tolist() for s in sorted(
        j_shard_batch(jmesh, jnp.asarray(rows)).addressable_shards, key=lambda s: s.index)]
    out = _gloo(workers.mesh_layout, 2, rows, n_scene=2)
    for r, o in enumerate(out):
        s, d = divmod(r, 2)
        assert o["rank"] == r and o["coords"] == {"scene": s, "data": d}
        assert o["shape"] == {"scene": 2, "data": 2}
        assert o["ranks"] == {"data": [2 * s, 2 * s + 1], "scene": [d, 2 + d]}
        assert o["seen"] == o["ranks"]
        assert o["replica"] == [2.0 * s] * 3 and o["pair"] == [4.0 * s] * 3
        assert o["untouched"] == 7
        assert o["block"] == jax_blocks[d] == rows[6 * d:6 * d + 6].tolist()


def test_dp_frame_batch_rounding():
    class Mesh8:
        shape = {"scene": 1, "data": 8}

    assert _dp_frame_batch(1, None) == 1
    assert _dp_frame_batch(4, None) == 4
    assert _dp_frame_batch(1, Mesh8) == 8
    assert _dp_frame_batch(8, Mesh8) == 8
    assert _dp_frame_batch(9, Mesh8) == 16


@pytest.fixture(scope="module", params=[2, 4])
def dp_steps(request, problem):
    """Every mode's _dp_static_step on D gloo ranks, JAX's at the same D and
    the port's single step, all from the same state on frames 0-7."""
    n = request.param
    p = problem
    fidxs = list(range(8))
    ranks = _gloo(workers.dp_static_steps, n, p["tm"], adam_init(p["tm"].params), p["tb"],
                  fidxs, p["ttile"], Config().opt, MODES)
    jmesh = j_make_mesh(n_data=n, devices=jax.devices()[:n])
    jcfg = JConfig()
    single, jax_dp = {}, {}
    for mode in MODES:
        kw = dict(mode=mode, lambda_dssim=0.2, backend="tiled", label_lr=0.05)
        single[mode] = _static_step(p["tm"], adam_init(p["tm"].params), p["tb"], fidxs,
                                    p["tb"].hand_masks, 3, torch.zeros((), dtype=torch.int64),
                                    tile_config=p["ttile"], opt_cfg=Config().opt, **kw)
        jax_dp[mode] = j_dp_static_step(p["jm"], j_adam_init(p["jm"].params), p["jb"],
                                        jnp.arange(8, dtype=jnp.int32), p["jb"].hand_masks,
                                        jnp.int32(3), 0, mesh=jmesh, tile_config=p["jtile"],
                                        opt_cfg=jcfg.opt, **kw)
    return n, ranks, single, jax_dp


@pytest.mark.parametrize("mode", MODES)
def test_dp_static_step_matches_single_step_and_jax(dp_steps, mode):
    n, ranks, single, jax_dp = dp_steps
    r0 = ranks[0][mode]
    # every replica holds rank 0's bits
    for r in ranks[1:]:
        assert r[mode]["loss"] == r0["loss"] and r[mode]["drop"] == r0["drop"]
        for part in ("params", "aux"):
            for k, v in r0["model"][part].items():
                np.testing.assert_array_equal(r[mode]["model"][part][k], v, err_msg=k)
    radii = np.concatenate([r[mode]["radii"] for r in ranks])
    tm, _, tloss, tradii, tdrop = single[mode]
    jm, _, jloss, jradii, jdrop = jax_dp[mode]
    for ref_loss, ref_radii, ref_drop, ref in (
            (float(tloss), tradii.numpy(), int(tdrop),
             {k: v.numpy() for k, v in {**tm.params.as_dict(), **tm.aux.as_dict()}.items()}),
            (float(jloss), np.asarray(jradii), int(jdrop),
             {k: np.asarray(getattr(jm.params, k, None) if hasattr(jm.params, k)
                            else getattr(jm.aux, k)) for k in
              PARAMS + ("xyz_gradient_accum", "denom", "max_radii2d")})):
        np.testing.assert_allclose(r0["loss"], ref_loss, rtol=1e-5)
        np.testing.assert_array_equal(radii, ref_radii)
        assert r0["drop"] == ref_drop
        for k in PARAMS:
            np.testing.assert_allclose(r0["model"]["params"][k], ref[k], atol=2e-5, rtol=0,
                                       err_msg=f"D={n} {mode}: {k}")
        np.testing.assert_allclose(r0["model"]["aux"]["xyz_gradient_accum"],
                                   ref["xyz_gradient_accum"], atol=1e-5, rtol=0)
        for k in ("denom", "max_radii2d"):
            np.testing.assert_array_equal(r0["model"]["aux"][k], ref[k], err_msg=k)


def test_dp_train_step_matches_jax_eight_way(problem):
    """make_dp_train_step on 8 gloo ranks against JAX's 8-way step and its
    single-device step (tests/test_parallel.py::TestDataParallel)."""
    p = problem
    jcfg = JConfig()
    jlr = j_lr_tree(p["jm"].params, jnp.int32(1), jcfg.opt, 1.0, label_lr=0.0)
    idxs = jnp.arange(8, dtype=jnp.int32)
    jm1, _, jloss1 = jax.jit(j_dp_step)(p["jm"], j_adam_init(p["jm"].params), p["jb"], idxs, jlr)
    jmesh = j_make_mesh(n_data=8)
    jm8, _, jloss8 = j_make_dp_train_step(jmesh)(
        j_replicate(jmesh, p["jm"]), j_replicate(jmesh, j_adam_init(p["jm"].params)),
        j_replicate(jmesh, p["jb"]), j_shard_batch(jmesh, idxs), j_replicate(jmesh, jlr))
    lr = gaussian_lr_tree(1, Config().opt, 1.0, label_lr=0.0)
    out = _gloo(workers.dp_train_step, 8, p["tm"], adam_init(p["tm"].params), p["tb"],
                list(range(8)), lr)
    loss, xyz = out[0]
    for other_loss, other_xyz in out[1:]:
        assert other_loss == loss
        np.testing.assert_array_equal(other_xyz, xyz)
    for jloss, jm in ((jloss8, jm8), (jloss1, jm1)):
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        np.testing.assert_allclose(xyz, np.asarray(jm.params.xyz), atol=1e-5, rtol=0)


def test_train_background_on_two_ranks_resumes_like_unbroken(tmp_path):
    """JAX's tests/test_parallel.py::test_train_background_on_mesh schedule
    (densify in (2, 6], opacity reset every 4, here every 2 iterations
    densify) at frame batch 1, raised to 2 on the mesh, with a checkpoint
    every 5 iterations; the second run stops after the checkpoint of
    iteration 5 and is called again."""
    vid = make_synthetic_video(CPU, width=32, height=24, n_bg=40, n_obj=12, frames_static=4,
                               frames_dynamic=2, seed=0)
    cfg = Config()
    cfg.static_bg = dataclasses.replace(cfg.static_bg, std_train_iter=8, entropy_reg_iter=4,
                                        densify_from_iter=2, densify_until_iter=6)
    cfg.opt = dataclasses.replace(cfg.opt, densification_interval=2, opacity_reset_interval=4)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    out = _gloo(workers.background_resume, 2, vid.cameras, vid.points, vid.colors, cfg, a, b, 5)
    for part in ("params", "aux"):
        for k, v in out[0]["unbroken"][part].items():
            np.testing.assert_array_equal(out[0]["resumed"][part][k], v, err_msg=k)
            np.testing.assert_array_equal(out[1]["unbroken"][part][k], v, err_msg=k)
            np.testing.assert_array_equal(out[1]["resumed"][part][k], v, err_msg=k)
    assert np.isfinite(out[0]["unbroken"]["params"]["xyz"]).all()
    # rank 0 alone writes: checkpoints at 5 and 10, then the PLY, per run
    # (the stopped run wrote its checkpoint of 5 only)
    assert out[0]["writes_unbroken"] == {"ckpt": 2, "ply": 1}
    assert out[0]["writes_all"] == {"ckpt": 2 + 1 + 1, "ply": 2}
    assert out[1]["writes_all"] == {"ckpt": 0, "ply": 0}
    assert out[0]["files"] == ["ckpt_bg.npz", "static_bg.ply"]


@pytest.mark.parametrize("where", ["outside", "barrier"])
def test_ranks_that_stop_answering_fail_by_the_limit(where):
    """A rank that stops answering, outside any collective or with its peer
    waiting for it at a barrier, ends spawn at its timeout: the ranks are
    terminated and TimeoutError raised, long before the rank would wake."""
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="still running"):
        spawn(workers.stop_answering, 1, 2, "gloo", CPU, args=(where,),
              timeout=datetime.timedelta(seconds=4))
    assert time.perf_counter() - t0 < 120
