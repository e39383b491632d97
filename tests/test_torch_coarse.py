"""Stage 2 (coarse object pose) of the port against the JAX package, on the
64x48 synthetic video built once with the port and handed to both
packages as the same arrays:

  * `pose_step` with and without a crop window, with and without the
    parameter backward: loss, updated pose, parameters, densification
    statistics and the crop / drop counters;
  * `estimate_coarse_obj_pose` over a shortened schedule (warm-up,
    densify window with object densification and an object opacity reset,
    crop growth), with the JAX split noise injected: pose sequence, solved
    set, alive count and parameters;
  * within the port, the warm-up no-op elision changes nothing, bit for bit;
  * drop-triggered capacity regrowth grows what JAX grows and keeps the
    caller's kernel flavor (compositor, bwd_exact_total).

The JAX side runs its tile-grid Pallas kernels in interpret mode; the port
its tile-grid plain twins.

Tolerances. One step: the two compositors differ by float32
reassociation only (tests/test_torch_composite.py), so the loss agrees
to rtol 1e-5 and the one-step updates to atol 1e-6 (pose, params; Adam's
first step moves each value by about its learning rate whatever the
gradient's size, so the float noise of a near-zero gradient shows up as
up to lr in quaternions: atol 1e-3, the step's lr). The stage: 102 real
Adam steps over four frames, measured at 2e-8 (pose translation), 1e-7
(rotation) and 4e-6 (parameters) from the JAX run: bounds 1e-6 on the
pose and 2e-5 on the parameters.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egogaussian_tpu.config import Config as JConfig
from egogaussian_tpu.data import readers as j_readers
from egogaussian_tpu.models import adam_init as j_adam_init
from egogaussian_tpu.models import from_points as j_from_points
from egogaussian_tpu.models.pose import identity_pose as j_identity_pose
from egogaussian_tpu.render.tiled import TileConfig as JTileConfig
from egogaussian_tpu.train.coarse_pose import estimate_coarse_obj_pose as j_estimate
from egogaussian_tpu.train.coarse_pose import pose_step as j_pose_step
from egogaussian_tpu_torch.config import Config
from egogaussian_tpu_torch.data import make_synthetic_video, split_viewpoints_by_phase
from egogaussian_tpu_torch.data import readers as t_readers
from egogaussian_tpu_torch.models.gaussians import from_jax_arrays
from egogaussian_tpu_torch.models.optim import adam_init
from egogaussian_tpu_torch.models.pose import identity_pose
from egogaussian_tpu_torch.render.tiled import TileConfig
from egogaussian_tpu_torch.train.coarse_pose import estimate_coarse_obj_pose, pose_step
from egogaussian_tpu_torch.utils.logging import MetricsLogger, set_active_logger
from tests.test_torch_model import _jax_split_noise
from tests.test_torch_static import _jax_cameras

torch.set_num_threads(1)
CPU = torch.device("cpu")
TILE = dict(tile_size=16, max_pairs=8192, max_per_tile=256)


@pytest.fixture(scope="module")
def video():
    return make_synthetic_video(CPU, width=64, height=48, n_bg=150, n_obj=40,
                                frames_static=4, frames_dynamic=3)


def _jax_object_model(video, capacity=128):
    """The GT object Gaussians (is_object = 1) at their rest pose."""
    pts = video.gt_means[video.gt_is_object]
    m = j_from_points(pts, video.colors[video.gt_is_object], capacity=capacity)
    n = len(pts)
    params = dataclasses.replace(
        m.params, log_scales=m.params.log_scales.at[:n].set(np.log(0.09)),
        opacity_logit=m.params.opacity_logit.at[:n].set(float(np.log(0.95 / 0.05))))
    aux = dataclasses.replace(m.aux, is_object=jnp.where(jnp.arange(capacity) < n, 1, 0))
    return dataclasses.replace(m, params=params, aux=aux)


def _port_model(jm):
    def fields(x):
        return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}

    return from_jax_arrays(fields(jm.params), fields(jm.aux), CPU,
                           spatial_lr_scale=jm.spatial_lr_scale)


def _close(t, j, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j), atol=atol, rtol=rtol,
                               err_msg=msg)


@pytest.mark.parametrize("grad_params", [True, False])
@pytest.mark.parametrize("crop_size", [None, (48, 32)])
def test_pose_step_matches_jax(video, crop_size, grad_params):
    jm = _jax_object_model(video)
    jb = j_readers.stack_cameras(_jax_cameras(video.cameras))
    tb = t_readers.stack_cameras(video.cameras, CPU)
    rng = np.random.RandomState(3)
    ang = 0.1
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                 np.float32)
    fixed_T = np.eye(4, dtype=np.float32)
    fixed_T[:3, :3] = R
    fixed_T[:3, 3] = rng.randn(3).astype(np.float32) * 0.05
    lr = 1e-3
    crop_max = np.zeros(3, np.int32) if crop_size else 0
    jout = j_pose_step(
        jm, j_adam_init(jm.params), j_identity_pose(), j_adam_init(j_identity_pose()), jb,
        jnp.int32(5), jnp.asarray(fixed_T), jnp.asarray(R),
        jax.tree_util.tree_map(lambda x: jnp.float32(lr), jm.params),
        jnp.float32(1e-2), jnp.float32(1e-2), jnp.asarray(True), jnp.int32(0),
        train_pose=True, grad_params=grad_params, lambda_l1_alpha=0.1, backend="pallas",
        tile_config=JTileConfig(**TILE), crop_size=crop_size, crop_max=jnp.asarray(crop_max))
    tm = _port_model(jm)
    pose = identity_pose()
    tout = pose_step(
        tm, adam_init(tm.params), pose, adam_init(pose), tb, 5, torch.as_tensor(fixed_T),
        torch.as_tensor(R), {k: lr for k in tm.params.as_dict()}, 1e-2, 1e-2, True,
        torch.zeros((), dtype=torch.int64), train_pose=True, grad_params=grad_params,
        lambda_l1_alpha=0.1, backend="cuda", tile_config=TileConfig(**TILE),
        crop_size=crop_size, crop_max=torch.as_tensor(crop_max))
    (jm2, _, jpose, jpopt, jloss, jradii, jdrop, jcrop) = jout
    (tm2, topt, tpose, tpopt, tloss, tradii, tdrop, tcrop) = tout
    _close(tloss, jloss, 0, 1e-5, "loss")
    np.testing.assert_array_equal(tradii.numpy(), np.asarray(jradii))
    assert int(tdrop) == int(jdrop) == 0
    np.testing.assert_array_equal(tcrop.numpy(), np.asarray(jcrop))
    if crop_size:
        assert int(tcrop[0]) > 0  # this window is small enough to count escapes
    _close(tpose.translation, jpose.translation, 1e-6, msg="pose translation")
    _close(tpose.rot6d, jpose.rot6d, 1e-6, msg="pose rot6d")
    _close(tpopt.nu.translation, jpopt.nu.translation, 1e-12, 1e-3, "pose moment")
    for f in tm2.params.as_dict():
        atol = 1e-3 if f == "quats" else 1e-6
        _close(getattr(tm2.params, f), getattr(jm2.params, f), atol, msg=f)
    _close(tm2.aux.xyz_gradient_accum, jm2.aux.xyz_gradient_accum, 1e-7, 1e-3, "stats")
    np.testing.assert_array_equal(tm2.aux.denom.numpy(), np.asarray(jm2.aux.denom))
    moved = (tm2.params.xyz != tm.params.xyz).any()
    assert bool(moved) == grad_params and int(topt.count) == 1


@pytest.mark.parametrize("flavor", [dict(bwd_exact_total=True), dict(compositor="stream")])
def test_regrowth_keeps_kernel_flavors(video, flavor):
    """Drop-triggered regrowth re-estimates only the capacity fields, as
    the JAX helper does: the same grown capacities, and the caller's
    tile size and kernel flavor survive it."""
    from egogaussian_tpu.train.common import maybe_regrow_tile_config as j_regrow
    from egogaussian_tpu_torch.train.common import maybe_regrow_tile_config

    jm = _jax_object_model(video)
    kw = dict(max_pairs=256, max_per_tile=16, max_slots=256, tile_size=16, **flavor)
    jcfg, jlast, jchanged = j_regrow(jm, _jax_cameras(video.cameras)[5], JTileConfig(**kw),
                                     jnp.int32(10_000), 0, "test")
    tcfg, tlast, tchanged = maybe_regrow_tile_config(
        _port_model(jm), video.cameras[5], TileConfig(**kw),
        torch.tensor(10_000), 0, "test")
    assert tchanged and jchanged and tlast == jlast == 10_000
    for f in ("max_pairs", "max_per_tile", "max_slots", "tile_size", "compositor",
              "bwd_exact_total"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.max_pairs > kw["max_pairs"]
    assert all(getattr(tcfg, k) == v for k, v in flavor.items())
    # nothing dropped since the last check: no regrowth
    assert maybe_regrow_tile_config(_port_model(jm), video.cameras[5], tcfg,
                                    torch.tensor(10_000), 10_000, "test") == (tcfg, 10_000, False)


def _coarse_cfg(cfg):
    cfg.coarse = dataclasses.replace(
        cfg.coarse, warm_up_iter=30, total_num_iter=40, densify_from_iter=32,
        densify_until_iter=39, densification_interval=4, opacity_reset_interval=36,
        densify_grad_threshold=2e-4)
    # a margin small enough that the 64x48 frames crop (rows only)
    cfg.render = dataclasses.replace(cfg.render, pose_crop_margin=4)
    return cfg


def _groups(video):
    return (split_viewpoints_by_phase(video.cameras, video.static_phases),
            split_viewpoints_by_phase(video.cameras, video.dynamic_phases))


def _with_stage_end(run, log_dir):
    """run() under a metrics logger writing to log_dir; returns its result
    and the stage's closing record (event "stage_end")."""
    logger = MetricsLogger(log_dir=str(log_dir))
    set_active_logger(logger)
    try:
        out = run()
    finally:
        set_active_logger(None)
        logger.close()
    with open(log_dir / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    return out, [r for r in records if r.get("event") == "stage_end"][-1]


def test_estimate_coarse_obj_pose_matches_jax(video, tmp_path):
    static_g, dyn_g = _groups(video)
    jm = _jax_object_model(video)
    seq_j, mj, solved_j = j_estimate(_jax_cameras(video.cameras), jm, _coarse_cfg(JConfig()),
                                     static_g, dyn_g, 4.0)
    keys = {}

    def jax_noise(frame, capacity):
        keys.setdefault(frame, jax.random.PRNGKey(frame))  # seed 0: PRNGKey(0*1000 + frame)
        keys[frame], sub = jax.random.split(keys[frame])
        return torch.as_tensor(_jax_split_noise(sub, capacity))

    (seq_t, mt, solved_t), stats = _with_stage_end(lambda: estimate_coarse_obj_pose(
        video.cameras, _port_model(jm), _coarse_cfg(Config()), static_g, dyn_g, 4.0,
        device=CPU, densify_noise=jax_noise), tmp_path)
    assert solved_t == solved_j and len(solved_t) == len(dyn_g[0]) + 1
    assert len(keys) == len(solved_t)  # every frame densified
    # the window starts at 64x32 and grows (here to the full frame)
    assert stats["crop_size_initial"] == [64, 32] and stats["dropped_pairs"] == 0
    assert stats["elided"] > 0 and stats["steps"] + stats["elided"] == 40 * len(solved_t)
    np.testing.assert_array_equal(seq_t.solved.numpy(), np.asarray(seq_j.solved))
    _close(seq_t.translations, seq_j.translations, 1e-6, msg="translations")
    _close(seq_t.rotations, seq_j.rotations, 1e-6, msg="rotations")
    assert float(seq_t.translations.abs().max()) > 1e-4  # the pose moved
    assert mt.capacity == mj.capacity
    np.testing.assert_array_equal(mt.aux.alive.numpy(), np.asarray(mj.aux.alive))
    assert int(mt.num_alive) > int(jm.num_alive)  # object densification ran
    alive = mt.aux.alive.numpy()
    for f in ("xyz", "features_dc", "log_scales", "opacity_logit", "quats"):
        _close(getattr(mt.params, f)[alive], np.asarray(getattr(mj.params, f))[alive], 2e-5,
               msg=f)


def test_noop_elision_is_bit_exact(video, tmp_path):
    """Elided warm-up iterations change nothing but the Adam count, which
    the next real step advances: equal outputs, not close ones."""
    static_g, dyn_g = _groups(video)
    cfg = _coarse_cfg(Config())
    runs = []
    for skip in (False, True):
        out, stats = _with_stage_end(lambda: estimate_coarse_obj_pose(
            video.cameras, _port_model(_jax_object_model(video)), cfg, static_g, dyn_g, 4.0,
            device=CPU, skip_noop_warmup=skip), tmp_path / f"skip{skip}")
        runs.append(out + (stats,))
    (seq_a, m_a, s_a, st_a), (seq_b, m_b, s_b, st_b) = runs
    assert st_a["elided"] == 0 and st_b["elided"] > 0
    assert st_a["steps"] == st_b["steps"] + st_b["elided"]
    assert s_a == s_b
    for f in ("translations", "rotations", "solved"):
        assert torch.equal(getattr(seq_a, f), getattr(seq_b, f)), f
    for f, v in m_a.params.as_dict().items():
        assert torch.equal(v, getattr(m_b.params, f)), f
    assert torch.equal(m_a.aux.alive, m_b.aux.alive)


def test_estimate_writes_pose_npz_and_rejects_checkpoints(video, tmp_path):
    from egogaussian_tpu.models.pose import load_pose_sequence as j_load

    static_g, dyn_g = _groups(video)
    cfg = _coarse_cfg(Config())
    cfg.coarse = dataclasses.replace(cfg.coarse, total_num_iter=6, warm_up_iter=4,
                                     densify_from_iter=100, densify_until_iter=0)
    tm = _port_model(_jax_object_model(video))
    seq, _, solved = estimate_coarse_obj_pose(video.cameras, tm, cfg, static_g, dyn_g, 4.0,
                                              save_dir=str(tmp_path), device=CPU)
    back, names = j_load(str(tmp_path / "obj_pose_sequence.npz"))
    assert names == [c.image_name for c in video.cameras]
    np.testing.assert_array_equal(np.asarray(back.solved), seq.solved.numpy())
    np.testing.assert_array_equal(np.asarray(back.translations), seq.translations.numpy())
    assert (tmp_path / "ply" / "gaussians_final.ply").exists()
    # checkpoint_every > 0 saves after every solved frame; a second call on
    # the same directory finds every frame solved and trains nothing
    ck = tmp_path / "ckpt"
    seq1, m1, solved1 = estimate_coarse_obj_pose(video.cameras, tm, cfg, static_g, dyn_g, 4.0,
                                                 save_dir=str(ck), device=CPU,
                                                 checkpoint_every=1)
    assert (ck / "ckpt_coarse.npz").exists()
    steps = []
    seq2, m2, solved2 = estimate_coarse_obj_pose(
        video.cameras, tm, cfg, static_g, dyn_g, 4.0, save_dir=str(ck), device=CPU,
        checkpoint_every=1, on_step=lambda f, it, loss: steps.append(f))
    assert not steps and solved2 == solved1 == solved
    assert torch.equal(seq2.translations, seq1.translations)
    assert torch.equal(m2.params.xyz, m1.params.xyz)
    if not torch.cuda.is_available():
        # no device means the card; without one torch raises its own error
        # (no silent CPU fallback)
        with pytest.raises((AssertionError, RuntimeError), match="CUDA|GPU|NVIDIA"):
            estimate_coarse_obj_pose(video.cameras, tm, cfg, static_g, dyn_g, 4.0)
