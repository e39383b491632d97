"""The lockstep stage drivers (parallel/scene_trainer.py) at S = 2 on two
tiny videos (64x48, seeds 0 and 1, 3 and 2 dynamic frames, different
capacities and extents) against each video's S = 1 run, which is the
single-scene trainer (train_static, ..., fine_tune_all are the drivers'
one-scene case), and the lockstep pipeline (cli/train.py train_videos)
against cli.train per video.

Every stage is held bit for bit, and the pipeline in every file byte for
byte: each op that mixes a scene's rows into a per-scene quantity (the
rigid object move x R^T + t, the pose's 4x4 / 3x3 products and its
gradient's sums over the Gaussians) runs per scene on the scene's own
rows through the one-scene call, and the covariance's extra rotation
sums its gradient over each scene's own rows apart, so a scene whose
capacity is below the stack's rounds as its own run does; scenes of
different crop windows take their losses over their own windows.
"""
import dataclasses

import numpy as np
import pytest
import torch

from egogaussian_tpu_torch.config import Config
from egogaussian_tpu_torch.data import make_synthetic_video, split_viewpoints_by_phase
from egogaussian_tpu_torch.models.gaussians import from_points
from egogaussian_tpu_torch.models.pose import pose_sequence_from_jax_arrays
from egogaussian_tpu_torch.parallel import scene_trainer as st

torch.set_num_threads(1)
CPU = torch.device("cpu")
FIELDS = ("xyz", "features_dc", "log_scales", "quats", "opacity_logit", "label")


@pytest.fixture(scope="module")
def videos():
    return [make_synthetic_video(CPU, width=64, height=48, n_bg=150, n_obj=40, frames_static=3,
                                 frames_dynamic=d, seed=s) for s, d in ((0, 3), (1, 2))]


def _cfg():
    cfg = Config()
    cfg.static = dataclasses.replace(cfg.static, std_train_iter=20, entropy_reg_iter=5,
                                     label_train_iter=6, densify_from_iter=4,
                                     densify_until_iter=15, rewind_frames=3, label_lr=0.05)
    cfg.static_bg = dataclasses.replace(cfg.static_bg, std_train_iter=15, entropy_reg_iter=5,
                                        densify_from_iter=4, densify_until_iter=12)
    cfg.opt = dataclasses.replace(cfg.opt, densification_interval=5, opacity_reset_interval=12,
                                  opacity_lr=0.5)
    cfg.coarse = dataclasses.replace(cfg.coarse, warm_up_iter=8, total_num_iter=14,
                                     densify_from_iter=9, densify_until_iter=13,
                                     densification_interval=4, opacity_reset_interval=1000)
    cfg.fine = dataclasses.replace(cfg.fine, total_num_iter=16, densify_from_iter=2,
                                   densify_until_iter=10, densification_interval=4,
                                   opacity_reset_interval=8)
    cfg.fine_all = dataclasses.replace(cfg.fine_all, total_num_iter=14, densify_from_iter=5,
                                       densify_until_iter=10, opacity_reset_interval=7)
    # a margin small enough that the 64x48 frames crop
    cfg.render = dataclasses.replace(cfg.render, pose_crop_margin=4)
    return cfg


def _groups(v):
    return (split_viewpoints_by_phase(v.cameras, v.static_phases),
            split_viewpoints_by_phase(v.cameras, v.dynamic_phases))


def _diff(a, b):
    """Largest parameter difference of two models of the same alive rows."""
    assert torch.equal(a.aux.alive, b.aux.alive) and a.capacity == b.capacity
    return max(float((getattr(a.params, f) - getattr(b.params, f)).abs().max()) for f in FIELDS)


def _object_model(v, capacity, extent):
    pts = v.gt_means[v.gt_is_object]
    m = from_points(pts, v.colors[v.gt_is_object], CPU, capacity=capacity,
                    spatial_lr_scale=extent)
    return dataclasses.replace(m, aux=dataclasses.replace(
        m.aux, is_object=m.aux.alive.to(torch.int32)))


def test_static_lockstep_equals_single_runs(videos):
    """Stage 1.0 of both videos in lockstep: every phase's model (densified
    and pruned per scene) and predicted masks bit for bit each video's
    train_static, each scene on its own RandomState stream."""
    cfg = _cfg()
    ins = [st.SceneInput(v.cameras, v.points, v.colors, _groups(v)[0], 4.0 + i, seed=i)
           for i, v in enumerate(videos)]
    both = st.train_static_scenes(ins, cfg, device=CPU)
    for i, sc in enumerate(ins):
        (one,) = [st.train_static_scenes([sc], cfg, device=CPU)]
        assert len(both[i]) == len(one[0])
        for a, b in zip(both[i], one[0]):
            assert _diff(a.model, b.model) == 0.0
            assert a.pred_masks.keys() == b.pred_masks.keys()
            assert all(np.array_equal(a.pred_masks[k], b.pred_masks[k]) for k in a.pred_masks)


def test_background_lockstep_equals_single_runs(videos):
    cfg = _cfg()
    ins = []
    for i, v in enumerate(videos):
        s, d = _groups(v)
        ins.append(st.SceneInput(v.cameras, v.points, v.colors, [], 4.0 + i, seed=i,
                                 train_frame_idxs=sorted({k for g in s + d for k in g})))
    both = st.train_background_scenes(ins, cfg, device=CPU)
    for i, sc in enumerate(ins):
        assert _diff(both[i], st.train_background_scenes([sc], cfg, device=CPU)[0]) == 0.0


def test_coarse_lockstep_matches_single_runs(videos):
    """Stage 2 of both videos slot by slot (video 0 solves one frame more),
    with object densification, crop windows and per-scene warm-up elision:
    the solved frames, poses and models bit for bit."""
    cfg = _cfg()
    ins = [st.CoarseSceneInput(v.cameras, _object_model(v, 128 + 64 * i, 4.0 + i), *_groups(v),
                               4.0 + i, seed=i) for i, v in enumerate(videos)]
    both = st.train_coarse_scenes(ins, cfg, device=CPU)
    for i, sc in enumerate(ins):
        seq, model, solved = st.train_coarse_scenes([sc], cfg, device=CPU)[0]
        assert both[i][2] == solved
        assert int(both[i][1].num_alive) > int(sc.obj_model.num_alive)  # splits ran
        assert _diff(both[i][1], model) == 0.0
        for f in ("translations", "rotations", "solved"):
            assert torch.equal(getattr(both[i][0], f), getattr(seq, f)), f


def _fine_inputs(videos, all_stage=False):
    out = []
    for i, v in enumerate(videos):
        s, d = _groups(v)
        deltas = v.gt_obj_deltas.astype(np.float32)
        rng = np.random.RandomState(5 + i)
        seq = pose_sequence_from_jax_arrays(
            deltas[:, :3, 3] + 0.02 * rng.randn(len(deltas), 3).astype(np.float32),
            deltas[:, :3, :3], np.ones(len(v.cameras), bool), CPU)
        obj = _object_model(v, 128 + 64 * i, 4.0 + i)
        if all_stage:
            bg = from_points(v.points[:150], v.colors[:150], CPU, capacity=512,
                             spatial_lr_scale=4.0 + i)
            out.append(st.FineAllSceneInput(v.cameras, obj, bg, seq, s, d, seed=i))
        else:
            out.append(st.FineSceneInput(v.cameras, obj, seq, s, d, 4.0 + i, seed=i))
    return out


def test_fine_lockstep_matches_single_runs(videos):
    cfg = _cfg()
    ins = _fine_inputs(videos)
    both = st.train_fine_scenes(ins, cfg, device=CPU)
    for i, sc in enumerate(ins):
        seq, model = st.train_fine_scenes([sc], cfg, device=CPU)[0]
        assert int(both[i][1].num_alive) > int(sc.obj_model.num_alive)  # splits ran
        assert _diff(both[i][1], model) == 0.0
        for f in ("translations", "rotations", "solved"):
            assert torch.equal(getattr(both[i][0], f), getattr(seq, f)), f


def test_fine_all_lockstep_equals_single_runs(videos):
    cfg = _cfg()
    ins = _fine_inputs(videos, all_stage=True)
    both = st.train_fine_all_scenes(ins, cfg, device=CPU)
    for i, sc in enumerate(ins):
        assert _diff(both[i], st.train_fine_all_scenes([sc], cfg, device=CPU)[0]) == 0.0


def test_lockstep_pipeline_equals_per_video_cli(tmp_path):
    """cli/train.py's train_videos (the pipeline in lockstep) over two
    exported videos with cli.train's flags against cli.train per video
    (seed i): the same file names, every file byte for byte but
    cfg_args.json (its own paths) and the metrics log (its own timings),
    and the same stage_end records."""
    from argparse import ArgumentParser

    from egogaussian_tpu_torch.cli.train import main as train_main
    from egogaussian_tpu_torch.cli.train import train_videos
    from egogaussian_tpu_torch.config import add_config_args, extract_config
    from egogaussian_tpu_torch.data.export_colmap import export_colmap_dataset
    from tests.test_torch_train_multi import SCHEDULE, _assert_equals_singles

    srcs = [export_colmap_dataset(
        make_synthetic_video(CPU, width=64, height=48, n_bg=150, n_obj=40, frames_static=3,
                             frames_dynamic=d, seed=s), str(tmp_path / f"video{s}"))
        for s, d in ((0, 3), (1, 2))]
    outs = [str(tmp_path / f"lock{i}") for i in range(2)]
    parser = ArgumentParser()
    add_config_args(parser)
    cfgs = [extract_config(parser.parse_args(["-s", src, "-m", out] + SCHEDULE))
            for src, out in zip(srcs, outs)]
    train_videos(cfgs, [0, 1], resume=False, lpips_fn=None, checkpoint_every=0, device=CPU)
    singles = [str(tmp_path / f"single{i}") for i in range(2)]
    for i, (src, single) in enumerate(zip(srcs, singles)):
        train_main(["-s", src, "-m", single, "--seed", str(i), "--device", "cpu"] + SCHEDULE)
    _assert_equals_singles(srcs, outs, singles)


@pytest.mark.parametrize("compositor", ["tilegrid", "stream"])
def test_pose_step_lanes_of_other_windows_equal_their_own_steps(videos, compositor):
    """pose_scenes_step (stages 2 and 3's shared step) at S = 2 with lanes
    that differ in capacity (128 and 192 rows) and in window (a crop beside
    the full frame), through either compositor pair: each lane's loss,
    model, Adam state, pose and pose Adam state bit for bit its own
    pose_step, as a lockstep lane must (each lane's loss over its own
    window, its pose's products and gradient sums over its own rows)."""
    from egogaussian_tpu_torch.data import stack_cameras
    from egogaussian_tpu_torch.models.optim import adam_init
    from egogaussian_tpu_torch.models.pose import identity_pose
    from egogaussian_tpu_torch.parallel.multi_scene import stack_scenes, unstack_scenes
    from egogaussian_tpu_torch.render.tiled import scene_caps
    from egogaussian_tpu_torch.train.coarse_pose import pose_scenes_step, pose_step
    from egogaussian_tpu_torch.train.common import auto_tile_config, pose_crop_size

    cfg = _cfg()
    lanes = []
    for i, v in enumerate(videos):
        model = _object_model(v, 128 + 64 * i, 4.0 + i)
        batch = stack_cameras(v.cameras, CPU)
        f = v.dynamic_phases[0][0] + 1
        pose = dataclasses.replace(identity_pose(CPU), translation=torch.tensor(
            [0.01, -0.02, 0.015 * (i + 1)]))
        tcfg = dataclasses.replace(auto_tile_config(model, batch.camera(0), tile_size=16),
                                   compositor=compositor)
        crop = pose_crop_size(batch, cfg, "coarse") if i == 0 else None
        lanes.append(dict(model=model, batch=batch, f=f, pose=pose, tcfg=tcfg, crop=crop))
    assert lanes[0]["crop"] is not None
    w, h = lanes[0]["batch"].width, lanes[0]["batch"].height
    eye4, eye3 = torch.eye(4), torch.eye(3)
    lrs = {k: 1e-3 for k in FIELDS + ("features_rest",)}
    kw = dict(lambda_l1_alpha=0.1, backend="cuda")
    drop = torch.zeros((), dtype=torch.int64)
    singles = []
    for ln in lanes:
        singles.append(pose_step(
            ln["model"], adam_init(ln["model"].params), ln["pose"], adam_init(ln["pose"]),
            ln["batch"], ln["f"], eye4, eye3, lrs, 1e-3, 2e-3, True, drop, True,
            tile_config=ln["tcfg"], crop_size=ln["crop"],
            crop_max=torch.zeros((3,), dtype=torch.int32), **kw))
    caps = scene_caps([ln["tcfg"] for ln in lanes],
                      [ln["crop"] if ln["crop"] is not None else (w, h) for ln in lanes], CPU,
                      192)
    models = stack_scenes([ln["model"] for ln in lanes])
    out = pose_scenes_step(
        models, stack_scenes([adam_init(ln["model"].params) for ln in lanes]),
        stack_scenes([ln["pose"] for ln in lanes]),
        stack_scenes([adam_init(ln["pose"]) for ln in lanes]),
        stack_scenes([ln["batch"] for ln in lanes]), torch.tensor([ln["f"] for ln in lanes]),
        torch.stack([eye4, eye4]), torch.stack([eye3, eye3]), lrs, 1e-3, 2e-3, True,
        drop.repeat(2), [True, True], caps=caps, crop=True,
        crop_max=torch.zeros((2, 3), dtype=torch.int32), **kw)
    caps_n = [128, 192]
    m2, o2 = unstack_scenes(out[0], 2, caps_n), unstack_scenes(out[1], 2, caps_n)
    p2, po2 = unstack_scenes(out[2], 2), unstack_scenes(out[3], 2)
    for j, one in enumerate(singles):
        assert torch.equal(out[4][j], one[4])  # loss
        assert _diff(m2[j], one[0]) == 0.0
        for a, b in ((p2[j], one[2]), (po2[j].mu, one[3].mu), (po2[j].nu, one[3].nu),
                     (o2[j].mu, one[1].mu), (o2[j].nu, one[1].nu)):
            for f in dataclasses.fields(a):
                assert torch.equal(getattr(a, f.name), getattr(b, f.name)), (j, f.name)
