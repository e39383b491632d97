"""The lockstep stage drivers (parallel/scene_trainer.py) at S = 2 on two
tiny videos (64x48, seeds 0 and 1, 3 and 2 dynamic frames, different
capacities and extents) against each video's S = 1 run, which is the
single-scene trainer (train_static, ..., fine_tune_all are the drivers'
one-scene case), and the lockstep pipeline (cli/train.py train_videos)
against cli.train per video.

Stages 1.0, 1.2 and 5 are held bit for bit. Stages 2 and 3 within a bound:
when a scene's capacity is below the stack's, its Gaussian rows are padded
with dead rows, and the rigid object move x R^T + t (render_gaussians'
pose) is then a batched matrix product over more rows, whose float32
rounding on the CPU depends on the row count (MKL picks its kernel by
shape); the pose's rotation gradient, a reduction over the rows, moves
with it, and Adam carries the difference. Each bound sits beside the
largest difference measured in a CPU run of this file:
  * stage 2 (densify and crop on): parameters 1e-4 (measured 2.6e-6,
    opacity logits), pose deltas 1e-6 (measured 1.2e-10, rotations);
  * stage 3: parameters 1e-4 (measured 1.4e-6, opacity logits), pose
    deltas 1e-5 (measured 1.8e-7, rotations);
  * the pipeline at test_torch_train_multi's schedule: every file byte for
    byte but video 1's pose files and the stage-3 PLY trained from them,
    whose poses lie within 1e-6 (measured 5.8e-11) and whose stage-6
    scores are equal to 1e-4 dB.
"""
import dataclasses
import filecmp
import os

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
    the solved frames and elided counts equal, poses and models within the
    module docstring's bounds."""
    cfg = _cfg()
    ins = [st.CoarseSceneInput(v.cameras, _object_model(v, 128 + 64 * i, 4.0 + i), *_groups(v),
                               4.0 + i, seed=i) for i, v in enumerate(videos)]
    both = st.train_coarse_scenes(ins, cfg, device=CPU)
    for i, sc in enumerate(ins):
        seq, model, solved = st.train_coarse_scenes([sc], cfg, device=CPU)[0]
        assert both[i][2] == solved
        assert int(both[i][1].num_alive) > int(sc.obj_model.num_alive)  # splits ran
        assert _diff(both[i][1], model) <= 1e-4
        for f in ("translations", "rotations"):
            assert float((getattr(both[i][0], f) - getattr(seq, f)).abs().max()) <= 1e-6
        assert torch.equal(both[i][0].solved, seq.solved)


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
        assert _diff(both[i][1], model) <= 1e-4
        assert float((both[i][0].translations - seq.translations).abs().max()) <= 1e-5
        assert float((both[i][0].rotations - seq.rotations).abs().max()) <= 1e-5


def test_fine_all_lockstep_equals_single_runs(videos):
    cfg = _cfg()
    ins = _fine_inputs(videos, all_stage=True)
    both = st.train_fine_all_scenes(ins, cfg, device=CPU)
    for i, sc in enumerate(ins):
        assert _diff(both[i], st.train_fine_all_scenes([sc], cfg, device=CPU)[0]) == 0.0


def test_lockstep_pipeline_equals_per_video_cli(tmp_path):
    """cli/train.py's train_videos (the pipeline in lockstep) over two
    exported videos with cli.train's flags against cli.train per video
    (seed i): the same file names; every file byte for byte except video
    1's pose-dependent ones (see the module docstring)."""
    from argparse import ArgumentParser

    from egogaussian_tpu_torch.cli.train import main as train_main
    from egogaussian_tpu_torch.cli.train import train_videos
    from egogaussian_tpu_torch.config import add_config_args, extract_config
    from egogaussian_tpu_torch.data.export_colmap import export_colmap_dataset
    from tests.test_torch_train_multi import SCHEDULE, _scores, _tree

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
    pose_files = {"coarse/obj_pose_sequence.npz", "fine_obj/from-coarse/obj_pose_sequence.npz",
                  "fine_obj/from-static/obj_pose_sequence.npz",
                  "fine_obj/from-static/gaussians_fine.ply",
                  "fine_obj/from-coarse/gaussians_fine.ply",
                  "interpolate_pose_coarse/obj_pose_sequence.npz",
                  "interpolate_pose_static/obj_pose_sequence.npz"}
    for i, src in enumerate(srcs):
        single = str(tmp_path / f"single{i}")
        train_main(["-s", src, "-m", single, "--seed", str(i), "--device", "cpu"] + SCHEDULE)
        assert _tree(outs[i]) == _tree(single)
        for f in _tree(single):
            if f == "cfg_args.json" or f.startswith("logs"):
                continue
            same = filecmp.cmp(os.path.join(single, f), os.path.join(outs[i], f), shallow=False)
            if i == 0:
                assert same, f
            elif not same:
                assert f in pose_files or f.startswith(("fine_all", "evaluation")), f
                if f.endswith(".npz"):
                    a, b = np.load(os.path.join(single, f)), np.load(os.path.join(outs[i], f))
                    for k in ("translations", "rotations"):
                        assert np.abs(a[k] - b[k]).max() <= 1e-6, (f, k)
        sa = _scores(os.path.join(single, "evaluation", "results.txt"))
        sb = _scores(os.path.join(outs[i], "evaluation", "results.txt"))
        for bucket in sa:
            assert abs(sa[bucket]["psnr"] - sb[bucket]["psnr"]) <= 1e-4
