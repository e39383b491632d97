"""The slice as a whole: stage-1.0 `train_static` of the port against the JAX
package's on the same tiny synthetic video, and the port alone through two
densify intervals.

The cross-package run covers all three loss modes (std, entropy, label),
the entropy-end prune and the predicted masks, with densification off (its
split noise is drawn differently in each package; test_torch_model.py
checks densify with the JAX draw injected). Tolerance: after 22 Adam steps
the float32 reassociation differences of the two compositors stay ~1e-5 on
every field but the quaternions: from_points makes isotropic Gaussians,
whose true quaternion gradient is zero, so Adam normalizes rounding noise
into steps of up to rotation_lr each; their bound is
rotation_lr * iterations.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from egogaussian_tpu.config import Config as JConfig
from egogaussian_tpu.data import readers as j_readers
from egogaussian_tpu.render.camera import Camera as JCamera
from egogaussian_tpu.train.static import train_static as j_train_static
from egogaussian_tpu_torch.parallel import scene_trainer
from egogaussian_tpu_torch.config import Config
from egogaussian_tpu_torch.data import make_synthetic_video, split_viewpoints_by_phase
from egogaussian_tpu_torch.data import readers as t_readers
from egogaussian_tpu_torch import pipeline
from egogaussian_tpu_torch.cli import train as cli_train
from egogaussian_tpu_torch.data.readers import SceneData
from egogaussian_tpu_torch.models.gaussians import from_points
from egogaussian_tpu_torch.models.pose import empty_pose_sequence
from egogaussian_tpu_torch.train import coarse_pose, fine_all, fine_obj, static
from egogaussian_tpu_torch.train.static import train_static
from egogaussian_tpu_torch.utils.logging import MetricsLogger, active_logger

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _schedule(cfg):
    cfg.static = dataclasses.replace(
        cfg.static, std_train_iter=12, entropy_reg_iter=4, label_train_iter=6,
        densify_from_iter=1000, densify_until_iter=0, rewind_frames=3, label_lr=0.3)
    # raised so some opacities pass the entropy-end prune (0.5) in 16 steps
    cfg.opt = dataclasses.replace(cfg.opt, opacity_lr=0.5)
    return cfg


def _jax_cameras(cams):
    """The port's synthetic frames as JAX cameras (same arrays)."""
    out = []
    for c in cams:
        vm = c.viewmat.numpy()
        out.append(JCamera.from_colmap(
            vm[:3, :3], vm[:3, 3], float(c.fx), float(c.fy), c.width, c.height,
            image_name=c.image_name, cx=float(c.cx), cy=float(c.cy),
            gt_image=c.gt_image.numpy(), hand_mask=c.hand_mask.numpy(),
            obj_mask=None if c.obj_mask is None else c.obj_mask.numpy()))
    return out


def test_frame_batch_and_phase_split_match_jax():
    """uint8 planes (8-bit images, binary masks), a missing object mask, the
    /255 decode, the phase split and dilate_mask: EQUAL to the JAX
    package's (integer storage, exact decode)."""
    vid = make_synthetic_video(CPU, width=32, height=24, n_bg=60, n_obj=10,
                               frames_static=2, frames_dynamic=1)
    cams = [dataclasses.replace(c, gt_image=torch.round(c.gt_image * 255) / 255)
            for c in vid.cameras]
    cams[1] = dataclasses.replace(cams[1], obj_mask=None)
    jcams = _jax_cameras(cams)
    tb, jb = t_readers.stack_cameras(cams, CPU), j_readers.stack_cameras(jcams)
    assert tb.images.dtype == tb.hand_masks.dtype == tb.obj_masks.dtype == torch.uint8
    for f in ("images", "hand_masks", "obj_masks", "obj_mask_valid"):
        np.testing.assert_array_equal(np.asarray(getattr(tb, f)), np.asarray(getattr(jb, f)),
                                      err_msg=f)
    for f in range(len(cams)):
        for a, b in zip(tb.frame(f)[1:], jb.frame(f)[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    phases = vid.static_phases + vid.dynamic_phases
    assert (split_viewpoints_by_phase(cams, phases)
            == j_readers.split_viewpoints_by_phase(jcams, phases))
    mask = vid.cameras[0].obj_mask.numpy()
    assert mask.sum() > 0
    np.testing.assert_array_equal(t_readers.dilate_mask(mask, 3),
                                  j_readers.dilate_mask(mask, 3))


def test_train_static_matches_jax():
    vid = make_synthetic_video(CPU, width=64, height=48, n_bg=150, n_obj=40,
                               frames_static=4, frames_dynamic=3)
    groups = split_viewpoints_by_phase(vid.cameras, vid.static_phases)
    jcfg, tcfg = _schedule(JConfig()), _schedule(Config())
    rj = j_train_static(_jax_cameras(vid.cameras), vid.points, vid.colors, jcfg, groups, 4.0,
                        first_phase_only=True)[0]
    rt = train_static(vid.cameras, vid.points, vid.colors, tcfg, groups, 4.0,
                      first_phase_only=True, device=CPU)[0]

    alive = np.asarray(rj.model.aux.alive)
    np.testing.assert_array_equal(rt.model.aux.alive.numpy(), alive)
    assert 0 < alive.sum() < len(vid.points)  # the prune ran and kept some
    n = len(vid.points)
    iters = 22
    tol = dict(xyz=1e-5, features_dc=1e-5, log_scales=1e-4, opacity_logit=1e-4, label=1e-5,
               quats=tcfg.opt.rotation_lr * iters)
    for f, atol in tol.items():
        a = np.asarray(getattr(rj.model.params, f))[:n]
        b = getattr(rt.model.params, f).numpy()[:n]
        np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=f)
    np.testing.assert_array_equal(rt.model.aux.is_object.numpy(),
                                  np.asarray(rj.model.aux.is_object))
    assert rt.pred_masks.keys() == rj.pred_masks.keys()
    assert sum(m.sum() for m in rj.pred_masks.values()) > 0  # labels segment
    for k in rj.pred_masks:
        np.testing.assert_array_equal(rt.pred_masks[k], rj.pred_masks[k], err_msg=k)


def test_port_trains_through_two_densify_intervals(tmp_path):
    vid = make_synthetic_video(CPU, width=64, height=48, n_bg=150, n_obj=40,
                               frames_static=4, frames_dynamic=3)
    cfg = Config()
    cfg.static = dataclasses.replace(
        cfg.static, std_train_iter=30, entropy_reg_iter=5, label_train_iter=5,
        densify_from_iter=5, densify_until_iter=20, rewind_frames=3)
    cfg.opt = dataclasses.replace(cfg.opt, densification_interval=10,
                                  opacity_reset_interval=1000, densify_grad_threshold=1e-4)
    groups = split_viewpoints_by_phase(vid.cameras, vid.static_phases)
    losses = []
    with active_logger(MetricsLogger(str(tmp_path / "logs"))):
        res = train_static(vid.cameras, vid.points, vid.colors, cfg, groups, 4.0,
                           save_dir=str(tmp_path), first_phase_only=True, device=CPU,
                           on_step=lambda it, mode, loss: losses.append(float(loss)))[0]
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        recs = {r["step"]: r for r in map(json.loads, f)}
    # logged before each interval's densify: it 10 = init, 20/30 = after
    assert recs[10]["alive"] == len(vid.points)
    assert recs[20]["alive"] > recs[10]["alive"]
    assert recs[30]["alive"] > recs[20]["alive"]
    assert all(r["dropped_pairs"] == 0 for r in recs.values())
    assert res.dropped_pairs == 0
    assert np.isfinite(losses).all() and len(losses) == 40
    for v in res.model.params.as_dict().values():
        assert torch.isfinite(v).all()
    for name in ("static_phase0.ply", "static_phase0_obj.ply", "static_phase0_bg.ply"):
        assert os.path.getsize(tmp_path / "ply" / name) > 0
    assert len(os.listdir(tmp_path / "obj_masks")) == len(groups[0])


def test_train_static_tiled_backend_matches_cuda():
    """train_static(backend="tiled") (the JAX package's `--backend tiled`)
    runs the windowed twins with the auto tile config and lands where the
    default ("auto" -> "cuda", held against JAX above) lands, with the same
    tolerances: the two compositors differ by float32 reassociation only."""
    vid = make_synthetic_video(CPU, width=64, height=48, n_bg=150, n_obj=40,
                               frames_static=4, frames_dynamic=3)
    groups = split_viewpoints_by_phase(vid.cameras, vid.static_phases)
    cfg = _schedule(Config())
    rc = train_static(vid.cameras, vid.points, vid.colors, cfg, groups, 4.0,
                      first_phase_only=True, device=CPU)[0]
    rt = train_static(vid.cameras, vid.points, vid.colors, cfg, groups, 4.0,
                      first_phase_only=True, device=CPU, backend="tiled")[0]
    np.testing.assert_array_equal(rt.model.aux.alive.numpy(), rc.model.aux.alive.numpy())
    iters = 22
    tol = dict(xyz=1e-5, features_dc=1e-5, log_scales=1e-4, opacity_logit=1e-4, label=1e-5,
               quats=cfg.opt.rotation_lr * iters)
    for f, atol in tol.items():
        np.testing.assert_allclose(getattr(rt.model.params, f).numpy(),
                                   getattr(rc.model.params, f).numpy(), atol=atol, rtol=0,
                                   err_msg=f)
    assert rt.dropped_pairs == rc.dropped_pairs == 0
    for k in rc.pred_masks:
        np.testing.assert_array_equal(rt.pred_masks[k], rc.pred_masks[k], err_msg=k)


class _Placed(Exception):
    """Raised by the stub that stands in for the first tensor placement."""


TRAINERS = ["train_static", "estimate_coarse_obj_pose", "train_background", "fine_tune_obj",
            "fine_tune_all"]


@pytest.mark.parametrize("trainer", TRAINERS)
def test_trainers_default_to_the_card(monkeypatch, trainer):
    """Like JAX's, which run on the default device (the accelerator), the
    port's trainers run on CUDA unless given a device: device=None reaches
    the first tensor placement (stack_cameras, stubbed here, so no card is
    needed) as torch.device("cuda")."""
    seen = []

    def stub(cams, device):
        seen.append(device)
        raise _Placed

    # the trainers are the one-scene case of the lockstep drivers, which
    # place the frames
    monkeypatch.setattr(scene_trainer, "stack_cameras", stub)
    if trainer == "fine_tune_all":  # combine_models places nothing new
        monkeypatch.setattr(scene_trainer, "combine_models", lambda a, b: b)
    cfg = Config()
    pts = np.zeros((1, 3), np.float32)
    seq = empty_pose_sequence(1)
    with pytest.raises(_Placed):
        if trainer == "train_static":
            train_static([object()], pts, pts, cfg, [[0]], 1.0)
        elif trainer == "train_background":
            static.train_background([object()], pts, pts, cfg, [0], 1.0)
        elif trainer == "estimate_coarse_obj_pose":
            coarse_pose.estimate_coarse_obj_pose([object()], None, cfg, [[0], [0]], [[0]], 1.0)
        elif trainer == "fine_tune_obj":
            fine_obj.fine_tune_obj([object()], None, seq, cfg, [[0]], [[0]], 1.0)
        else:
            fine_all.fine_tune_all([object()], _model(), _model(), seq, cfg, [[0]], [[0]])
    assert seen == [torch.device("cuda")]


def _model():
    return from_points(np.zeros((4, 3), np.float32), np.zeros((4, 3), np.float32), CPU)


def test_pipeline_and_train_cli_default_to_the_card(monkeypatch, tmp_path):
    """run_pipeline(device=None) hands stage 1.0 torch.device("cuda"), and
    the training CLI loads the scene onto cuda unless given --device."""
    seen = []

    def stub(*args, device=None, **kw):
        seen.append(device)
        raise _Placed

    # stage 1.0 is the lockstep driver's (run_pipeline is the one-video case
    # of run_pipeline_scenes)
    monkeypatch.setattr(scene_trainer, "train_static_scenes", stub)
    scene = SceneData(cameras=[], points=np.zeros((1, 3), np.float32),
                      colors=np.zeros((1, 3), np.float32), nerf_norm={"radius": 1.0},
                      image_names=[])
    with pytest.raises(_Placed):
        pipeline.run_pipeline(scene, Config(), str(tmp_path), static_phases=[(0, 0)],
                              dynamic_phases=[])
    monkeypatch.setattr(cli_train, "load_colmap_scene",
                        lambda src, device, *a: stub(device=device))
    split = tmp_path / "data" / "split"
    split.mkdir(parents=True)
    for name in ("training_frames", "dynamic_eval_frames", "static_eval_frames"):
        (split / f"{name}.txt").write_text("000000\n")
    (split / "phase_frame_index.txt").write_text("0,0\n")
    with pytest.raises(_Placed):
        cli_train.main(["-s", str(tmp_path / "data"), "-m", str(tmp_path / "out")])
    assert seen == [torch.device("cuda")] * 2
