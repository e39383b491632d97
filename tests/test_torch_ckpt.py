"""Mid-stage checkpoints of the port (`utils/checkpoint.py`,
`train/ckpt_hook.py`):

  * the file format against the JAX package's save_train_state /
    load_train_state on plain arrays, both ways, bit for bit; a shape
    mismatch raises AssertionError, as JAX's does; no .tmp.npz is left;
    each state type's flatten order round-trips bit for bit;
  * resume = unbroken, for each trainer: a run interrupted right after a
    checkpoint (by an exception raised from the checkpoint hook, or for
    stage 2 from its per-frame pose save, as JAX's test does) and then
    called again on the same directory ends where an unbroken run with the
    same checkpoint interval ends. Each case is held to 1e-5 (JAX's own
    resume tests, tests/test_train.py, hold 1e-5) with equal alive masks;
    on the CPU they agree bit for bit. train_static has a case whose
    checkpoint lands exactly on the std+entropy boundary, and every
    trainer with a split generator (stages 1.0, 1.2 and 3; stage 2 seeds
    one afresh per frame, stage 5 does not densify) is stopped between two
    splitting densify calls, so a generator that was not restored fails;
  * run_pipeline interrupted inside stage 3 and rerun with resume=True
    gives the unbroken run's PLYs, pose files and metrics.

Resuming a stage checkpoint written by the JAX package is out of scope:
its host blob holds a JAX PRNG key where the port's holds a
torch.Generator state (train/ckpt_hook.py).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from egogaussian_tpu.utils.checkpoint import load_train_state as j_load_train_state
from egogaussian_tpu.utils.checkpoint import save_train_state as j_save_train_state
from egogaussian_tpu_torch.parallel import scene_trainer
from egogaussian_tpu_torch.config import Config
from egogaussian_tpu_torch.data import make_synthetic_video, split_viewpoints_by_phase
from egogaussian_tpu_torch.data.readers import SceneData, compute_nerfpp_norm
from egogaussian_tpu_torch.models.gaussians import from_points
from egogaussian_tpu_torch.models.optim import adam_init
from egogaussian_tpu_torch.models.pose import (
    empty_pose_sequence,
    identity_pose,
    load_pose_sequence,
    pose_sequence_from_jax_arrays,
)
from egogaussian_tpu_torch.pipeline import run_pipeline
from egogaussian_tpu_torch.train import ckpt_hook
from egogaussian_tpu_torch.train.coarse_pose import estimate_coarse_obj_pose
from egogaussian_tpu_torch.train.fine_all import fine_tune_all
from egogaussian_tpu_torch.train.fine_obj import fine_tune_obj
from egogaussian_tpu_torch.train.static import train_background, train_static
from egogaussian_tpu_torch.utils.checkpoint import (
    load_train_state,
    save_train_state,
    state_from_tensors,
    state_tensors,
)
from egogaussian_tpu_torch.utils.ply import read_ply

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 1e-5


@pytest.fixture(scope="module")
def video():
    return make_synthetic_video(CPU, width=64, height=48, n_bg=150, n_obj=40,
                                frames_static=4, frames_dynamic=3)


def _groups(video):
    return (split_viewpoints_by_phase(video.cameras, video.static_phases),
            split_viewpoints_by_phase(video.cameras, video.dynamic_phases))


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(5, 3).astype(np.float32), rng.randint(0, 9, (4,)).astype(np.int32),
            rng.rand(2, 2) > 0.5, np.float32(3.5)]


# ---------------------------------------------------------------------------
# the file format
# ---------------------------------------------------------------------------

def test_port_file_reads_back_through_jax(tmp_path):
    arrays = _arrays()
    path = str(tmp_path / "port.npz")
    save_train_state(path, [torch.as_tensor(a) for a in arrays], host_blob=b"host")
    assert os.listdir(tmp_path) == ["port.npz"]  # no .tmp.npz left behind
    back, blob = j_load_train_state(path, [np.zeros_like(a) for a in arrays], return_host=True)
    assert blob == b"host"
    for a, b in zip(arrays, back):
        assert np.asarray(b).dtype == a.dtype
        np.testing.assert_array_equal(np.asarray(b), a)


def test_jax_file_reads_back_through_port(tmp_path):
    arrays = _arrays(1)
    path = str(tmp_path / "jax.npz")
    j_save_train_state(path, arrays, host_blob=b"blob")
    like = [torch.zeros(a.shape, dtype=torch.as_tensor(a).dtype) for a in arrays]
    back, blob = load_train_state(path, like, return_host=True)
    assert blob == b"blob"
    for a, b, want in zip(arrays, back, like):
        assert b.dtype == want.dtype
        np.testing.assert_array_equal(b.numpy(), a)


def test_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "c.npz")
    save_train_state(path, [torch.zeros(4, 3)])
    with pytest.raises(AssertionError):
        load_train_state(path, [torch.zeros(8, 3)])
    with pytest.raises(AssertionError):
        load_train_state(path, [torch.zeros(4, 3), torch.zeros(1)])


def test_state_types_round_trip(tmp_path):
    rng = np.random.RandomState(2)
    model = from_points(rng.randn(20, 3).astype(np.float32), rng.rand(20, 3).astype(np.float32),
                        CPU, capacity=64)
    model.aux.generation[:5] = 3
    opt = adam_init(model.params)
    opt = dataclasses.replace(opt, mu=opt.mu.map(lambda x: x + 0.5),
                              count=torch.tensor(7, dtype=torch.int32))
    seq = pose_sequence_from_jax_arrays(rng.randn(6, 3), np.tile(np.eye(3), (6, 1, 1)),
                                        rng.rand(6) > 0.5, CPU)
    pose = identity_pose(CPU)
    pose_opt = adam_init(pose)
    state = (model, opt, pose_opt, seq, pose)
    path = str(tmp_path / "s.npz")
    save_train_state(path, state_tensors(state))
    fresh = (from_points(np.zeros((20, 3), np.float32), np.zeros((20, 3), np.float32), CPU,
                         capacity=64), adam_init(model.params), adam_init(pose),
             empty_pose_sequence(6, CPU), identity_pose(CPU))
    back = state_from_tensors(fresh, load_train_state(path, state_tensors(fresh)))
    for a, b in zip(state_tensors(state), state_tensors(back)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert back[0].capacity == 64 and int(back[1].count) == 7


# ---------------------------------------------------------------------------
# resume = unbroken, per trainer
# ---------------------------------------------------------------------------

class Interrupt(RuntimeError):
    """Stands in for a killed process (not KeyboardInterrupt, which pytest's
    xdist workers treat as a request to stop the session)."""


def _interrupt_after_save(monkeypatch, at_it):
    """Raise Interrupt right after the checkpoint of iteration `at_it` is
    written."""
    original = ckpt_hook.StageCheckpointer.maybe_save

    def save_then_stop(self, it, *args, **kwargs):
        original(self, it, *args, **kwargs)
        if it == at_it and self.path and not it % self.every:
            raise Interrupt(f"stopped after the checkpoint of iteration {it}")

    monkeypatch.setattr(ckpt_hook.StageCheckpointer, "maybe_save", save_then_stop)


def _count_growth(monkeypatch):
    """Record the alive count each densify_and_prune call of the stage
    loops (the lockstep drivers, whose one-scene case each trainer runs)
    adds."""
    original = scene_trainer.densify_and_prune
    grown = []

    def densify(model, *args, **kwargs):
        res = original(model, *args, **kwargs)
        grown.append(int(res.model.num_alive) - int(model.num_alive))
        return res

    monkeypatch.setattr(scene_trainer, "densify_and_prune", densify)
    return grown


def _assert_same_model(a, b):
    assert torch.equal(a.aux.alive, b.aux.alive)
    assert a.capacity == b.capacity
    for f, v in a.params.as_dict().items():
        np.testing.assert_allclose(v.numpy(), getattr(b.params, f).numpy(), atol=TOL, rtol=0,
                                   err_msg=f)
    for f in ("generation", "is_object"):
        assert torch.equal(getattr(a.aux, f), getattr(b.aux, f)), f


def _static_cfg():
    cfg = Config()
    cfg.static = dataclasses.replace(
        cfg.static, std_train_iter=30, entropy_reg_iter=5, label_train_iter=5,
        densify_from_iter=5, densify_until_iter=20, rewind_frames=3)
    cfg.opt = dataclasses.replace(cfg.opt, densification_interval=10,
                                  opacity_reset_interval=1000, densify_grad_threshold=1e-4,
                                  opacity_lr=0.5)
    return cfg


@pytest.mark.parametrize("stop_it", [15, 35], ids=["between_splits", "std_entropy_boundary"])
def test_train_static_resume_equals_unbroken(video, tmp_path, monkeypatch, stop_it):
    static_g, _ = _groups(video)
    cfg = _static_cfg()

    def run(d):
        return train_static(video.cameras, video.points, video.colors, cfg, static_g, 4.0,
                            save_dir=str(d), first_phase_only=True, checkpoint_every=5,
                            device=CPU)[0]

    with monkeypatch.context() as m:
        grown = _count_growth(m)
        whole = run(tmp_path / "whole")
    # densify at 10 and 20 both split: the first case stops between them
    assert len(grown) == 2 and all(n > 0 for n in grown)
    with monkeypatch.context() as m:
        _interrupt_after_save(m, stop_it)
        with pytest.raises(Interrupt):
            run(tmp_path / "broken")
    assert (tmp_path / "broken" / "ckpt_static_phase0.npz").exists()
    resumed = run(tmp_path / "broken")
    _assert_same_model(resumed.model, whole.model)
    for k in whole.pred_masks:
        np.testing.assert_array_equal(resumed.pred_masks[k], whole.pred_masks[k], err_msg=k)


def test_train_background_resume_equals_unbroken(video, tmp_path, monkeypatch):
    static_g, dyn_g = _groups(video)
    idx = sorted({i for g in static_g + dyn_g for i in g})
    cfg = Config()
    cfg.static_bg = dataclasses.replace(cfg.static_bg, std_train_iter=20, entropy_reg_iter=4,
                                        densify_from_iter=5, densify_until_iter=20)
    cfg.opt = dataclasses.replace(cfg.opt, densification_interval=10,
                                  opacity_reset_interval=1000, opacity_lr=0.5,
                                  densify_grad_threshold=1e-4)

    def run(d):
        return train_background(video.cameras, video.points, video.colors, cfg, idx, 4.0,
                                save_dir=str(d), checkpoint_every=6, device=CPU)

    with monkeypatch.context() as m:
        grown = _count_growth(m)
        whole = run(tmp_path / "whole")
    assert len(grown) == 2 and all(n > 0 for n in grown)
    with monkeypatch.context() as m:
        _interrupt_after_save(m, 12)  # between the splits at 10 and 20
        with pytest.raises(Interrupt):
            run(tmp_path / "broken")
    resumed = run(tmp_path / "broken")
    _assert_same_model(resumed, whole)


def _object_model(video, capacity=128):
    """The ground-truth object Gaussians (is_object = 1) at rest."""
    pts = video.gt_means[video.gt_is_object]
    m = from_points(pts, video.colors[video.gt_is_object], CPU, capacity=capacity)
    n = len(pts)
    m.params.log_scales[:n] = float(np.log(0.09))
    m.params.opacity_logit[:n] = float(np.log(0.95 / 0.05))
    m.aux.is_object[:n] = 1
    return m


def test_coarse_resume_equals_unbroken(video, tmp_path, monkeypatch):
    static_g, dyn_g = _groups(video)
    cfg = Config()
    cfg.coarse = dataclasses.replace(
        cfg.coarse, warm_up_iter=6, total_num_iter=12, densify_from_iter=7,
        densify_until_iter=11, densification_interval=4, opacity_reset_interval=100,
        densify_grad_threshold=2e-4)

    def run(d):
        return estimate_coarse_obj_pose(video.cameras, _object_model(video), cfg, static_g,
                                        dyn_g, 4.0, save_dir=str(d), checkpoint_every=1,
                                        device=CPU)

    seq_w, model_w, solved_w = run(tmp_path / "whole")
    assert int(model_w.num_alive) > int(_object_model(video).num_alive)  # splits ran
    original = scene_trainer.save_pose_sequence
    calls = []

    def save_then_stop(*args, **kwargs):
        original(*args, **kwargs)
        calls.append(1)
        if len(calls) == 2:
            raise Interrupt("stopped after two solved frames")

    with monkeypatch.context() as m:
        # the stage loop is the one-scene case of the lockstep driver
        m.setattr(scene_trainer, "save_pose_sequence", save_then_stop)
        with pytest.raises(Interrupt):
            run(tmp_path / "broken")
    solved_steps = []
    seq_r, model_r, solved_r = estimate_coarse_obj_pose(
        video.cameras, _object_model(video), cfg, static_g, dyn_g, 4.0,
        save_dir=str(tmp_path / "broken"), checkpoint_every=1, device=CPU,
        on_step=lambda f, it, loss: solved_steps.append(f))
    assert solved_r == solved_w
    assert len(set(solved_steps)) == len(solved_w) - 2  # the two saved frames were skipped
    for f in ("translations", "rotations", "solved"):
        np.testing.assert_allclose(getattr(seq_r, f).numpy(), getattr(seq_w, f).numpy(),
                                   atol=TOL, rtol=0, err_msg=f)
    _assert_same_model(model_r, model_w)


def test_fine_tune_obj_resume_equals_unbroken(video, tmp_path, monkeypatch):
    static_g, dyn_g = _groups(video)
    cfg = Config()
    cfg.fine = dataclasses.replace(cfg.fine, total_num_iter=16, densify_from_iter=2,
                                   densify_until_iter=10, densification_interval=4,
                                   opacity_reset_interval=8, densify_grad_threshold=2e-4)
    cfg.opt = dataclasses.replace(cfg.opt, obj_translation_lr=2e-3, obj_rotation_lr=2e-3)
    cfg.render = dataclasses.replace(cfg.render, pose_crop_margin=4)
    d = video.gt_obj_deltas.astype(np.float32)
    solved = np.zeros(len(video.cameras), bool)
    solved[dyn_g[0] + [static_g[1][0]]] = True
    tr = np.where(solved[:, None], d[:, :3, 3] + 0.02, 0.0).astype(np.float32)
    rot = np.where(solved[:, None, None], d[:, :3, :3], np.eye(3, dtype=np.float32))

    def run(dirname):
        return fine_tune_obj(video.cameras, _object_model(video),
                             pose_sequence_from_jax_arrays(tr, rot, solved, CPU), cfg,
                             static_g, dyn_g, 4.0, save_dir=str(dirname), checkpoint_every=3,
                             device=CPU)

    with monkeypatch.context() as m:
        grown = _count_growth(m)
        seq_w, model_w = run(tmp_path / "whole")
    assert len(grown) == 2 and grown[1] > 0
    with monkeypatch.context() as m:
        _interrupt_after_save(m, 6)  # between densify at 4 and 8; the pose live from 10
        with pytest.raises(Interrupt):
            run(tmp_path / "broken")
    seq_r, model_r = run(tmp_path / "broken")
    for f in ("translations", "rotations", "solved"):
        np.testing.assert_allclose(getattr(seq_r, f).numpy(), getattr(seq_w, f).numpy(),
                                   atol=TOL, rtol=0, err_msg=f)
    assert not np.allclose(seq_w.translations.numpy(), tr)  # the poses trained
    _assert_same_model(model_r, model_w)


def test_fine_tune_all_resume_equals_unbroken(video, tmp_path, monkeypatch):
    static_g, dyn_g = _groups(video)
    cfg = Config()
    cfg.fine_all = dataclasses.replace(cfg.fine_all, total_num_iter=16, densify_from_iter=5,
                                       densify_until_iter=10, opacity_reset_interval=7)
    bg = from_points(video.points[:150], video.colors[:150], CPU, capacity=512,
                     spatial_lr_scale=4.0)
    seq = pose_sequence_from_jax_arrays(video.gt_obj_deltas[:, :3, 3],
                                        video.gt_obj_deltas[:, :3, :3],
                                        np.ones(len(video.cameras), bool), CPU)

    def run(d):
        return fine_tune_all(video.cameras, _object_model(video), bg, seq, cfg, static_g,
                             dyn_g, save_dir=str(d), checkpoint_every=4, device=CPU)

    whole = run(tmp_path / "whole")
    with monkeypatch.context() as m:
        _interrupt_after_save(m, 8)  # inside the clamp window
        with pytest.raises(Interrupt):
            run(tmp_path / "broken")
    _assert_same_model(run(tmp_path / "broken"), whole)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _pipeline_cfg():
    cfg = Config()
    cfg.static = dataclasses.replace(
        cfg.static, std_train_iter=12, entropy_reg_iter=4, label_train_iter=8,
        densify_from_iter=100, densify_until_iter=0, rewind_frames=3, label_lr=0.1)
    cfg.static_bg = dataclasses.replace(cfg.static_bg, std_train_iter=8, entropy_reg_iter=2,
                                        densify_from_iter=100, densify_until_iter=0)
    cfg.opt = dataclasses.replace(cfg.opt, densification_interval=10,
                                  opacity_reset_interval=1000, opacity_lr=0.5)
    # stage 2 densifies (at 4 and 6 of every frame), so the model it hands
    # on holds densify statistics and dead rows that its PLY does not
    cfg.coarse = dataclasses.replace(cfg.coarse, warm_up_iter=4, total_num_iter=8,
                                     densify_from_iter=3, densify_until_iter=7,
                                     densification_interval=2, densify_grad_threshold=1e-5)
    # stage 3 splits after the checkpoint it is stopped at (3): densify at 4
    cfg.fine = dataclasses.replace(cfg.fine, total_num_iter=8, densify_from_iter=2,
                                   densify_until_iter=6, densification_interval=4,
                                   opacity_reset_interval=1000, densify_grad_threshold=1e-5)
    cfg.fine_all = dataclasses.replace(cfg.fine_all, total_num_iter=6)
    return cfg


def test_run_pipeline_resume_inside_stage3_equals_unbroken(tmp_path, monkeypatch):
    vid = make_synthetic_video(CPU, width=48, height=36, n_bg=120, n_obj=30,
                               frames_static=3, frames_dynamic=3)
    names = vid.image_names
    splits = dict(training_frames=names[:-1], dynamic_eval_frames=[names[3]],
                  static_eval_frames=[names[-1]], static_phases=vid.static_phases,
                  dynamic_phases=vid.dynamic_phases)
    scene = SceneData(cameras=vid.cameras, points=vid.points, colors=vid.colors,
                      nerf_norm=compute_nerfpp_norm(vid.cameras), image_names=names)
    cfg = _pipeline_cfg()

    def run(out, **kw):
        return run_pipeline(scene, cfg, str(out), device=CPU, checkpoint_every=3, **splits,
                            **kw)

    whole = run(tmp_path / "whole")
    with monkeypatch.context() as m:
        original = ckpt_hook.StageCheckpointer.maybe_save

        def stop_in_stage3(self, it, *args, **kwargs):
            original(self, it, *args, **kwargs)
            if self.path and self.path.endswith("ckpt_fine_obj.npz") and it == 3:
                raise Interrupt("stopped inside stage 3")

        m.setattr(ckpt_hook.StageCheckpointer, "maybe_save", stop_in_stage3)
        with pytest.raises(Interrupt):
            run(tmp_path / "broken")
    broken = tmp_path / "broken"
    assert (broken / "fine_obj" / "from-static" / "ckpt_fine_obj.npz").exists()
    assert not (broken / "fine_obj" / "from-static" / "gaussians_fine.ply").exists()
    again = run(broken, resume=True)
    assert again.metrics == whole.metrics
    for ply in ("fine_obj/from-static/gaussians_fine.ply",
                "fine_obj/from-coarse/gaussians_fine.ply", "fine_all/gaussians_all.ply"):
        a, _ = read_ply(str(tmp_path / "whole" / ply))
        b, _ = read_ply(str(broken / ply))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], atol=TOL, rtol=0, err_msg=f"{ply}: {k}")
    for npz in ("fine_obj/from-static", "fine_obj/from-coarse", "interpolate_pose_coarse"):
        sa, _ = load_pose_sequence(str(tmp_path / "whole" / npz / "obj_pose_sequence.npz"))
        sb, _ = load_pose_sequence(str(broken / npz / "obj_pose_sequence.npz"))
        for f in ("translations", "rotations", "solved"):
            np.testing.assert_allclose(getattr(sb, f).numpy(), getattr(sa, f).numpy(),
                                       atol=TOL, rtol=0, err_msg=f"{npz}: {f}")
    # stage 3 split Gaussians after the checkpoint the run was stopped at
    n_obj = read_ply(str(broken / "static" / "ply" / "static_phase0_obj.ply"))[1]
    assert read_ply(str(broken / "fine_obj" / "from-static" / "gaussians_fine.ply"))[1] > n_obj
