"""The port's six-stage pipeline (`pipeline.py`) and training CLI
(`cli/train.py`):

  * stage 1.1 keeps a shipped all-zero object mask, completes an absent
    one, and the pipeline stops when a static frame has neither;
  * stage 1.2 stops, as JAX's does, on a dynamic frame with no object mask;
  * `run_pipeline` alone at tiny_config (tests/test_train.py) on a 48x36
    video whose next-static anchor mask is missing: JAX's artifact tree,
    file for file; JAX's load_ply / load_pose_sequence read the port's
    files; every dynamic frame solved; a resumed run trains nothing and
    gives the same metrics;
  * the training CLI on a 64x48 video exported in the reference's dataset
    layout, with --device cpu; the same run with --checkpoint_every,
    stopped inside stage 3 and rerun with --resume, gives the unbroken
    run's PLYs and pose files byte for byte and its metrics; with --mesh 2
    (two gloo ranks, stages 1.0 and 1.2 frame-data-parallel) rank 0 writes
    the same tree and one metrics record per stage, and the stage-1 PLYs
    are a single process's at frame batch 2 within 5e-5 (the PLY bound of
    the last test: the ranks' mean of means reassociates float sums);
  * the whole pipeline against JAX's `run_pipeline` on the same 48x36
    video at a schedule shorter than tiny_config with every densify window
    empty (JAX in interpret-mode Pallas, the port on its plain twins).

Tolerances of the last test, each beside the largest error measured in a
CPU run of it: the same artifact tree and alive counts; PLY params 5e-5
(measured 1.1e-5, opacity logits after stage 3); the interpolated poses
1e-6 (measured 1.2e-7); PSNR 1e-4 dB (measured 9e-7), SSIM 1e-6 (measured
1.5e-7).
"""
import dataclasses
import datetime
import json
import os

import numpy as np
import pytest
import torch

from egogaussian_tpu.config import Config as JConfig
from egogaussian_tpu.data.readers import SceneData as JSceneData
from egogaussian_tpu.data.readers import compute_nerfpp_norm as j_nerfpp_norm
from egogaussian_tpu.models.gaussians import load_ply as j_load_ply
from egogaussian_tpu.models.pose import load_pose_sequence as j_load_pose_sequence
from egogaussian_tpu.pipeline import run_pipeline as j_run_pipeline
from egogaussian_tpu.train.static import train_background as j_train_background
from egogaussian_tpu_torch.cli.train import main as train_main
from egogaussian_tpu_torch.cli.train import train_video
from egogaussian_tpu_torch.config import Config, add_config_args, extract_config
from egogaussian_tpu_torch.data import make_synthetic_video
from egogaussian_tpu_torch.data.export_colmap import export_colmap_dataset
from egogaussian_tpu_torch.data.readers import SceneData, compute_nerfpp_norm
from egogaussian_tpu_torch.models.gaussians import from_points, save_ply
from egogaussian_tpu_torch.parallel import launch
from egogaussian_tpu_torch.pipeline import apply_predicted_masks, run_pipeline
from egogaussian_tpu_torch.train import ckpt_hook
from egogaussian_tpu_torch.train.static import train_background
from egogaussian_tpu_torch.utils.ply import read_ply
from tests.test_torch_static import _jax_cameras
from tests.test_train import tiny_config

torch.set_num_threads(1)
CPU = torch.device("cpu")
STAGES = ("static", "background", "coarse", "fine_obj/from-static", "fine_obj/from-coarse",
          "fine_all")


def _port_config(jcfg) -> Config:
    """The port's Config with every value of a JAX Config."""
    cfg = Config()
    for name, group in vars(cfg).items():
        jgroup = getattr(jcfg, name)
        setattr(cfg, name, dataclasses.replace(group, **{
            f.name: getattr(jgroup, f.name) for f in dataclasses.fields(group)
            if hasattr(jgroup, f.name) and f.name != "data_device"}))
    return cfg


def _scene(vid):
    return SceneData(cameras=vid.cameras, points=vid.points, colors=vid.colors,
                     nerf_norm=compute_nerfpp_norm(vid.cameras), image_names=vid.image_names)


def _splits(vid):
    names = vid.image_names
    return dict(training_frames=names[:-1], dynamic_eval_frames=[names[3]],
                static_eval_frames=[names[-1]], static_phases=vid.static_phases,
                dynamic_phases=vid.dynamic_phases)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _records(save_dir):
    with open(os.path.join(save_dir, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _video(**kw):
    return make_synthetic_video(CPU, width=48, height=36, n_bg=120, n_obj=30,
                                frames_static=3, frames_dynamic=2, **kw)


def test_apply_predicted_masks_keeps_shipped_zero_mask():
    """Stage 1.1 completes only frames whose mask file is absent; a shipped
    all-zero mask (the object absent in that frame) is ground truth."""
    vid = make_synthetic_video(CPU, width=32, height=24, n_bg=40, n_obj=10,
                               frames_static=2, frames_dynamic=1)
    cams = list(vid.cameras)
    cams[0] = dataclasses.replace(cams[0], obj_mask=torch.zeros_like(cams[0].obj_mask))
    cams[1] = dataclasses.replace(cams[1], obj_mask=None)
    pred = np.ones((cams[0].height, cams[0].width), np.float32)
    out = apply_predicted_masks(cams, {cams[0].image_name: pred, cams[1].image_name: pred})
    assert float(out[0].obj_mask.sum()) == 0.0
    assert out[1].obj_mask is not None and float(out[1].obj_mask.sum()) == pred.size
    assert out[2] is cams[2]


def test_background_stops_on_a_frame_without_mask():
    """Stage 1.2's interaction mask needs every training frame's hand and
    object masks. A dynamic frame with no object mask (stage 1.1 completes
    static frames only) raises before any step, in the port as in JAX."""
    vid = make_synthetic_video(CPU, width=32, height=24, n_bg=40, n_obj=10,
                               frames_static=2, frames_dynamic=1)
    dyn = vid.dynamic_phases[0][0]
    vid.cameras[dyn] = dataclasses.replace(vid.cameras[dyn], obj_mask=None)
    idx = list(range(len(vid.cameras)))
    with pytest.raises(ValueError, match="1 training frames have no hand or object mask"):
        train_background(vid.cameras, vid.points, vid.colors, Config(), idx, 1.0, device=CPU)
    with pytest.raises(TypeError):
        j_train_background(_jax_cameras(vid.cameras), vid.points, vid.colors, JConfig(), idx,
                           1.0)


def test_pipeline_stops_on_a_static_frame_without_mask(tmp_path):
    """A static training frame with neither a shipped nor a predicted mask
    stops the pipeline at stage 1.1 (reference train.py:90), before any
    later stage runs. Stage 1.0's files are in place, so resume skips it."""
    vid = _video()
    anchor = vid.static_phases[1][0]
    vid.cameras[anchor] = dataclasses.replace(vid.cameras[anchor], obj_mask=None)
    model = from_points(vid.points, vid.colors, CPU)
    for p in (0, 1):
        save_ply(model, str(tmp_path / "static" / "ply" / f"static_phase{p}.ply"))
    save_ply(model, str(tmp_path / "static" / "ply" / "static_phase0_obj.ply"))
    with pytest.raises(AssertionError, match="stage 1.1: 1 static frames"):
        run_pipeline(_scene(vid), _port_config(tiny_config()), str(tmp_path), resume=True,
                     device=CPU, **_splits(vid))
    assert not (tmp_path / "background").exists()


def _jax_layout(vid, splits):
    """Every file JAX's run_pipeline writes for this video and split."""
    names = vid.image_names
    train = set(splits["training_frames"])
    static = [n for n in names if n in train
              and any(a <= int(n) <= b for a, b in vid.static_phases)]
    files = ["background/static_bg.ply", "coarse/obj_pose_sequence.npz",
             "coarse/ply/gaussians_final.ply", "evaluation/results.txt",
             "fine_all/gaussians_all.ply", "logs/metrics.jsonl"]
    files += [f"static/obj_masks/{n}.png" for n in static]
    files += [f"static/ply/static_phase{p}{s}.ply" for p in range(len(vid.static_phases))
              for s in ("", "_bg", "_obj")]
    for variant in ("from-static", "from-coarse"):
        files += [f"fine_obj/{variant}/gaussians_fine.ply",
                  f"fine_obj/{variant}/obj_pose_sequence.npz",
                  f"interpolate_pose_{variant[5:]}/obj_pose_sequence.npz"]
    for n in names:
        bucket = ("dynamic_eval" if n in splits["dynamic_eval_frames"] else
                  "static_eval" if n in splits["static_eval_frames"] else "training")
        files += [f"evaluation/{bucket}/{n}.png", f"evaluation/{bucket}/{n}_mask.png"]
    return sorted(files)


def test_run_pipeline_tiny_config_and_resume(tmp_path):
    vid = _video()
    # the next-static anchor's mask file is missing: stage 1.0 must train
    # phase 1 and stage 1.1 complete the mask from its prediction
    anchor = vid.static_phases[1][0]
    vid.cameras[anchor] = dataclasses.replace(vid.cameras[anchor], obj_mask=None)
    splits = _splits(vid)
    cfg = _port_config(tiny_config())
    out = str(tmp_path)
    res = run_pipeline(_scene(vid), cfg, out, device=CPU, **splits)
    assert _tree(out) == _jax_layout(vid, splits)
    assert int(res.final_model.num_alive) > 0
    for ph in vid.dynamic_phases:
        assert all(bool(res.pose_seq.solved[f]) for f in range(ph[0], ph[1] + 1))
    assert np.isfinite(res.metrics["dynamic_eval"]["psnr"])
    from PIL import Image

    with Image.open(tmp_path / "static" / "obj_masks" / f"{vid.image_names[anchor]}.png") as im:
        assert np.asarray(im).sum() > 0  # the predicted anchor mask segments the object

    # JAX's readers take the port's files
    jm = j_load_ply(os.path.join(out, "fine_all", "gaussians_all.ply"))
    assert int(jm.num_alive) == int(res.final_model.num_alive)
    np.testing.assert_array_equal(
        np.asarray(jm.params.xyz)[:int(jm.num_alive)],
        res.final_model.params.xyz[res.final_model.aux.alive].numpy())
    jseq, names = j_load_pose_sequence(os.path.join(out, "interpolate_pose_coarse",
                                                    "obj_pose_sequence.npz"))
    assert names == vid.image_names
    np.testing.assert_array_equal(np.asarray(jseq.translations),
                                  res.pose_seq.translations.numpy())
    np.testing.assert_array_equal(np.asarray(jseq.solved), res.pose_seq.solved.numpy())

    first = _records(out)
    timed = {r["name"]: r for r in first if r.get("event") == "stage_time"}
    assert all(timed[s]["iterations"] > 0 and not timed[s]["resumed"] for s in STAGES)
    assert all(r["dropped_pairs"] == 0 for r in first if r.get("event") == "stage_end")

    res2 = run_pipeline(_scene(vid), cfg, out, device=CPU, resume=True, **splits)
    again = _records(out)[len(first):]
    assert {r["stage"] for r in again} == {"pipeline"}  # no trainer logged a step
    timed = {r["name"]: r for r in again if r.get("event") == "stage_time"}
    assert all(timed[s]["resumed"] and timed[s]["iterations"] == 0 for s in STAGES)
    assert res2.metrics == res.metrics
    assert _tree(out) == _jax_layout(vid, splits)


def test_train_cli_on_exported_dataset(tmp_path, monkeypatch):
    vid = make_synthetic_video(CPU, width=64, height=48, n_bg=150, n_obj=40,
                               frames_static=3, frames_dynamic=3)
    src = export_colmap_dataset(vid, str(tmp_path / "data"))
    out = str(tmp_path / "out")
    schedule = [
        "--s_std_train_iter", "12", "--s_entropy_reg_iter", "4", "--s_label_train_iter", "10",
        "--s_densify_until_iter", "0", "--s_label_lr", "0.1",
        "--b_std_train_iter", "8", "--b_entropy_reg_iter", "2", "--b_densify_until_iter", "0",
        "--c_warm_up_iter", "4", "--c_total_num_iter", "6", "--c_densify_from_iter", "100",
        "--c_densify_until_iter", "0",
        "--f_total_num_iter", "6", "--f_densify_from_iter", "100", "--f_densify_until_iter", "3",
        "--a_total_num_iter", "6",
        "--opacity_lr", "0.5",
    ]
    res = train_main(["-s", src, "-m", out, "--device", "cpu"] + schedule)
    with open(os.path.join(out, "cfg_args.json")) as f:
        saved = json.load(f)
    assert saved["static"]["label_lr"] == 0.1 and saved["fine_all"]["total_num_iter"] == 6
    assert saved["opt"]["opacity_lr"] == 0.5
    for p in ("input.ply", "cameras.json", "fine_all/gaussians_all.ply",
              "interpolate_pose_coarse/obj_pose_sequence.npz", "evaluation/results.txt"):
        assert os.path.exists(os.path.join(out, p)), p
    assert set(res.metrics) == {"dynamic_eval", "static_eval"}
    # the held-out interior dynamic frame got its pose from stage 4
    with open(os.path.join(src, "split", "dynamic_eval_frames.txt")) as f:
        held_out = vid.image_names.index(f.read().strip())
    assert bool(res.pose_seq.solved[held_out])

    # --mesh 2: two gloo ranks; rank 0 alone returns the metrics and writes
    # (a rank that stops answering fails this test within minutes)
    monkeypatch.setattr(launch, "WAIT_LIMIT", datetime.timedelta(minutes=5))
    mesh_out = str(tmp_path / "mesh")
    per_rank = train_main(["-s", src, "-m", mesh_out, "--device", "cpu", "--mesh", "2"]
                          + schedule)
    assert per_rank[1] is None and set(per_rank[0]) == set(res.metrics)
    assert _tree(mesh_out) == _tree(out)
    timed = [r["name"] for r in _records(mesh_out) if r.get("event") == "stage_time"]
    assert len(timed) == len(set(timed)) == len(STAGES) + 2  # + interpolate, eval
    single = str(tmp_path / "single_fb2")
    cfg = extract_config(_config_args(["-s", src, "-m", single, "--s_frame_batch", "2",
                                       "--b_frame_batch", "2"] + schedule))
    train_video(cfg, seed=0, resume=False, lpips_fn=None, checkpoint_every=0, device=CPU,
                stop_after="background")
    for ply in ("static/ply/static_phase0.ply", "static/ply/static_phase1.ply",
                "background/static_bg.ply"):
        vs, _ = read_ply(os.path.join(single, ply))
        vm, _ = read_ply(os.path.join(mesh_out, ply))
        assert len(vm["x"]) == len(vs["x"]) > 0, ply
        for k in vs:
            np.testing.assert_allclose(vm[k], vs[k], atol=5e-5, rtol=0, err_msg=f"{ply}: {k}")

    # --checkpoint_every: stopped inside stage 3 right after its checkpoint
    # of iteration 2, then rerun with --resume, it ends where the unbroken
    # run above ended (a checkpoint save changes nothing)
    broken = str(tmp_path / "broken")
    argv = ["-s", src, "-m", broken, "--device", "cpu", "--checkpoint_every", "2"] + schedule
    original = ckpt_hook.StageCheckpointer.maybe_save

    def stop_in_stage3(self, it, *args, **kwargs):
        original(self, it, *args, **kwargs)
        if self.path and self.path.endswith("ckpt_fine_obj.npz") and it == 2:
            raise _Stopped

    with monkeypatch.context() as m:
        m.setattr(ckpt_hook.StageCheckpointer, "maybe_save", stop_in_stage3)
        with pytest.raises(_Stopped):
            train_main(argv)
    assert os.path.exists(os.path.join(broken, "fine_obj", "from-static", "ckpt_fine_obj.npz"))
    again = train_main(argv + ["--resume"])
    with open(os.path.join(broken, "logs", "metrics.jsonl")) as f:
        resumes = [r for r in map(json.loads, f) if r.get("event") == "ckpt_resume"]
    assert [(r["stage"], r["step"]) for r in resumes][-1] == ("fine_obj", 2)
    assert again.metrics == res.metrics
    for ply in ("fine_obj/from-static/gaussians_fine.ply",
                "fine_obj/from-coarse/gaussians_fine.ply", "fine_all/gaussians_all.ply"):
        with open(os.path.join(out, ply), "rb") as fa, open(os.path.join(broken, ply), "rb") as fb:
            assert fa.read() == fb.read(), ply
    for npz in ("coarse", "fine_obj/from-static", "fine_obj/from-coarse",
                "interpolate_pose_coarse", "interpolate_pose_static"):
        a = np.load(os.path.join(out, npz, "obj_pose_sequence.npz"))
        b = np.load(os.path.join(broken, npz, "obj_pose_sequence.npz"))
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{npz}: {k}")


class _Stopped(RuntimeError):
    """Stands in for a killed process."""


def _config_args(argv):
    from argparse import ArgumentParser

    parser = ArgumentParser()
    add_config_args(parser)
    return parser.parse_args(argv)


def _short(cfg):
    """Shorter than tiny_config, every densify window empty; the pose of
    stage 3 live from iteration 6; stage 5's opacity clamp on at 3 and 5;
    opacity_lr raised so that Gaussians pass the 0.5 prunes."""
    cfg.static = dataclasses.replace(
        cfg.static, std_train_iter=20, entropy_reg_iter=5, label_train_iter=10,
        densify_from_iter=100, densify_until_iter=0, rewind_frames=3, label_lr=0.1)
    cfg.static_bg = dataclasses.replace(cfg.static_bg, std_train_iter=20, entropy_reg_iter=5,
                                        densify_from_iter=100, densify_until_iter=0)
    cfg.opt = dataclasses.replace(cfg.opt, densification_interval=10,
                                  opacity_reset_interval=1000, opacity_lr=0.5)
    cfg.coarse = dataclasses.replace(cfg.coarse, warm_up_iter=8, total_num_iter=12,
                                     densify_from_iter=100, densify_until_iter=0,
                                     densification_interval=4, opacity_reset_interval=1000)
    cfg.fine = dataclasses.replace(cfg.fine, total_num_iter=12, densify_from_iter=100,
                                   densify_until_iter=6, densification_interval=4,
                                   opacity_reset_interval=1000)
    cfg.fine_all = dataclasses.replace(cfg.fine_all, total_num_iter=10, densify_from_iter=2,
                                       densify_until_iter=6, opacity_reset_interval=4)
    return cfg


def test_pipeline_matches_jax(tmp_path):
    vid = _video()
    splits = _splits(vid)
    jcams = _jax_cameras(vid.cameras)
    jscene = JSceneData(cameras=jcams, points=vid.points, colors=vid.colors,
                        nerf_norm=j_nerfpp_norm(jcams), image_names=vid.image_names)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    rj = j_run_pipeline(jscene, _short(JConfig()), jout, **splits)
    rt = run_pipeline(_scene(vid), _short(Config()), tout, device=CPU, **splits)
    assert _tree(tout) == _tree(jout)
    for ply in ("static/ply/static_phase0_obj.ply", "background/static_bg.ply",
                "fine_obj/from-coarse/gaussians_fine.ply", "fine_all/gaussians_all.ply"):
        vj, _ = read_ply(os.path.join(jout, ply))
        vt, _ = read_ply(os.path.join(tout, ply))
        assert len(vt["x"]) == len(vj["x"]) > 0, ply
        for k in vj:
            np.testing.assert_allclose(vt[k], vj[k], atol=5e-5, rtol=0, err_msg=f"{ply}: {k}")
    for variant in ("static", "coarse"):
        path = os.path.join(f"interpolate_pose_{variant}", "obj_pose_sequence.npz")
        with np.load(os.path.join(jout, path)) as zj, np.load(os.path.join(tout, path)) as zt:
            np.testing.assert_array_equal(zt["solved"], zj["solved"])
            assert all(zt["solved"][f] for a, b in vid.dynamic_phases for f in range(a, b + 1))
            for k in ("translations", "rotations"):
                np.testing.assert_allclose(zt[k], zj[k], atol=1e-6, rtol=0, err_msg=k)
    for bucket, m in rj.metrics.items():
        assert abs(rt.metrics[bucket]["psnr"] - m["psnr"]) < 1e-4, bucket
        assert abs(rt.metrics[bucket]["ssim"] - m["ssim"]) < 1e-6, bucket
