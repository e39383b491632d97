"""Stage 6 of the port (evaluation) against the JAX package on the CPU:
hand-masked metrics, the LPIPS network, COLMAP files and scene loading,
render_results' buckets, results.txt, and the eval CLI end to end on a
64x48 synthetic video exported in the reference's dataset layout.

Tolerances: metrics and LPIPS on the same float inputs, relative 1e-5
(float32 reassociation in the SSIM blur and VGG convolutions). Renders go
through the 8-bit quantization of the reference protocol, so one render
difference of ~1e-6 can flip a level: quantized renders may differ by one
level (1/255), PSNR by 0.01 dB and SSIM by 1e-4.
"""
import dataclasses
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egogaussian_tpu.cli.eval import main as j_eval_main
from egogaussian_tpu.data import colmap as j_colmap
from egogaussian_tpu.data.readers import load_colmap_scene as j_load_scene
from egogaussian_tpu.data.readers import write_scene_artifacts as j_write_artifacts
from egogaussian_tpu.eval import lpips as j_lpips
from egogaussian_tpu.eval.metrics import evaluate_metrics as j_evaluate
from egogaussian_tpu.eval.metrics import masked_psnr as j_psnr
from egogaussian_tpu.eval.metrics import masked_ssim as j_ssim
from egogaussian_tpu_torch.cli.eval import main as t_eval_main
from egogaussian_tpu_torch.data import colmap
from egogaussian_tpu_torch.data.export_colmap import export_colmap_dataset
from egogaussian_tpu_torch.data.readers import (
    find_idx_by_image_name,
    load_colmap_scene,
    read_phase_index,
    read_split_file,
    write_scene_artifacts,
)
from egogaussian_tpu_torch.data.synthetic import make_synthetic_video
from egogaussian_tpu_torch.eval import lpips
from egogaussian_tpu_torch.eval.metrics import evaluate_metrics, masked_psnr, masked_ssim
from egogaussian_tpu_torch.eval.render_results import (
    _quantize8,
    render_novel_view,
    render_results,
)
from egogaussian_tpu_torch.models.gaussians import from_points, save_ply
from egogaussian_tpu_torch.models.pose import PoseSequence, save_pose_sequence

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _images(seed, n=2, h=48, w=64):
    rng = np.random.RandomState(seed)
    renders = [rng.rand(3, h, w).astype(np.float32) for _ in range(n)]
    gts = [np.clip(r + rng.randn(3, h, w).astype(np.float32) * 0.1, 0, 1) for r in renders]
    hands = [(rng.rand(1, h, w) > 0.8).astype(np.float32) for _ in range(n)]
    return renders, gts, hands


def test_metrics_match_jax():
    renders, gts, hands = _images(0)
    r, g, h = (torch.as_tensor(x[0]) for x in (renders, gts, hands))
    np.testing.assert_allclose(float(masked_psnr(r, g, h)),
                               float(j_psnr(*(jnp.asarray(x[0]) for x in (renders, gts, hands)))),
                               rtol=1e-5)
    np.testing.assert_allclose(float(masked_ssim(r, g, h)),
                               float(j_ssim(*(jnp.asarray(x[0]) for x in (renders, gts, hands)))),
                               rtol=1e-5)
    tm = evaluate_metrics(renders, gts, hands, lpips_fn=lpips.LPIPS(allow_random=True))
    jm = j_evaluate(renders, gts, hands, lpips_fn=j_lpips.LPIPS(allow_random=True))
    assert set(tm) == set(jm) == {"psnr", "ssim", "lpips"}
    for k in tm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=k)


def test_lpips_weights_match_jax_and_round_trip(tmp_path):
    """random_lpips_weights draws JAX's weights; the npz the port writes,
    and the converter's, load back identically in both packages."""
    tw, jw = lpips.random_lpips_weights(3), j_lpips.random_lpips_weights(3)
    for a, b in zip(tw.convs + tw.biases + tw.lins, jw.convs + jw.biases + jw.lins):
        np.testing.assert_array_equal(a, np.asarray(b))
    path = str(tmp_path / "w.npz")
    lpips.save_lpips_weights(tw, path)
    back = j_lpips.load_lpips_weights(path)
    for a, b in zip(tw.convs + tw.lins, back.convs + back.lins):
        np.testing.assert_array_equal(a, np.asarray(b))
    idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    vgg = {f"features.{li}.weight": torch.as_tensor(w) for li, w in zip(idx, tw.convs)}
    vgg.update({f"features.{li}.bias": torch.as_tensor(b) for li, b in zip(idx, tw.biases)})
    lin = {f"lin{j}.model.1.weight": torch.as_tensor(w).reshape(1, -1, 1, 1)
           for j, w in enumerate(tw.lins)}
    conv_path = str(tmp_path / "conv.npz")
    lpips.convert_torch_lpips(vgg, lin, conv_path)
    again = lpips.load_lpips_weights(conv_path)
    for a, b in zip(tw.convs + tw.biases + tw.lins, again.convs + again.biases + again.lins):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="calibrated weights"):
        lpips.LPIPS()


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A 64x48 synthetic video in the reference's dataset layout, with the
    artifacts the eval CLI reads: the ground-truth scene as
    fine_all/gaussians_all.ply and the ground-truth object motion as
    interpolate_pose_coarse/obj_pose_sequence.npz."""
    root = tmp_path_factory.mktemp("eval")
    vid = make_synthetic_video(CPU, width=64, height=48, n_bg=300, n_obj=80,
                               frames_static=4, frames_dynamic=3)
    src = export_colmap_dataset(vid, str(root / "data"))
    model = from_points(vid.gt_means, vid.colors, CPU)
    is_obj = torch.zeros_like(model.aux.is_object)
    is_obj[:len(vid.gt_is_object)] = torch.as_tensor(vid.gt_is_object.astype(np.int32))
    model = dataclasses.replace(model, aux=dataclasses.replace(model.aux, is_object=is_obj))
    out = str(root / "out")
    save_ply(model, os.path.join(out, "fine_all", "gaussians_all.ply"))
    deltas = torch.as_tensor(vid.gt_obj_deltas)
    seq = PoseSequence(translations=deltas[:, :3, 3].contiguous(),
                       rotations=deltas[:, :3, :3].contiguous(),
                       solved=torch.ones(len(vid.cameras), dtype=torch.bool))
    save_pose_sequence(os.path.join(out, "interpolate_pose_coarse", "obj_pose_sequence.npz"),
                       seq, vid.image_names)
    return vid, src, out


def test_colmap_files_round_trip_and_match_jax(exported, tmp_path):
    """The exported sparse model reads back as the video (both packages'
    readers agree), the split files follow JAX's export rule, and the
    loaded scene equals JAX's loader's, down to the artifacts it writes."""
    vid, src, _ = exported
    sparse = os.path.join(src, "sparse", "0")
    cams = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    imgs = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
    xyz, rgb, _ = colmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
    jcams = j_colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    jimgs = j_colmap.read_images_binary(os.path.join(sparse, "images.bin"))
    jxyz, jrgb, _ = j_colmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
    assert cams[1].model == "PINHOLE" and (cams[1].width, cams[1].height) == (64, 48)
    np.testing.assert_array_equal(cams[1].params, jcams[1].params)
    np.testing.assert_allclose(cams[1].params[0], float(vid.cameras[0].fx))
    for i, cam in enumerate(vid.cameras):
        im = imgs[i + 1]
        assert im.name == f"{cam.image_name}.png" == jimgs[i + 1].name
        np.testing.assert_array_equal(im.qvec, jimgs[i + 1].qvec)
        np.testing.assert_allclose(colmap.qvec2rotmat(im.qvec), cam.viewmat[:3, :3].numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(im.tvec, cam.viewmat[:3, 3].numpy(), atol=1e-6)
    np.testing.assert_array_equal(xyz, jxyz)
    np.testing.assert_array_equal(rgb, jrgb)
    np.testing.assert_allclose(xyz, vid.points, atol=1e-6)

    split = os.path.join(src, "split")
    train = read_split_file(os.path.join(split, "training_frames.txt"))
    static_p, dyn_p = read_phase_index(os.path.join(split, "phase_frame_index.txt"))
    assert static_p == [tuple(p) for p in vid.static_phases]
    assert dyn_p == [tuple(p) for p in vid.dynamic_phases]
    dyn_eval = read_split_file(os.path.join(split, "dynamic_eval_frames.txt"))
    assert dyn_eval == [vid.image_names[5]] and dyn_eval[0] not in train
    assert len(train) == len(vid.cameras) - 2

    scene = load_colmap_scene(src, CPU)
    jscene = j_load_scene(src)
    assert scene.image_names == jscene.image_names == vid.image_names
    np.testing.assert_allclose(scene.cameras_extent, jscene.cameras_extent, rtol=1e-6)
    for c, jc in zip(scene.cameras, jscene.cameras):
        for f in ("viewmat", "fx", "fy", "cx", "cy", "gt_image", "hand_mask", "obj_mask"):
            np.testing.assert_allclose(getattr(c, f).numpy(), np.asarray(getattr(jc, f)),
                                       atol=1e-6, err_msg=f)
    assert find_idx_by_image_name(scene.cameras, vid.image_names[3]) == 3
    assert find_idx_by_image_name(scene.cameras, "missing") == -1
    write_scene_artifacts(scene, str(tmp_path / "t"))
    j_write_artifacts(jscene, str(tmp_path / "j"))
    with open(tmp_path / "t" / "cameras.json") as ft, open(tmp_path / "j" / "cameras.json") as fj:
        tj, jj = json.load(ft), json.load(fj)
    for a, b in zip(tj, jj):
        assert a["img_name"] == b["img_name"] and a["width"] == b["width"]
        np.testing.assert_allclose(a["position"], b["position"], atol=1e-6)
        np.testing.assert_allclose(a["rotation"], b["rotation"], atol=1e-6)
    ply = "input.ply"
    assert (tmp_path / "t" / ply).read_bytes() == (tmp_path / "j" / ply).read_bytes()


def test_render_results_buckets(exported):
    """Every frame lands in its split's bucket; renders are quantized to 8
    bits and the hand plane comes along; render_novel_view at a frame's
    accumulated pose gives that frame's render."""
    vid, src, out = exported
    scene = load_colmap_scene(src, CPU)
    from egogaussian_tpu_torch.models.gaussians import load_ply
    from egogaussian_tpu_torch.models.pose import load_pose_sequence

    model = load_ply(os.path.join(out, "fine_all", "gaussians_all.ply"), CPU)
    seq, _ = load_pose_sequence(os.path.join(out, "interpolate_pose_coarse",
                                             "obj_pose_sequence.npz"), CPU)
    split = os.path.join(src, "split")
    kw = {k: read_split_file(os.path.join(split, f"{k}.txt"))
          for k in ("training_frames", "dynamic_eval_frames", "static_eval_frames")}
    buckets = render_results(scene.cameras, model, seq, **kw)
    names = {b: [e["name"] for e in v] for b, v in buckets.items()}
    assert names["dynamic_eval"] == kw["dynamic_eval_frames"]
    assert names["static_eval"] == kw["static_eval_frames"]
    assert names["training"] == kw["training_frames"] and not names["other"]
    e = buckets["dynamic_eval"][0]
    assert e["render"].shape == (3, 48, 64) and e["hand"].shape == (1, 48, 64)
    np.testing.assert_array_equal(np.round(e["render"] * 255) / 255, e["render"])
    assert e["render"].max() > 0.1
    f = vid.image_names.index(e["name"])
    novel = render_novel_view(model, scene.cameras[f], seq.accum_T()[f], seq.accum_R()[f])
    np.testing.assert_array_equal(_quantize8(novel), e["render"])


def _results_txt(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines, [float(ln.split(":")[1]) for ln in lines
                   if ln.startswith("  ") and "unavailable" not in ln]


def test_cli_eval_matches_jax(exported, tmp_path):
    """`cli.eval.main(["--device", "cpu", ...])` against JAX's
    `cli.eval.main` on the same directory, with random LPIPS weights from
    an npz: the same PNGs up to one quantization level, results.txt with
    the same lines, metrics within the stated bounds."""
    vid, src, out = exported
    outs = {}
    weights = str(tmp_path / "lpips_random.npz")
    lpips.save_lpips_weights(lpips.random_lpips_weights(0), weights)
    for tag in ("port", "jax"):
        outs[tag] = str(tmp_path / tag)
        shutil.copytree(out, outs[tag])
    tm = t_eval_main(["-s", src, "-m", outs["port"], "--device", "cpu",
                      "--lpips_weights", weights])
    jm = j_eval_main(["-s", src, "-m", outs["jax"], "--lpips_weights", weights])
    assert set(tm) == set(jm) == {"dynamic_eval", "static_eval"}
    bounds = dict(psnr=0.01, ssim=1e-4, lpips=1e-4)
    for bucket in tm:
        for k, tol in bounds.items():
            assert abs(tm[bucket][k] - jm[bucket][k]) <= tol, (bucket, k, tm[bucket], jm[bucket])
    from PIL import Image

    pngs = 0
    for bucket in ("training", "dynamic_eval", "static_eval"):
        d = os.path.join(outs["port"], "evaluation", bucket)
        for name in sorted(os.listdir(d)):
            a = np.asarray(Image.open(os.path.join(d, name)), np.int32)
            b = np.asarray(Image.open(os.path.join(outs["jax"], "evaluation", bucket, name)),
                           np.int32)
            assert np.abs(a - b).max() <= 1, name
            pngs += 1
    assert pngs == 2 * len(vid.cameras)
    tl, tv = _results_txt(os.path.join(outs["port"], "evaluation", "results.txt"))
    jl, jv = _results_txt(os.path.join(outs["jax"], "evaluation", "results.txt"))
    assert [ln.split(":")[0] for ln in tl] == [ln.split(":")[0] for ln in jl]
    assert len(tl) == 8 and tl[0] == "dynamic_eval" and tl[4] == "static_eval"
    for a, b, tol in zip(tv, jv, [1e-4, 0.01, 1e-4] * 2):
        assert abs(a - b) <= tol
