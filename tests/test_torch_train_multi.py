"""The multi-video training CLI (`cli/train_multi.py`) on two 64x48 videos
exported in the reference's dataset layout (seeds 0 and 1, 3 and 2
dynamic frames), at test_train_cli_on_exported_dataset's tiny schedule,
with --device cpu:

  * each video's output tree equals the per-video training CLI's (cli.train
    with --seed <seed + i>) file for file, every PLY, pose file, mask,
    evaluation image and results.txt byte for byte (cfg_args.json names
    its own paths, metrics.jsonl its own timings);
  * a --resume rerun trains nothing and scores the same;
  * --stage1_only stops after stage 1.2 and --through_coarse after stage 2,
    where JAX's CLI stops, and run_pipeline refuses any other stop;
  * --mesh beyond 1x1 and a videos / outputs mismatch are refused;
  * the CLI runs on the card unless told otherwise.

The comparison with JAX's training CLI per video (interpret-mode Pallas,
every densify window empty so that no split noise is drawn) is marked
slow, like JAX's multi-video CLI test.
"""
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from egogaussian_tpu_torch.cli import train as train_cli
from egogaussian_tpu_torch.cli import train_multi
from egogaussian_tpu_torch.cli.train import main as train_main
from egogaussian_tpu_torch.data import make_synthetic_video
from egogaussian_tpu_torch.data.export_colmap import export_colmap_dataset
from egogaussian_tpu_torch.pipeline import run_pipeline

torch.set_num_threads(1)
CPU = torch.device("cpu")
SCHEDULE = [
    "--s_std_train_iter", "12", "--s_entropy_reg_iter", "4", "--s_label_train_iter", "10",
    "--s_densify_until_iter", "0", "--s_label_lr", "0.1",
    "--b_std_train_iter", "8", "--b_entropy_reg_iter", "2", "--b_densify_until_iter", "0",
    "--c_warm_up_iter", "4", "--c_total_num_iter", "6", "--c_densify_from_iter", "100",
    "--c_densify_until_iter", "0",
    "--f_total_num_iter", "6", "--f_densify_from_iter", "100", "--f_densify_until_iter", "3",
    "--a_total_num_iter", "6",
    "--opacity_lr", "0.5",
]
STAGES = {"static", "background", "coarse", "fine_obj/from-static", "fine_obj/from-coarse",
          "interpolate", "fine_all", "eval"}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    return [export_colmap_dataset(
        make_synthetic_video(CPU, width=64, height=48, n_bg=150, n_obj=40, frames_static=3,
                             frames_dynamic=d, seed=s), str(root / f"video{s}"))
        for s, d in ((0, 3), (1, 2))]


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _records(out):
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _scores(path):
    """{bucket: {"ssim", "psnr"}} from a results.txt (a bucket's name, then
    its indented "SSIM : x" / "PSNR : x" lines)."""
    scores, bucket = {}, None
    with open(path) as f:
        for line in f:
            if not line.startswith(" "):
                bucket = line.strip()
                scores[bucket] = {}
            elif line.split(":")[0].strip() in ("SSIM", "PSNR"):
                key, value = line.split(":", 1)
                scores[bucket][key.strip().lower()] = float(value)
    return scores


def _multi(datasets, outs, *flags):
    return train_multi.main(["--videos", *datasets, "--outputs", *outs, "--device", "cpu",
                             "--seed", "0", *flags] + SCHEDULE)


def test_train_multi_equals_per_video_train_cli(datasets, tmp_path):
    outs = [str(tmp_path / f"multi{i}") for i in range(2)]
    assert _multi(datasets, outs, "--mesh", "1x1") == 0
    for i, (src, out) in enumerate(zip(datasets, outs)):
        single = str(tmp_path / f"single{i}")
        res = train_main(["-s", src, "-m", single, "--device", "cpu", "--seed", str(i)]
                         + SCHEDULE)
        tree = _tree(out)
        assert tree == _tree(single)
        assert "fine_all/gaussians_all.ply" in tree and "evaluation/results.txt" in tree
        differ = [f for f in tree if f not in ("cfg_args.json", "logs/metrics.jsonl")
                  and not filecmp.cmp(os.path.join(out, f), os.path.join(single, f),
                                      shallow=False)]
        assert not differ, (i, differ)
        with open(os.path.join(out, "cfg_args.json")) as f:
            saved = json.load(f)
        assert saved["model"]["source_path"] == src and saved["model"]["model_path"] == out
        assert saved["static"]["label_lr"] == 0.1
        timed = [r for r in _records(out) if r.get("event") == "stage_time"]
        assert {r["name"] for r in timed} == STAGES and not any(r["resumed"] for r in timed)
        ends = [r["stage"] for r in _records(out) if r.get("event") == "stage_end"]
        assert ends == [r["stage"] for r in _records(single) if r.get("event") == "stage_end"]
        assert res.metrics  # the per-video run scored

    # --resume: every stage's files exist, nothing trains, the same scores
    before = [len(_records(out)) for out in outs]
    assert _multi(datasets, outs, "--resume") == 0
    for out, n in zip(outs, before):
        later = _records(out)[n:]
        assert {r["stage"] for r in later} == {"pipeline"}
        assert all(r["resumed"] for r in later if r.get("event") == "stage_time"
                   and r["name"] not in ("interpolate", "eval"))
    for i, out in enumerate(outs):
        assert filecmp.cmp(os.path.join(out, "evaluation", "results.txt"),
                           os.path.join(tmp_path / f"single{i}", "evaluation", "results.txt"),
                           shallow=False)


def test_stage1_only_and_through_coarse_stop_where_jax_does(datasets, tmp_path):
    outs = [str(tmp_path / f"out{i}") for i in range(2)]
    assert _multi(datasets, outs, "--stage1_only") == 0
    for out in outs:
        assert os.path.exists(os.path.join(out, "static", "ply", "static_phase1_obj.ply"))
        assert os.path.exists(os.path.join(out, "background", "static_bg.ply"))
        assert not os.path.exists(os.path.join(out, "coarse"))
    n = [len(_records(out)) for out in outs]
    assert _multi(datasets, outs, "--through_coarse", "--resume") == 0
    for out, k in zip(outs, n):
        later = _records(out)[k:]
        assert {r["stage"] for r in later} == {"pipeline", "coarse"}  # stages 1.x loaded
        with np.load(os.path.join(out, "coarse", "obj_pose_sequence.npz")) as z:
            assert z["solved"].sum() >= 3
        assert os.path.exists(os.path.join(out, "coarse", "ply", "gaussians_final.ply"))
        assert not os.path.exists(os.path.join(out, "fine_obj"))


def test_run_pipeline_refuses_an_unknown_stop(tmp_path):
    with pytest.raises(ValueError, match="stop_after"):
        run_pipeline(None, None, str(tmp_path / "out"), device=CPU, stop_after="fine_obj")
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x4", "one"])
def test_meshes_beyond_1x1_are_refused(datasets, tmp_path, mesh):
    with pytest.raises(SystemExit):
        train_multi.main(["--videos", *datasets, "--outputs", str(tmp_path / "a"),
                          str(tmp_path / "b"), "--device", "cpu", "--mesh", mesh])
    assert not os.path.exists(tmp_path / "a")


def test_videos_and_outputs_must_pair(datasets, tmp_path):
    with pytest.raises(SystemExit):
        train_multi.main(["--videos", *datasets, "--outputs", str(tmp_path / "a"),
                          "--device", "cpu"])
    assert not os.path.exists(tmp_path / "a")


class _Placed(Exception):
    """Raised by the stubs at the first tensor placement."""


def test_cli_defaults_to_the_card(monkeypatch, datasets):
    """With no --device the CLI reaches its first tensor placement
    (load_colmap_scene: stubbed here, so no card is needed) as
    torch.device("cuda")."""
    seen = []

    def stub(src, device, *rest):
        seen.append(device)
        raise _Placed

    monkeypatch.setattr(train_cli, "load_colmap_scene", stub)
    with pytest.raises(_Placed):
        train_multi.main(["--videos", datasets[0], "--outputs",
                          os.path.join(os.path.dirname(datasets[0]), "default_out")])
    assert seen == [torch.device("cuda")]


@pytest.mark.slow
def test_train_multi_matches_jax_per_video(datasets, tmp_path):
    """Each video of the port's multi-video CLI against JAX's training CLI
    on the same dataset with seed + i (the single-video pipeline JAX's own
    multi-video test holds its lockstep to), both on their default
    backends; every densify window of SCHEDULE is empty, so no split noise
    is drawn. Bounds, each beside the largest error of a CPU run: PLY
    params 5e-5 (measured 2.5e-5) but opacity logits 5e-3, poses 1e-6
    (1.2e-7), PSNR 1e-3 dB (2.7e-4), SSIM 5e-5 (1.5e-5). Video 0 sits
    within test_torch_pipeline.py::test_pipeline_matches_jax's bounds
    (opacity logits 7.1e-6). Video 1's static phase-1 and background
    opacity logits part by up to 1.4e-4 (float rounding under this
    schedule's opacity_lr of 0.5; test_torch_fine.py measured 1.2e-4 for
    the background at that rate), and stage 5's Adam at that rate carries
    them to 3.6e-3 on one background Gaussian's logit, which moves the
    scores."""
    from egogaussian_tpu.cli.train import main as j_train_main
    from egogaussian_tpu_torch.utils.ply import read_ply

    outs = [str(tmp_path / f"multi{i}") for i in range(2)]
    assert _multi(datasets, outs) == 0
    for i, (src, out) in enumerate(zip(datasets, outs)):
        jout = str(tmp_path / f"jax{i}")
        j_train_main(["-s", src, "-m", jout, "--seed", str(i)] + SCHEDULE)
        assert _tree(out) == _tree(jout)
        for ply in ("static/ply/static_phase0_obj.ply", "background/static_bg.ply",
                    "fine_obj/from-coarse/gaussians_fine.ply", "fine_all/gaussians_all.ply"):
            vj, _ = read_ply(os.path.join(jout, ply))
            vt, _ = read_ply(os.path.join(out, ply))
            assert len(vt["x"]) == len(vj["x"]) > 0, ply
            for k in vj:
                np.testing.assert_allclose(vt[k], vj[k], atol=5e-3 if k == "opacity" else 5e-5,
                                           rtol=0, err_msg=f"video {i} {ply}: {k}")
        for variant in ("static", "coarse"):
            path = os.path.join(f"interpolate_pose_{variant}", "obj_pose_sequence.npz")
            with np.load(os.path.join(jout, path)) as zj, np.load(os.path.join(out, path)) as zt:
                np.testing.assert_array_equal(zt["solved"], zj["solved"])
                for k in ("translations", "rotations"):
                    np.testing.assert_allclose(zt[k], zj[k], atol=1e-6, rtol=0,
                                               err_msg=f"video {i} {k}")
        mj = _scores(os.path.join(jout, "evaluation", "results.txt"))
        mt = _scores(os.path.join(out, "evaluation", "results.txt"))
        assert set(mt) == set(mj) == {"dynamic_eval", "static_eval"}
        for bucket, m in mj.items():
            assert abs(mt[bucket]["psnr"] - m["psnr"]) < 1e-3, (i, bucket)
            assert abs(mt[bucket]["ssim"] - m["ssim"]) < 5e-5, (i, bucket)
