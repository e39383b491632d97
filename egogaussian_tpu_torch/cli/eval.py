"""Evaluation CLI: port of `egogaussian_tpu/cli/eval.py` (twin of reference
`eval.py`: stages 1-5 replaced by saved artifact paths, then render +
metrics; eval.py:57-111).

  python -m egogaussian_tpu_torch.cli.eval -s <dataset> -m <output_dir> \
      [--variant coarse] [--lpips_weights f.npz] [--device cuda]

Reads <output_dir>/fine_all/gaussians_all.ply and
<output_dir>/interpolate_pose_<variant>/obj_pose_sequence.npz; writes
<output_dir>/evaluation/<bucket>/*.png and results.txt. Runs on the card
unless `--device cpu` is given.
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

import torch

from egogaussian_tpu_torch.config import add_config_args, extract_config
from egogaussian_tpu_torch.data.readers import load_colmap_scene, read_split_file
from egogaussian_tpu_torch.eval.render_results import calculate_metric, render_results
from egogaussian_tpu_torch.models.gaussians import load_ply
from egogaussian_tpu_torch.models.pose import load_pose_sequence
from egogaussian_tpu_torch.utils.console import CONSOLE


def main(argv=None):
    parser = ArgumentParser(description="EgoGaussian evaluation (PyTorch port)")
    add_config_args(parser)
    parser.add_argument("--lpips_weights", default=None)
    parser.add_argument(
        "--variant", default="coarse", choices=["static", "coarse"],
        help="which interpolate_pose variant to evaluate (eval.py:57-84)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render and score on (default: cuda)")
    args = parser.parse_args(argv)
    cfg = extract_config(args)
    device = torch.device(args.device)
    # float32 convolutions (SSIM, LPIPS) stay float32 on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    src = cfg.model.source_path
    out = cfg.model.model_path or os.path.join(src, "output")
    split_dir = os.path.join(src, "split")
    training_frames = read_split_file(os.path.join(split_dir, "training_frames.txt"))
    dynamic_eval = read_split_file(os.path.join(split_dir, "dynamic_eval_frames.txt"))
    static_eval = read_split_file(os.path.join(split_dir, "static_eval_frames.txt"))

    scene = load_colmap_scene(src, device, cfg.model.images, cfg.model.resolution)

    # hardcoded artifact layout, like reference eval.py
    final_ply = os.path.join(out, "fine_all", "gaussians_all.ply")
    pose_path = os.path.join(out, f"interpolate_pose_{args.variant}", "obj_pose_sequence.npz")
    CONSOLE.print(f"Loading model {final_ply} + poses {pose_path}")
    model = load_ply(final_ply, device, spatial_lr_scale=scene.cameras_extent)
    pose_seq, _ = load_pose_sequence(pose_path, device)

    lpips_fn = None
    if args.lpips_weights:
        from egogaussian_tpu_torch.eval.lpips import LPIPS

        lpips_fn = LPIPS(weights_path=args.lpips_weights, device=device)

    eval_dir = os.path.join(out, "evaluation")
    buckets = render_results(
        scene.cameras, model, pose_seq,
        training_frames=training_frames,
        dynamic_eval_frames=dynamic_eval,
        static_eval_frames=static_eval,
        save_dir=eval_dir, backend=cfg.render.backend,
    )
    metrics = calculate_metric(buckets, save_dir=eval_dir, lpips_fn=lpips_fn, device=device)
    CONSOLE.print("Metrics:", metrics)
    return metrics


if __name__ == "__main__":
    main()
