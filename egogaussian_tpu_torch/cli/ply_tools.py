"""PLY inspection CLI: recolor a saved checkpoint by label or generation.

Port of `egogaussian_tpu/cli/ply_tools.py`, with its palette; the output
PLY is byte-identical to JAX's. Runs on the host (CPU tensors).

Twin of reference `utils/ply_utils.py` (standalone tool for inspecting which
Gaussians the pipeline tagged as object / which densification cohort they
belong to, in any PLY viewer).

  python -m egogaussian_tpu_torch.cli.ply_tools recolor in.ply out.ply --by label
  python -m egogaussian_tpu_torch.cli.ply_tools recolor in.ply out.ply --by generation
  python -m egogaussian_tpu_torch.cli.ply_tools info in.ply
"""
from __future__ import annotations

import dataclasses
from argparse import ArgumentParser

import numpy as np
import torch

CPU = torch.device("cpu")

# distinct colors for generation cohorts
_PALETTE = np.array(
    [
        [0.90, 0.10, 0.10], [0.10, 0.70, 0.20], [0.15, 0.35, 0.95],
        [0.95, 0.75, 0.10], [0.65, 0.20, 0.80], [0.10, 0.80, 0.80],
        [0.95, 0.45, 0.10], [0.55, 0.55, 0.55],
    ],
    np.float32,
)


def recolor(in_path: str, out_path: str, by: str = "label") -> None:
    from egogaussian_tpu_torch.models.gaussians import load_ply, save_ply
    from egogaussian_tpu_torch.ops.sh import rgb_to_sh

    model = load_ply(in_path, CPU)
    if by == "label":
        is_obj = model.params.label[:, 0].numpy() > 0.5
        rgb = np.where(is_obj[:, None], _PALETTE[0][None, :], _PALETTE[7][None, :])
    elif by == "is_object":
        is_obj = model.aux.is_object.numpy() == 1
        rgb = np.where(is_obj[:, None], _PALETTE[0][None, :], _PALETTE[7][None, :])
    elif by == "generation":
        rgb = _PALETTE[model.aux.generation.numpy() % len(_PALETTE)]
    else:
        raise ValueError(f"--by must be label|is_object|generation, got {by}")
    f_dc = rgb_to_sh(torch.as_tensor(rgb))[:, None, :]
    model = dataclasses.replace(
        model, params=dataclasses.replace(model.params, features_dc=f_dc))
    save_ply(model, out_path)
    print(f"recolored by {by}: {out_path}")


def info(in_path: str) -> None:
    from egogaussian_tpu_torch.models.gaussians import load_ply

    m = load_ply(in_path, CPU)
    alive = m.aux.alive.numpy()
    print(f"points:      {int(alive.sum())}")
    print(f"objects:     {int((m.aux.is_object.numpy()[alive] == 1).sum())}")
    print(f"generations: {sorted(set(m.aux.generation.numpy()[alive].tolist()))}")
    op = 1.0 / (1.0 + np.exp(-m.params.opacity_logit.numpy()[alive, 0]))
    print(f"opacity:     mean {op.mean():.3f} min {op.min():.3f} max {op.max():.3f}")
    sc = np.exp(m.params.log_scales.numpy()[alive])
    print(f"scale:       mean {sc.mean():.4f} max {sc.max():.4f}")


def main(argv=None):
    parser = ArgumentParser(description="EgoGaussian PLY tools (PyTorch port)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_rec = sub.add_parser("recolor")
    p_rec.add_argument("input")
    p_rec.add_argument("output")
    p_rec.add_argument("--by", default="label",
                       choices=["label", "is_object", "generation"])
    p_info = sub.add_parser("info")
    p_info.add_argument("input")
    args = parser.parse_args(argv)
    if args.cmd == "recolor":
        recolor(args.input, args.output, args.by)
    else:
        info(args.input)


if __name__ == "__main__":
    main()
