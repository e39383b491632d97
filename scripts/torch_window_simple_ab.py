#!/usr/bin/env python3
"""Time the simple windowed compositor pair (make_tile_compositor's
kernels) of one checkout of the PyTorch port on the card, at the timing
shapes of chip_smoke.py: the kNN-initialized ~102k-Gaussian model on
frame 0 of the slice's 640x480 video, at 640x480 with its auto tile
config (ts 32), at 640x480 with evaluation's config (no tile config:
ts 16, the window of make_tile_compositor's path in chip_smoke.py) and at
1920x1080 (chip_smoke.frame_1080), D = 3 and 1.

Run from the root of a checkout, on a machine with a CUDA card:
    python3 scripts/torch_window_simple_ab.py [--root DIR] [--label NAME]
--root times the package and chip_smoke.py helpers of another checkout
(for example the parent commit unpacked from `git archive` into a
gitignored directory), so that two versions are compared on one card in
one call, in turns: parent, change, change, parent. Each checkout builds
its own kernel library under its own build/kernels/.

Prints one JSON line per (configuration, D): forward and backward ms
(CUDA events, chip_smoke.cuda_ms) and the window's shape; then the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=here, help="checkout whose package is timed")
    parser.add_argument("--label", default="this", help="name printed with each line")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("torch_window_simple_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from egogaussian_tpu_torch.data.synthetic import make_synthetic_video
    from egogaussian_tpu_torch.render import window_raster as wr
    from egogaussian_tpu_torch.render.project import project_gaussians
    from egogaussian_tpu_torch.render.tiled import window_layout
    from egogaussian_tpu_torch.train.common import auto_tile_config, model_colors

    if os.path.dirname(os.path.abspath(wr.__file__)) != os.path.join(
            root, "egogaussian_tpu_torch", "render"):
        raise RuntimeError(f"imported {wr.__file__}, not the package under {root}")
    dev = torch.device("cuda", 0)
    vid = make_synthetic_video(dev, **cs.SLICE_VIDEO)
    model = cs.knn_model(dev, vid, cs.nerfpp_radius(vid.cameras))
    opac = torch.where(model.aux.alive, model.opacity, torch.zeros_like(model.opacity))
    cam0 = vid.cameras[0]
    cam1080 = cs.frame_1080(cam0)
    cases = (("main", cam0, auto_tile_config(model, cam0)), ("eval_config", cam0, None),
             ("frame_1080", cam1080, auto_tile_config(model, cam1080)))
    for kind, cam, cfg in cases:
        proj = project_gaussians(model.params.xyz, model.covariance(), cam.viewmat, cam.fx,
                                 cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                                 valid_mask=model.aux.alive)
        for d, cols in ((3, model_colors(model)), (1, model.params.label)):
            bg2 = torch.zeros((1, d), device=dev)
            lay = window_layout(proj, cols, opac, cam.width, cam.height, cfg)
            parts = cs.split_window(lay)
            ts, n_tx = lay.tile_size, lay.n_tx
            with torch.no_grad():
                out = wr.window_forward(*parts, bg2, ts, n_tx)
                gen = torch.Generator(device=dev).manual_seed(1)
                cot = [torch.randn(x.shape, generator=gen, device=dev) * 1e-3 for x in out]
                grads = wr.window_backward(*parts, bg2, *cot, ts, n_tx)
                fwd_ms = cs.cuda_ms(lambda: wr.window_forward(*parts, bg2, ts, n_tx))
                bwd_ms = cs.cuda_ms(lambda: wr.window_backward(*parts, bg2, *cot, ts, n_tx))
            print(json.dumps({
                "label": args.label, "config": kind, "frame": f"{cam.width}x{cam.height}",
                "d": d, "tile_size": ts, "tiles": int(lay.counts.shape[0]),
                "window_rows": int(parts[0].shape[1]), "pairs": int(lay.counts.sum()),
                "deepest_tile": int(lay.counts.max()), "dropped": int(lay.dropped),
                "window_fwd_ms": fwd_ms, "window_bwd_ms": bwd_ms,
                # the same function in both versions: these sums agree to rounding
                "image_sum": float(out[0].double().sum()),
                "grad_abs_sum": sum(float(g.double().abs().sum()) for g in grads)}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
