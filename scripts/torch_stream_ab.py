#!/usr/bin/env python3
"""Time the stream compositor pair of one checkout of the PyTorch port on
the card, at the timing shapes of chip_smoke.py: the kNN-initialized
~102k-Gaussian model on frame 0 of the slice's 640x480 video, at 640x480
with its auto tile config (ts 32), at 640x480 with no tile config (ts 16,
the default slot capacity) and at 1920x1080 (chip_smoke.frame_1080), D = 3
and 1.

Run from the root of a checkout, on a machine with a CUDA card:
    python3 scripts/torch_stream_ab.py [--root DIR] [--label NAME]
--root times the package and chip_smoke.py helpers of another checkout
(for example the parent commit unpacked from `git archive` into a
gitignored directory), so that two versions are compared on one card in
one call, in turns: parent, change, change, parent. Each checkout builds
its own kernel library under its own build/kernels/.

Prints one JSON line per (configuration, D): forward and backward ms
(CUDA events, chip_smoke.cuda_ms) and the layout's shape, with sums of
the written tiles' image and of the gradient's magnitude, which agree
between two versions of the same function to rounding; then the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
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
        print("torch_stream_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from egogaussian_tpu_torch.data.synthetic import make_synthetic_video
    from egogaussian_tpu_torch.render import stream_raster as sr
    from egogaussian_tpu_torch.render.project import project_gaussians
    from egogaussian_tpu_torch.render.tiled import TileConfig, stream_layout
    from egogaussian_tpu_torch.train.common import auto_tile_config, model_colors

    if os.path.dirname(os.path.abspath(sr.__file__)) != os.path.join(
            root, "egogaussian_tpu_torch", "render"):
        raise RuntimeError(f"imported {sr.__file__}, not the package under {root}")
    dev = torch.device("cuda", 0)
    vid = make_synthetic_video(dev, **cs.SLICE_VIDEO)
    model = cs.knn_model(dev, vid, cs.nerfpp_radius(vid.cameras))
    opac = torch.where(model.aux.alive, model.opacity, torch.zeros_like(model.opacity))
    cam0 = vid.cameras[0]
    cam1080 = cs.frame_1080(cam0)
    cases = (("main", cam0, auto_tile_config(model, cam0)), ("eval_config", cam0, TileConfig()),
             ("frame_1080", cam1080, auto_tile_config(model, cam1080)))
    for kind, cam, cfg in cases:
        proj = project_gaussians(model.params.xyz, model.covariance(), cam.viewmat, cam.fx,
                                 cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                                 valid_mask=model.aux.alive)
        cfg = dataclasses.replace(cfg, compositor="stream")
        for d, cols in ((3, model_colors(model)), (1, model.params.label)):
            bg2 = torch.zeros((1, d), device=dev)
            lay = stream_layout(proj, cols, opac, cam.width, cam.height, cfg)
            meta, vals = lay.meta, lay.vals.detach().contiguous()
            ts, n_tx, n_tiles = lay.tile_size, lay.n_tx, lay.n_tx * lay.n_ty
            with torch.no_grad():
                out = sr.stream_forward(meta, vals, bg2, ts, n_tx, n_tiles)
                gen = torch.Generator(device=dev).manual_seed(1)
                cot = [torch.randn(x.shape, generator=gen, device=dev) * 1e-3 for x in out[:3]]
                grad = sr.stream_backward(meta, vals, bg2, out[3], *cot, ts, n_tx)
                fwd_ms = cs.cuda_ms(lambda: sr.stream_forward(meta, vals, bg2, ts, n_tx, n_tiles))
                bwd_ms = cs.cuda_ms(lambda: sr.stream_backward(meta, vals, bg2, out[3], *cot, ts,
                                                               n_tx))
            real = ~lay.empty
            print(json.dumps({
                "label": args.label, "config": kind, "frame": f"{cam.width}x{cam.height}",
                "d": d, "tile_size": ts, "tiles": n_tiles, "slots": int(meta.shape[1]),
                "real_slots": int(meta[1].lt(meta[2]).sum()), "dropped": int(lay.dropped),
                "stream_fwd_ms": fwd_ms, "stream_bwd_ms": bwd_ms,
                "image_sum": float(out[0][real].double().sum()),
                "grad_abs_sum": float(grad.double().abs().sum())}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
