"""EgoGaussian in PyTorch with hand-written CUDA kernels for Hopper.

The port of `egogaussian_tpu` (JAX + Pallas). Module paths mirror the JAX
package so each counterpart is easy to find; the JAX package stays the
reference every module here is tested against. This package imports
`torch` and never `jax`.

Layer map:
  ops/       tensor math (quaternion, covariance, 6D rotation, SE(3), SH,
             losses, exact kNN)
  render/    projection, tile binning, the per-tile gather window and the
             chunk-padded pair layouts, crop windows and the compositor
             kernel pairs: tile-grid (render/cuda_raster.py), stream
             (render/stream_raster.py) and windowed, chunked and simple
             (render/window_raster.py), CUDA kernels in csrc/ with plain
             twins beside them; plus the all-pairs oracle
  models/    Gaussian model as a capacity + alive-mask dataclass of
             tensors; densify/prune; Adam with moment surgery; object
             pose and pose sequences
  data/      COLMAP files and scene loading, frame batches with uint8
             planes, synthetic video and its export as a dataset
  train/     stage 1.0 static and 1.2 background training, stage-2 coarse
             object pose, stage-3 object fine-tuning, stage-5 scene
             fine-tuning; mid-stage checkpoints (ckpt_hook.py)
  eval/      stage-6 evaluation: render_results, hand-masked metrics, LPIPS;
             the trajectory / novel-view viewers and the SIBR network viewer
  pipeline   the six stages in order, with resume from each stage's files
             and from mid-stage checkpoints
  cli/       the training, multi-video training and eval entry points and
             the PLY tools (python -m egogaussian_tpu_torch.cli.train /
             .cli.train_multi / .cli.eval / .cli.ply_tools)
  utils/     PLY files (with the shared native reader, native_io.py),
             checkpoint files, metrics logging, montages, the FMA-peak probe
"""

__version__ = "0.1.0"
