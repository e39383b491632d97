"""EgoGaussian in PyTorch with hand-written CUDA kernels for Hopper.

The port of `egogaussian_tpu` (JAX + Pallas). Module paths mirror the JAX
package so each counterpart is easy to find; the JAX package stays the
reference every module here is tested against. This package imports
`torch` and never `jax`.

Layer map:
  ops/       tensor math (quaternion, covariance, 6D rotation, SE(3), SH,
             losses, exact kNN)
  render/    projection, tile binning, chunk-padded pair layouts, crop
             windows and the two compositor kernel pairs: tile-grid
             (render/cuda_raster.py) and stream (render/stream_raster.py),
             CUDA kernels in csrc/ with plain twins beside them; plus the
             all-pairs oracle
  models/    Gaussian model as a capacity + alive-mask dataclass of
             tensors; densify/prune; Adam with moment surgery; object
             pose and pose sequences
  data/      frame batches with uint8 planes, synthetic video
  train/     stage-1.0 static training, stage-2 coarse object pose
"""

__version__ = "0.1.0"
