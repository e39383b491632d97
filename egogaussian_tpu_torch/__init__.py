"""EgoGaussian in PyTorch with hand-written CUDA kernels for Hopper.

The port of `egogaussian_tpu` (JAX + Pallas). Module paths mirror the JAX
package so each counterpart is easy to find; the JAX package stays the
reference every module here is tested against. This package imports
`torch` and never `jax`.

Layer map:
  ops/       tensor math (quaternion, covariance, SH, losses, exact kNN)
  render/    projection, tile binning, chunk-padded pair layout and the
             tile-grid compositor (CUDA kernels in csrc/, plain twins in
             render/cuda_raster.py), plus the all-pairs oracle
  models/    Gaussian model as a capacity + alive-mask dataclass of
             tensors; densify/prune; Adam with moment surgery
  data/      frame batches with uint8 planes, synthetic video
  train/     stage-1.0 static training
"""

__version__ = "0.1.0"
