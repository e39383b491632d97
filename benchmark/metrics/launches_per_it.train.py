"""CUDA kernels of the traced window per iteration."""
from benchmark.core import readers


def read(m):
    return readers.launches_per_unit(m)
