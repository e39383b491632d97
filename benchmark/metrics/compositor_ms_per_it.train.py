"""Device ms of the hand-written compositor kernels per iteration."""
from benchmark.core import readers


def read(m):
    return readers.device_ms_per_unit(m, True)
