"""Device ms of every other kernel, copy and fill per iteration."""
from benchmark.core import readers


def read(m):
    return readers.device_ms_per_unit(m, False)
