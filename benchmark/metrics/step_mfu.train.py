"""The whole step's counted FLOPs over the window at the float32 peak, percent."""
from benchmark.core import readers


def read(m):
    return readers.mfu(m)
