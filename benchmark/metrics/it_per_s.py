"""Schedule iterations completed in the window, summed over the videos, per second."""
from benchmark.core import readers


def read(m):
    return readers.rate(m)
