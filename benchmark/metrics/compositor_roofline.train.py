"""The compositor's share of its roofline in training, percent."""
from benchmark.core import readers


def read(m):
    return readers.compositor_roofline(m)
