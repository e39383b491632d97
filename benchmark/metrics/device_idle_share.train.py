"""Share of the traced window with nothing running on the device, percent."""
from benchmark.core import readers


def read(m):
    return readers.idle_share(m)
