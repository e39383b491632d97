"""Console logging (rich when installed, else a plain timestamped print)."""
from __future__ import annotations

try:
    from rich.console import Console

    CONSOLE = Console()
except ImportError:  # pragma: no cover
    import sys
    import time

    class _PlainConsole:
        def log(self, *args, **kwargs):
            ts = time.strftime("%H:%M:%S")
            print(f"[{ts}]", *args, file=sys.stderr)

        def print(self, *args, **kwargs):
            print(*args)

    CONSOLE = _PlainConsole()


def safe_state(seed: int = 0):
    """Seed every host RNG the package uses (reference safe_state,
    utils/general_utils.py:158-179). Returns a torch.Generator seeded
    with `seed`."""
    import random

    import numpy as np
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
