"""Tiny sizes of the benchmark's cells for CPU tests (not a test module)."""
import torch

from benchmark.core.spec import Cell

TINY = dict(width=96, height=64, frames=6, gaussians=600, densification_interval=4, percent_dense=0.25,
            gt_scene={"gt_background": 300, "gt_object": 60})
SEED = 2 ** 31 + 17  # beyond 32 signed bits: seeds may be that large


def tiny_cell(name: str, root=None) -> Cell:
    cell = Cell(name) if root is None else Cell(name, root=str(root))
    for k, v in TINY.items():
        if k in cell.config:
            cell.config[k] = v
    cell.traffic["warmup_steps"] = cell.config["densification_interval"] + 1
    cell.traffic["trace_steps"] = 3
    return cell


def run_tiny(name: str, root=None, seconds: float = 0.3, trace: bool = False, log=None):
    import io

    import benchmark.run as run

    cell = tiny_cell(name, root)
    return run.run_cell(cell, SEED, seconds, trace, torch.device("cpu"), log=log or io.StringIO())
