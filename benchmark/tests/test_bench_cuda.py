"""One short run of every cell on the card (skips without one):
    python -m pytest -p no:cacheprovider -o addopts="" benchmark/tests/test_bench_cuda.py
"""
import io

import pytest
import torch

from benchmark.core.spec import benchmark


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in benchmark()["workloads"]])
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import benchmark.run as run
    from benchmark.core.spec import Cell

    res = run.run_cell(Cell(cell), 2 ** 31 + 5, 2.0, False, torch.device("cuda", 0),
                       log=io.StringIO())
    assert res is not None and res["correct"], res and res["checks"]
    assert res["device"]["platform"] == "gpu"
