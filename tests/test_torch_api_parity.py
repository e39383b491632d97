"""API parity of the port with the JAX package: every name a package
`__init__` of egogaussian_tpu re-exports is importable from the same
package of egogaussian_tpu_torch, and every public name of JAX's
utils/logging.py from the port's. The JAX files are read as text (ast),
not imported. Names the port lacks would be listed below, so that no gap
can open silently; since the scene lockstep (ROADMAP.md §A item 11) the
list is empty."""
import ast
import importlib
import os
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "egogaussian_tpu")

NOT_YET = {}


def _packages():
    return sorted(d for d in os.listdir(JAX_PKG)
                  if os.path.exists(os.path.join(JAX_PKG, d, "__init__.py")))


def _exported(path):
    """Names bound at the top level of a module by imports and assignments."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.ImportFrom, ast.Import)):
            names.update(a.asname or a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return {n for n in names if not n.startswith("_") or n == "__version__"}


@pytest.mark.parametrize("sub", [""] + _packages())
def test_init_reexports_match_jax(sub):
    jax_names = _exported(os.path.join(JAX_PKG, sub, "__init__.py"))
    module = importlib.import_module("egogaussian_tpu_torch" + (f".{sub}" if sub else ""))
    missing = sorted(n for n in jax_names - NOT_YET.get(sub, set()) if not hasattr(module, n))
    assert not missing, missing
    # the exceptions are still missing, so the list cannot go stale
    assert not [n for n in NOT_YET.get(sub, ()) if hasattr(module, n)]


def test_logging_names_match_jax():
    from egogaussian_tpu_torch.utils import logging

    with open(os.path.join(JAX_PKG, "utils", "logging.py")) as f:
        defined = {n.name for n in ast.parse(f.read()).body
                   if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.name[0] != "_"}
    assert {"get_active_logger", "trace", "StepTimer"} <= defined
    assert not sorted(n for n in defined if not hasattr(logging, n))


def test_step_timer_leaves_out_the_warmup():
    """Two warm-up steps, the first slow, then three 10 ms steps: the rate
    is the three steps' (counting the warm-up it would be below 20/s)."""
    from egogaussian_tpu_torch.utils.logging import StepTimer

    timer = StepTimer(warmup=2)
    time.sleep(0.3)
    assert timer.tick() is None
    time.sleep(0.01)
    assert timer.tick() is None and timer.steps_per_sec is None
    for _ in range(3):
        time.sleep(0.01)
        assert timer.tick() is not None
    assert 20 < timer.steps_per_sec < 101


def test_trace_writes_a_trace_directory(tmp_path):
    from egogaussian_tpu_torch.utils.logging import get_active_logger, trace

    assert get_active_logger() is None
    with trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    files = os.listdir(tmp_path / "trace")
    assert files and all(f.endswith(".json") for f in files)
