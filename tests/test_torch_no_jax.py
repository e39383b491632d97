"""The PyTorch port imports without JAX: every module of egogaussian_tpu_torch
is imported in a fresh interpreter in which `import jax` fails."""
import os
import pkgutil
import subprocess
import sys

import torch

import egogaussian_tpu_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    pkg = egogaussian_tpu_torch
    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + "."):
        names.append(info.name)
    return sorted(names)


def test_port_modules_found():
    names = _port_modules()
    for expected in ("egogaussian_tpu_torch.render.cuda_raster",
                     "egogaussian_tpu_torch.train.static",
                     "egogaussian_tpu_torch.models.densify"):
        assert expected in names


def test_every_module_imports_without_jax():
    script = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['egogaussian_tpu'] = None\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "leaked = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'egogaussian_tpu') and sys.modules[m] is not None]\n"
        "assert not leaked, leaked\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_no_jax_import_statements():
    """No source file of the port names jax or the JAX package in an import."""
    root = os.path.join(REPO, "egogaussian_tpu_torch")
    bad = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    s = line.strip()
                    if s.startswith(("import ", "from ")):
                        mod = s.split()[1]
                        if mod.split(".")[0] in ("jax", "jaxlib", "egogaussian_tpu"):
                            bad.append(f"{path}:{i}: {s}")
    assert not bad, bad
