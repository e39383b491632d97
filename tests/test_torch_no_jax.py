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
                     "egogaussian_tpu_torch.models.densify",
                     "egogaussian_tpu_torch.render.stream_raster",
                     "egogaussian_tpu_torch.render.crop",
                     "egogaussian_tpu_torch.models.pose",
                     "egogaussian_tpu_torch.ops.se3",
                     "egogaussian_tpu_torch.ops.rotation6d",
                     "egogaussian_tpu_torch.train.coarse_pose",
                     "egogaussian_tpu_torch.render.window_raster",
                     "egogaussian_tpu_torch.eval.metrics",
                     "egogaussian_tpu_torch.eval.lpips",
                     "egogaussian_tpu_torch.eval.render_results",
                     "egogaussian_tpu_torch.data.colmap",
                     "egogaussian_tpu_torch.data.export_colmap",
                     "egogaussian_tpu_torch.cli.eval",
                     "egogaussian_tpu_torch.utils.peak",
                     "egogaussian_tpu_torch.render.probe_layouts",
                     "egogaussian_tpu_torch.train.fine_obj",
                     "egogaussian_tpu_torch.train.fine_all",
                     "egogaussian_tpu_torch.pipeline",
                     "egogaussian_tpu_torch.cli.train",
                     "egogaussian_tpu_torch.utils.checkpoint",
                     "egogaussian_tpu_torch.train.ckpt_hook",
                     "egogaussian_tpu_torch.eval.viewer",
                     "egogaussian_tpu_torch.eval.network_viewer",
                     "egogaussian_tpu_torch.utils.visualize",
                     "egogaussian_tpu_torch.utils.native_io",
                     "egogaussian_tpu_torch.cli.ply_tools",
                     "egogaussian_tpu_torch.cli.train_multi"):
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


def test_peak_module_imports_without_jax_triton_or_bench():
    """The FMA-peak probe is the port of bench.py's `_vpu_peak_gflops`; it
    keeps its own copy of what it needs and builds its kernel with nvcc."""
    script = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'egogaussian_tpu', 'triton', 'bench'):\n"
        "    sys.modules[m] = None\n"
        "importlib.import_module('egogaussian_tpu_torch.utils.peak')\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
