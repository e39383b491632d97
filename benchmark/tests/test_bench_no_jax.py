"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's); the reference and the input generator load nothing of the
port either."""
import ast
import json
import os
import shutil
import subprocess
import sys

from benchmark.core.spec import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "egogaussian_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmark", sub)):
        for f in files:
            if f.endswith(".py") and "tests" not in dirpath.split(os.sep):
                yield os.path.join(dirpath, f)


def test_sources_import_no_jax():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_and_inputs_import_no_program():
    for sub in ("reference", "inputs"):
        for path in _sources(sub):
            names = set(_imports(path))
            assert "egogaussian_tpu_torch" not in names and not names & FORBIDDEN, path


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.tests.bench_tiny import run_tiny\n"
            "res = run_tiny('scene_static_std')\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & %r)\n"
            "print('RESULT', res is not None, bad)\n") % (ROOT, FORBIDDEN)
    env = dict(os.environ)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    assert "RESULT True []" in out.stdout, out.stdout[-2000:] + out.stderr[-2000:]


def test_no_result_once_jax_is_loaded(tmp_path):
    """A metric reader, loaded after the window, that imports a module named
    `jax`: the run prints no result and exits non-zero."""
    shutil.copytree(f"{ROOT}/benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.load(open(f"{ROOT}/BENCHMARK.json"))
    spec["per_layer"].append(dict(name="loads_jax", unit="it", better="higher",
                                  source="program_counter", layer="trainer loops",
                                  moves="it_per_s", workloads=["scene_static_std"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "benchmark" / "metrics" / "loads_jax.py").write_text(
        "import jax\n\n\ndef read(m):\n    return 1.0\n")
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "jax.py").write_text("")
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import benchmark.run as run\n"
            "from benchmark.tests.bench_tiny import run_tiny\n"
            "res = run_tiny('scene_static_std', root=%r, trace=True)\n"
            "print('HAD_RESULT', res is not None, flush=True)\n"
            "sys.exit(run.finish(res))\n") % (ROOT, str(stub), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert "HAD_RESULT True" in out.stdout, out.stdout[-2000:] + out.stderr[-2000:]
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert "['jax']" in out.stderr
