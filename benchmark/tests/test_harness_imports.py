"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Names are compared by their
top-level part, whole: the port's name begins with the JAX package's."""

import ast
import glob
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "mandalorion_tpu"}


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def _sources():
    return [p for p in glob.glob(os.path.join(BENCH, "**", "*.py"),
                                 recursive=True)
            if os.sep + "tests" + os.sep not in p]


def test_ast_scan():
    for path in _sources():
        found = set(_imports(path)) & FORBIDDEN
        assert not found, f"{path} imports {found}"
    reference = [os.path.join(BENCH, n) for n in ("bm_reference.py",
                                                 "bm_data.py")]
    reference += glob.glob(os.path.join(BENCH, "generators", "*.py"))
    for path in reference:
        assert "mandalorion_tpu_torch" not in set(_imports(path)), path


def _fresh(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=BENCH + os.pathsep
                                  + ROOT))
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_fresh_interpreter():
    """The harness with the program's modules that a run loads, and the
    reference alone."""
    loaded = _fresh(
        "import sys, bm_harness, bm_reference\n"
        "import glob, os\n"
        "for p in glob.glob(os.path.join(bm_harness.HERE, 'metrics', "
        "'*.py')):\n"
        "    bm_harness.reader(os.path.basename(p)[:-3])\n"
        "p = bm_harness._Program('cpu')\n"
        "print(' '.join(m.split('.')[0] for m in sys.modules))")
    assert "mandalorion_tpu_torch" in loaded
    assert not loaded & FORBIDDEN
    loaded = _fresh("import sys, glob, os, importlib.util\n"
                    "import bm_reference, bm_data\n"
                    "for p in glob.glob(os.path.join('benchmark', "
                    "'generators', '*.py')):\n"
                    "    n = os.path.basename(p)[:-3]\n"
                    "    s = importlib.util.spec_from_file_location(n, p)\n"
                    "    m = importlib.util.module_from_spec(s)\n"
                    "    sys.modules[n] = m\n"
                    "    s.loader.exec_module(m)\n"
                    "print(' '.join(m.split('.')[0] for m in sys.modules))")
    assert "mandalorion_tpu_torch" not in loaded
    assert not loaded & FORBIDDEN
