"""mandalorion_tpu_torch imports neither jax nor the JAX package, resolves
devices explicitly, and knows when forking is unsafe.

tests/conftest.py imports jax into every test process, so the import
check runs in a fresh interpreter."""

import ast
import os
import re
import shutil
import subprocess
import sys
import threading

import pytest
import torch

from mandalorion_tpu_torch import _build, runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "mandalorion_tpu_torch")


def _port_modules():
    mods = []
    for dirpath, _dirs, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(
                    ".__init__"))
    return sorted(mods)


FORBIDDEN = {"mandalorion_tpu", "jax", "jaxlib", "__graft_entry__"}


def _imported_tops(tree):
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add((node.module or "").split(".")[0])
    return tops


def _port_sources():
    for dirpath, _dirs, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert "mandalorion_tpu_torch.pipeline.cli" in mods and len(mods) >= 40
    assert {"mandalorion_tpu_torch.parallel",
            "mandalorion_tpu_torch.parallel.mesh",
            "mandalorion_tpu_torch.parallel.dist"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mandalorion_tpu'))\n"
            "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_no_port_source_imports_the_jax_package():
    """No `import` / `from` of mandalorion_tpu (the exact top-level name)
    or jax in any source file of the port, lazy imports included."""
    checked = 0
    for path in _port_sources():
        with open(path) as fh:
            tops = _imported_tops(ast.parse(fh.read()))
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        checked += 1
    assert checked >= 40


def _exported(init_path):
    with open(init_path) as fh:
        tree = ast.parse(fh.read())
    return {a.asname or a.name for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) for a in node.names}


def test_parallel_exports_the_reference_names():
    """parallel/ is a counterpart of mandalorion_tpu/parallel/ (read as
    source: the reference's imports jax): the same modules, the same
    names exported from the package, and no import of jax or the JAX
    package in any of them."""
    ref = os.path.join(ROOT, "mandalorion_tpu", "parallel")
    port = os.path.join(PORT, "parallel")
    assert sorted(f for f in os.listdir(port) if f.endswith(".py")) == \
        sorted(f for f in os.listdir(ref) if f.endswith(".py")) == \
        ["__init__.py", "dist.py", "mesh.py"]
    assert _exported(os.path.join(port, "__init__.py")) == \
        _exported(os.path.join(ref, "__init__.py"))
    for f in ("__init__.py", "dist.py", "mesh.py"):
        with open(os.path.join(port, f)) as fh:
            assert not _imported_tops(ast.parse(fh.read())) & FORBIDDEN, f


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py imports the port and never the JAX package or jax,
    and names neither in a string it hands to a subprocess."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    tops = _imported_tops(tree)
    assert "mandalorion_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops
    module_name = re.compile(r"\b(mandalorion_tpu|jax|jaxlib)\b")
    launchers = {"run", "Popen", "check_output", "check_call", "call"}
    n_calls = 0
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = getattr(node.func, "id", getattr(node.func, "attr", None))
        if name not in launchers:
            continue
        n_calls += 1
        for arg in ast.walk(node):
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                assert not module_name.search(arg.value), arg.value
    assert n_calls >= 2


def test_bench_torch_imports_only_the_port():
    """bench_torch.py, the port's bench, imports the port and never the
    JAX package, jax or tests/synthdata.py, lazy imports included, and
    names none of them in a string it hands to a subprocess; imported in
    a fresh interpreter, it leaves jax and mandalorion_tpu out of
    sys.modules."""
    with open(os.path.join(ROOT, "bench_torch.py")) as fh:
        tree = ast.parse(fh.read())
    tops = _imported_tops(tree)
    assert {"mandalorion_tpu_torch", "torch", "numpy"} <= tops
    assert not tops & (FORBIDDEN | {"synthdata"}), tops
    module_name = re.compile(r"\b(mandalorion_tpu|jax|jaxlib|synthdata)\b")
    launchers = {"run", "Popen", "check_output", "check_call", "call"}
    n_calls = 0
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = getattr(node.func, "id", getattr(node.func, "attr", None))
        if name not in launchers:
            continue
        n_calls += 1
        for arg in ast.walk(node):
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                assert not module_name.search(arg.value), arg.value
    assert n_calls >= 2
    code = ("import sys\n"
            "import bench_torch\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mandalorion_tpu', 'synthdata'))\n"
            "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_trace_reader_imports_neither_jax_nor_the_jax_package():
    """tools/trace_breakdown.py, which chip_smoke.py loads on the card,
    imports neither jax nor mandalorion_tpu, lazy imports included."""
    with open(os.path.join(ROOT, "tools", "trace_breakdown.py")) as fh:
        tops = _imported_tops(ast.parse(fh.read()))
    assert "json" in tops
    assert not tops & FORBIDDEN, tops


def test_config_tool_imports_neither_jax_nor_the_jax_package():
    """tools/run_configs_torch.py, which chip_smoke.py loads on the card,
    imports neither jax nor mandalorion_tpu, lazy imports included, and
    names neither in a string it hands to a subprocess; loaded and used
    to make a dataset in a fresh interpreter, it leaves both out of
    sys.modules."""
    path = os.path.join(ROOT, "tools", "run_configs_torch.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    tops = _imported_tops(tree)
    assert {"numpy", "subprocess"} <= tops
    assert not tops & FORBIDDEN, tops
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not re.search(r"\b(jax|jaxlib)\b|mandalorion_tpu\b(?!_)",
                                 node.value), node.value
    code = ("import importlib.util, sys, tempfile\n"
            f"spec = importlib.util.spec_from_file_location('t', {path!r})\n"
            "t = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(t)\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    t.two_sample(d)\n"
            "    t.make_dataset_files(d, n_genes=2, n_reads_per_gene=2,\n"
            "                         genome_len=20_000)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mandalorion_tpu'))\n"
            "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        runtime.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        runtime.resolve_device(torch.device("cuda", 0))


def test_resolve_device():
    assert runtime.resolve_device("cpu") == torch.device("cpu")
    assert runtime.resolve_device(torch.device("cpu")).type == "cpu"
    with pytest.raises(ValueError, match="unsupported"):
        runtime.resolve_device("meta")


def test_fork_ok_tracks_threads_and_cuda(monkeypatch):
    assert runtime.fork_ok() == (threading.active_count() == 1
                                 and not torch.cuda.is_initialized())
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert not runtime.fork_ok()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    stop = threading.Event()
    worker = threading.Thread(target=stop.wait)
    worker.start()
    try:
        assert not runtime.fork_ok()
    finally:
        stop.set()
        worker.join(timeout=10)
    assert not worker.is_alive()


def test_build_is_keyed_by_sources_and_flags(monkeypatch):
    path = _build.library_path()
    assert path.startswith(runtime.kernel_build_dir())
    assert sorted(os.path.basename(s) for s in _build.sources()) == \
        ["chain.cu", "dp.cu", "poa_fwd.cu", "poa_sweep.cu", "poa_walk.cu"]
    for flag in ("arch=compute_90a,code=sm_90a", "-fmad=false", "-O3"):
        assert flag in _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build.library_path() != path


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "library_path",
                        lambda: str(tmp_path / "libx.so"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_kernels()


def test_build_is_keyed_by_headers(monkeypatch, tmp_path):
    """An edited device header (csrc/*.cuh) names another library, so the
    kernels that include it are rebuilt; headers are hashed, not compiled."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    assert [os.path.basename(h) for h in _build.headers()] == \
        ["poa_chase.cuh"]
    assert all(s.endswith(".cu") for s in _build.sources())
    path = _build.library_path()
    header = csrc / "poa_chase.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() != path
