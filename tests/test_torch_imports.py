"""mandalorion_tpu_torch never imports jax, resolves devices explicitly,
and knows when forking is unsafe.

tests/conftest.py imports jax into every test process, so the import
check runs in a fresh interpreter."""

import os
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


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert "mandalorion_tpu_torch.pipeline.cli" in mods and len(mods) >= 10
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib'))\n"
            "print('JAX', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "JAX []" in out.stdout, out.stdout


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the reference package only through the port
    (and in its subprocesses), and never imports jax."""
    import ast
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0])
    assert "mandalorion_tpu_torch" in tops
    assert not tops & {"mandalorion_tpu", "jax", "jaxlib",
                       "__graft_entry__"}, tops


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
        ["chain.cu", "dp.cu"]
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
