"""Build and load the hand-written CUDA kernels (csrc/*.cu).

nvcc compiles every source (one nvcc process per source, all started
together) and links them into one shared library with a plain C
interface, loaded through ctypes. The library is built on first use,
named by a hash of the flags, the sources and the device headers they
include (csrc/*.cuh), into runtime.kernel_build_dir(), so an edited
kernel or header rebuilds and an unchanged one loads at once. Each C
entry launches on the stream it is given and returns cudaGetLastError();
`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

from mandalorion_tpu_torch.runtime import kernel_build_dir

CSRC = os.path.join(os.path.dirname(__file__), "csrc")
# -fmad=false: the chain DP's float32 arithmetic must round like numpy's
# and XLA's (no a*b+c contraction); -Xptxas -v reports registers, shared
# memory and spills per kernel into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
_SIGNATURES = {
    # genome, oriented, q_lo, t_lo, nq, nt, mode, order, ptr_off, bnd_off,
    # ptr, bnd, meta, ks, buf, n, n_small, steps, per_block, warp_share,
    # block_bytes, match, mismatch, gap_open, gap_extend, end_bonus, zdrop,
    # stream
    "mando_dp_fused": [_P] * 15 + [_I64] * 3 + [_I32] * 9 + [_P],
    # qs, qe, ts, te, cov, n_seg, order, rows, n, msb, per_block, match,
    # min_intron, max_intron, intron_penalty, indel_open, indel_scale, stream
    "mando_chain_rows": [_P] * 8 + [_I64] + [_I32] * 5 + [_F32] * 3 + [_P],
    # base, preds, nn, qq, ql, band, hpack, opack, d1p, d2p, offs, endcol,
    # state, bestc, n, n_cap, p_cap, l_cap, W, match, mismatch, gap_open,
    # gap_extend, gap_open2, gap_extend2, adaptive, stream
    "mando_poa_fwd": [_P] * 14 + [_I64] + [_I32] * 11 + [_P],
    # nn, ends, ql, hpack, opack, d1p, d2p, offs, endcol, buf, ks, n, n_cap,
    # W, max_steps, stream
    "mando_poa_walk": [_P] * 11 + [_I64] + [_I32] * 3 + [_P],
    # nn, ends, ql, hpack, opack, d1p, d2p, offs, endcol, recs, counts, n,
    # n_cap, W, max_rec, stream
    "mando_poa_sweep": [_P] * 11 + [_I64] + [_I32] * 3 + [_P],
}

_LIB: Optional[ctypes.CDLL] = None
BUILD_LOG = ""  # nvcc's output from the build this process ran, if any


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def headers() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels need the "
                       "CUDA toolkit")


def library_path() -> str:
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(kernel_build_dir(),
                        f"libmando_kernels_{h.hexdigest()[:16]}.so")


def _compile(so: str) -> None:
    """Build `so` from sources(): the objects in parallel, then the link.
    Temporaries carry the pid and the result is renamed into place, since
    concurrent processes may race to build the same library."""
    global BUILD_LOG
    nvcc = _nvcc()
    tag = f"{so}.{os.getpid()}"
    t0 = time.time()
    objects = [f"{tag}.{os.path.basename(src)}.o" for src in sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(sources(), objects)]
    logs, failed = [], []
    try:
        for src, proc in zip(sources(), procs):
            out, err = proc.communicate(timeout=900)
            logs.append(f"# {os.path.basename(src)}\n{out}{err}")
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} "
                              f"({proc.returncode}):\n{err}")
        if not failed:
            link = subprocess.run(
                [nvcc, "-shared", "-o", f"{tag}.tmp", *objects],
                capture_output=True, text=True, timeout=900)
            logs.append(f"# link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append(f"link ({link.returncode}):\n{link.stderr}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    BUILD_LOG = f"# nvcc {time.time() - t0:.1f}s\n" + "".join(logs)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(f"{tag}.tmp", so)


def load_kernels() -> ctypes.CDLL:
    """The kernel library, compiled first if this source hash has no
    build yet. Raises when nvcc is missing or the build fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = library_path()
    if not os.path.exists(so):
        _compile(so)
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mando_error_string.argtypes = [ctypes.c_int]
    lib.mando_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        msg = _LIB.mando_error_string(code).decode() if _LIB else "?"
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
