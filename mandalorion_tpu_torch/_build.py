"""Build and load the hand-written CUDA kernels (csrc/*.cu).

nvcc compiles every source into one shared library with a plain C
interface, loaded through ctypes. The library is built on first use,
named by a hash of the sources and flags, into runtime.kernel_build_dir(),
so an edited kernel rebuilds and an unchanged one loads at once. Each C
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
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
_SIGNATURES = {
    # genome, oriented, q_lo, t_lo, nq, nt, mode, ptr_off, ptr, meta, ks,
    # buf, n, steps, match, mismatch, gap_open, gap_extend, end_bonus,
    # zdrop, stream
    "mando_dp_fused": [_P] * 12 + [_I64, _I64] + [_I32] * 6 + [_P],
    # qs, qe, ts, te, cov, n_seg, rows, n, msb, match, min_intron,
    # max_intron, intron_penalty, indel_open, indel_scale, stream
    "mando_chain_rows": [_P] * 7 + [_I64] + [_I32] * 4 + [_F32] * 3 + [_P],
}

_LIB: Optional[ctypes.CDLL] = None
BUILD_LOG = ""  # nvcc's output from the build this process ran, if any


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


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
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(kernel_build_dir(),
                        f"libmando_kernels_{h.hexdigest()[:16]}.so")


def load_kernels() -> ctypes.CDLL:
    """The kernel library, compiled first if this source hash has no
    build yet. Raises when nvcc is missing or the build fails."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    so = library_path()
    if not os.path.exists(so):
        # pid-unique temp + atomic rename: concurrent processes may race
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.time()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()],
                              capture_output=True, text=True, timeout=900)
        BUILD_LOG = (f"# nvcc {time.time() - t0:.1f}s\n"
                     f"{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)
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
