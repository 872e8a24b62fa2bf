"""Device resolution, fork safety and the kernel build directory.

Counterpart of mandalorion_tpu/runtime.py. Every entry point of the port
takes an explicit `device`; this module turns it into a `torch.device`
and never substitutes another one: asking for CUDA where there is none
raises.
"""

from __future__ import annotations

import os
import threading

import torch


def resolve_device(device) -> torch.device:
    """`device` ('cuda', 'cuda:1', 'cpu' or a torch.device) as a
    torch.device. CUDA without a usable card raises RuntimeError."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                f"False (torch {torch.__version__})")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    return dev


def fork_ok() -> bool:
    """True when forking a worker that may run port code is safe: this
    process has no other Python threads and has not initialised CUDA (a
    CUDA context does not survive fork)."""
    return threading.active_count() == 1 and not torch.cuda.is_initialized()


def require_native(what: str = "this entry point"):
    """The port's native C++ library (built with g++ on first use), for
    `what`, an entry that has no numpy twin. Raises when it cannot be
    built or loaded, and when MANDO_TPU_NO_NATIVE is set."""
    from mandalorion_tpu_torch.native import load_native
    lib = load_native()
    if lib is None:
        raise RuntimeError(
            f"MANDO_TPU_NO_NATIVE is set, and {what} has no numpy twin of "
            f"the native library: unset MANDO_TPU_NO_NATIVE, or take a "
            f"route that runs without it")
    return lib


def kernel_build_dir() -> str:
    """Directory for the compiled CUDA kernels (listed in .gitignore)."""
    d = os.path.join(os.path.dirname(__file__), "_build")
    os.makedirs(d, exist_ok=True)
    return d


class LaunchCounter:
    """Number of times one kernel wrapper launched its CUDA kernel. The
    plain PyTorch path never counts, so a run can show that it went
    through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
