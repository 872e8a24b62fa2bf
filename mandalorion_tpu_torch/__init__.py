"""mandalorion_tpu_torch: the mandalorion_tpu isoform pipeline on PyTorch
and hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package `mandalorion_tpu` is the reference. This package mirrors
its module names and stands alone: it keeps its own copy of the host
layers (config, io, native C++ library, core, utils, the host aligner,
the stage functions) and imports neither jax nor mandalorion_tpu. Ported
device routes so far: module A's staged alignment route and module D's
graph-POA consensus.

- ``runtime``   explicit device resolution, fork safety, build directory
- ``_build``    nvcc build + ctypes loader for ``csrc/*.cu``
- ``native``    g++ build + ctypes loader for the C++ host library
- ``align``     chain DP and affine-gap DP kernels, the aligners
- ``poa``       graph-POA forward and walk kernels, consensus calling
- ``core``, ``io``, ``utils``  host layers
- ``pipeline``  ``run_pipeline`` and the ``mando-tpu-torch`` CLI
"""

from mandalorion_tpu_torch.config import (
    AlignConfig, PipelineConfig, PoaConfig)
from mandalorion_tpu_torch.io.fastx import fastx_to_dict, read_fastx

__all__ = ["AlignConfig", "PipelineConfig", "PoaConfig", "fastx_to_dict",
           "read_fastx"]
__version__ = "0.1.0"
