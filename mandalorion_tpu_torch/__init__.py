"""mandalorion_tpu_torch — mandalorion_tpu's device routes on PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package `mandalorion_tpu` is the reference. This package mirrors
its module names and imports its JAX-free layers (config, io, core,
native, the host aligner, the stage functions) instead of copying them;
it never imports jax. Ported so far: module A's staged device route.

- ``runtime``   — explicit device resolution, fork safety, build directory
- ``_build``    — nvcc build + ctypes loader for ``csrc/*.cu``
- ``align``     — chain DP and affine-gap DP kernels, TorchSpliceAligner
- ``pipeline``  — ``run_pipeline`` and the ``mando-tpu-torch`` CLI

The config dataclasses and the FASTA/FASTQ readers the port's entry
points take are re-exported here, so a caller of the port needs no
import of the reference package.
"""

from mandalorion_tpu.config import AlignConfig, PipelineConfig
from mandalorion_tpu.io.fastx import fastx_to_dict, read_fastx

__all__ = ["AlignConfig", "PipelineConfig", "fastx_to_dict", "read_fastx"]
__version__ = "0.1.0"
