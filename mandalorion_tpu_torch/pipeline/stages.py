"""APDFQ run for the port (counterpart of
mandalorion_tpu/pipeline/stages.py's `run_pipeline`).

Module A aligns on the device through one TorchSpliceAligner; modules P,
D, F and Q are the reference's own stage functions, so the stage
artifacts (and the -M resume checkpoints) are the reference's. Module F
re-aligns the isoform consensi on the aligner's host twin, as in the
reference.
"""

from __future__ import annotations

import os
from typing import Optional

from mandalorion_tpu.config import PipelineConfig
from mandalorion_tpu.io.fastx import fastx_to_dict
from mandalorion_tpu.pipeline.observe import StageTimer
from mandalorion_tpu.pipeline.stages import (
    Paths, _log, module_a, module_d, module_f, module_p, module_q)
from mandalorion_tpu_torch.align.aligner import TorchSpliceAligner
from mandalorion_tpu_torch.runtime import require_native, resolve_device


def run_pipeline(out_path: str, genome_path: str, annotation_path: str,
                 fasta_files: str, cfg: Optional[PipelineConfig] = None,
                 device="cuda") -> Paths:
    """Run APDFQ (or cfg.modules) with module A on `device`. Needs the
    native library: without it the reference's module D would take its
    JAX consensus route."""
    cfg = cfg or PipelineConfig()
    if cfg.poa.backend == "device":
        raise NotImplementedError("the graph-POA device backend is not yet "
                                  "ported to mandalorion_tpu_torch")
    require_native()
    dev = resolve_device(device)
    paths = Paths(out_path)
    os.makedirs(paths.tmp, exist_ok=True)
    _log(paths, cfg)
    timer = StageTimer(paths.t("timing.tsv"))
    aligner: Optional[TorchSpliceAligner] = None
    if "A" in cfg.modules or "F" in cfg.modules:
        with timer.stage("index_build"):
            aligner = TorchSpliceAligner(fastx_to_dict(genome_path),
                                         cfg.align, device=dev)
    if "A" in cfg.modules:
        with timer.stage("A_alignment"):
            # one process: module A's fork workers would call map_batch,
            # and a CUDA context does not survive fork. With one thread
            # the read batch grows to max(batch_reads, n_reads/3).
            module_a(paths, cfg.replace(threads=1), fasta_files,
                     genome_path, aligner)
    # P, D and F fork workers (cfg.threads) through the reference's
    # _fork_safe, which knows only jax. That is safe here although CUDA is
    # initialised: the children run host code only and never touch the
    # inherited CUDA context. runtime.fork_ok() is for workers that would
    # run port code, such as a ported module D's device route.
    p_writer = None
    try:
        if "P" in cfg.modules:
            with timer.stage("P_parsing"):
                p_writer = module_p(paths, cfg, defer_checkpoints=True)
        if "D" in cfg.modules:
            with timer.stage("D_define"):
                module_d(paths, cfg, annotation_path,
                         sorted_psl_pending=p_writer is not None)
    finally:
        if p_writer is not None:
            p_writer.join()
    if p_writer is not None and p_writer.exitcode != 0:
        raise RuntimeError(f"module P checkpoint writer failed (exit code "
                           f"{p_writer.exitcode}): clean.psl / "
                           f"clean.sorted.psl may be incomplete")
    if "F" in cfg.modules:
        with timer.stage("F_filter"):
            module_f(paths, cfg, genome_path, annotation_path, aligner)
    if "Q" in cfg.modules:
        with timer.stage("Q_quant"):
            module_q(paths, cfg, fasta_files)
    print("\n\tstage timing:")
    print(timer.summary())
    return paths
