"""Module A's device route on PyTorch (counterpart of
mandalorion_tpu/align/aligner.py's `_map_batch_device_staged`).

Per batch:

    C seed (native_stage_seed_batch) -> chain DP (chain_kernel.chain_rows)
      -> C fill (native_stage_fill_batch)
      -> affine-gap DP + traceback (kernels.dp_fused)
      -> C emit (native_stage_emit_batch)

The three native C stages are the reference's, unchanged; the two device
stages are this package's. The genome index is the reference's
`GenomeIndex` (shared numpy arrays); its uint8 sequence codes are uploaded
to the device once and stay there.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mandalorion_tpu.align.aligner import SpliceAligner, _Pending, cfg_min_len
from mandalorion_tpu.align.encode import encode
from mandalorion_tpu.config import AlignConfig
from mandalorion_tpu.io.psl import PslRecord
from mandalorion_tpu.native import (
    native_stage_emit_batch, native_stage_fill_batch, native_stage_seed_batch)
from mandalorion_tpu_torch.align.chain_kernel import chain_batch_rows
from mandalorion_tpu_torch.align.kernels import solve_dp_fused
from mandalorion_tpu_torch.runtime import require_native, resolve_device


def _port_cfg(cfg: AlignConfig) -> AlignConfig:
    """The config the base class is built with. Backend strings other than
    the reference's device values keep SpliceAligner.__init__ from
    importing jax; its host methods then use the native solver."""
    if cfg.index_backend == "sharded":
        raise NotImplementedError("index_backend='sharded' is not yet "
                                  "ported to mandalorion_tpu_torch")
    return dataclasses.replace(cfg, dp_backend="torch", chain_backend="torch")


class TorchSpliceAligner(SpliceAligner):
    """SpliceAligner whose `map_batch` runs the staged device route on
    `device` ('cuda' or 'cpu'; the CPU runs the kernels' plain PyTorch
    versions). Every other method is the host aligner's, and `host_twin()`
    returns a plain host SpliceAligner sharing the index."""

    def __init__(self, genome, cfg: Optional[AlignConfig] = None,
                 device="cuda"):
        dev = resolve_device(device)
        super().__init__(genome, _port_cfg(cfg or AlignConfig()))
        self._bind(dev)

    @classmethod
    def from_aligner(cls, aligner: SpliceAligner, device="cuda"
                     ) -> "TorchSpliceAligner":
        """A port aligner sharing `aligner`'s GenomeIndex (no rebuild)."""
        if aligner._sharded is not None:
            raise NotImplementedError("a sharded index is not yet ported")
        dev = resolve_device(device)
        self = object.__new__(cls)
        self.cfg = _port_cfg(aligner.cfg)
        self.index = aligner.index
        self.max_occ = aligner.max_occ
        self._sharded = None
        from mandalorion_tpu.align.extend import solve_dp_native
        self.dp_backend = solve_dp_native
        self._bind(dev)
        return self

    def _bind(self, device: torch.device) -> None:
        self.device = device
        # uploaded once; on the CPU this shares the index's numpy buffer
        self.genome_codes = torch.from_numpy(self.index.seq_codes).to(device)

    def seed_batch(self, reads: Sequence[Tuple[str, str]]):
        """C seed stage: (codes_all, read_off, seeded), seeded being
        native_stage_seed_batch's (n_cand, read, strand, chrom, tbase,
        n_seg, (qs, qe, ts, te, cov))."""
        require_native()
        if self.index.bucket_lo is None:
            raise RuntimeError("the device route needs an index with "
                               "bucket_lo (built by the native library)")
        cfg = self.cfg
        code_list = [encode(seq) for _name, seq in reads]
        read_off = np.zeros(len(reads) + 1, np.int64)
        np.cumsum([len(c) for c in code_list], out=read_off[1:])
        codes_all = (np.concatenate(code_list) if code_list
                     else np.zeros(0, np.uint8))
        seeded = native_stage_seed_batch(
            codes_all, read_off, cfg.kmer, cfg.window, self.max_occ, 100,
            self.index, cfg.max_intron)
        return codes_all, read_off, seeded

    def chain_batch(self, seeded) -> np.ndarray:
        """Chain DP on the device: the packed int16 chain rows."""
        n_cand, _read, _strand, _chrom, _tbase, n_seg, segs = seeded
        return chain_batch_rows(*segs, n_seg, n_cand,
                                min_intron=self.cfg.min_intron,
                                max_intron=self.cfg.max_intron,
                                device=self.device)

    def fill_batch(self, codes_all, read_off, seeded, rows):
        """C fill stage: (strand, chrom, oriented, run_off, runs, probs),
        probs being the DP descriptors (read, mode, q0, t0, nq, nt)."""
        cfg = self.cfg
        n_cand, c_read, c_strand, c_chrom, c_tbase, c_nseg, segs = seeded
        return native_stage_fill_batch(
            codes_all, read_off, n_cand, c_read, c_strand, c_chrom, c_tbase,
            c_nseg, segs, rows, self.index, cfg_min_len(cfg), cfg.min_intron,
            cfg.match, cfg.mismatch, cfg.gap_open, cfg.gap_extend,
            cfg.end_bonus, cfg.zdrop, cfg.band_width, cfg.max_end_extend,
            cfg.splice_slack, cfg.noncanonical_penalty)

    def map_batch(self, reads: Sequence[Tuple[str, str]]
                  ) -> List[PslRecord]:
        """Align a batch of (name, seq) reads on the device route;
        primary alignments only, byte-identical to the host path. Raises
        when the native library is missing (no Python staging fallback)."""
        codes_all, read_off, seeded = self.seed_batch(reads)
        if seeded[0] == 0:
            return []
        rows = self.chain_batch(seeded)
        strand, chrom, oriented, run_off, runs, probs = self.fill_batch(
            codes_all, read_off, seeded, rows)
        cfg = self.cfg
        meta, ks, buf, on_host = solve_dp_fused(
            probs, oriented, read_off, self.genome_codes, cfg)
        stats, blk_off, bs, bq, bt, cs_off, cs_raw = \
            native_stage_emit_batch(
                oriented, read_off, self.index.seq_codes, strand, run_off,
                runs, probs, on_host, meta, ks, buf, cfg.match,
                cfg.mismatch, cfg.gap_open, cfg.gap_extend, cfg.end_bonus,
                cfg.zdrop)

        out: List[PslRecord] = []
        for ri, (name, seq) in enumerate(reads):
            if strand[ri] < 0 or stats[ri, 7] == 0:
                continue
            b0, b1 = int(blk_off[ri]), int(blk_off[ri + 1])
            pend = _Pending(
                name, seq, "+" if strand[ri] == 0 else "-",
                oriented[read_off[ri]:read_off[ri + 1]], int(chrom[ri]),
                [], [])
            rec = self._psl_record(
                pend, stats[ri], bs[b0:b1].tolist(), bq[b0:b1].tolist(),
                bt[b0:b1].tolist(),
                cs_raw[cs_off[ri]:cs_off[ri + 1]].decode())
            if rec is not None:
                out.append(rec)
        return out
