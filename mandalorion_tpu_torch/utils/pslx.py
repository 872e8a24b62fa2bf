"""PSL → PSLX: append per-block read and target sequences (cols 21, 22).

Replaces the external `psl2pslx` tool the reference's HLA typing and
TurboPhaser depend on (`utils/HLAtyping.py:109`, SURVEY §2.1 C19/C20).
"""

from __future__ import annotations

from typing import Dict

from mandalorion_tpu_torch.io.fastx import revcomp


def psl_to_pslx(psl_path: str, reads: Dict[str, str],
                targets: Dict[str, str], out_path: str) -> None:
    """reads/targets: name -> sequence. Block read sequences come from the
    aligned orientation (reverse-complemented for '-' strand records)."""
    with open(psl_path) as fh, open(out_path, "w") as out:
        for line in fh:
            if not line.strip():
                continue
            a = line.rstrip("\n").split("\t")
            strand, q_name, t_name = a[8], a[9], a[13]
            sizes = [int(x) for x in a[18].split(",")[:-1]]
            q_starts = [int(x) for x in a[19].split(",")[:-1]]
            t_starts = [int(x) for x in a[20].split(",")[:-1]]
            q_seq = reads.get(q_name, "")
            if strand == "-":
                q_seq = revcomp(q_seq)
            t_seq = targets.get(t_name, "")
            q_blocks = ",".join(q_seq[qs:qs + z]
                                for qs, z in zip(q_starts, sizes)) + ","
            t_blocks = ",".join(t_seq[ts:ts + z]
                                for ts, z in zip(t_starts, sizes)) + ","
            out.write("\t".join(a[:21]) + f"\t{q_blocks}\t{t_blocks}\n")
