"""Minimal BAM reading: PacBio BAM -> fasta (the hidden -P input path,
`Mando.py:281-288`, replacing the samtools subprocess).

BAM is BGZF (gzip-member blocks; Python's gzip handles multi-member
streams) wrapping little-endian binary records. Only name/flag/seq are
needed: secondary (0x100) and supplementary (0x800) records are skipped and
reverse-flag (0x10) sequences are reverse-complemented, matching
`samtools fasta` defaults.
"""

from __future__ import annotations

import gzip
import struct
from typing import Iterator, Tuple

from mandalorion_tpu_torch.io.fastx import revcomp

_SEQ_CODES = "=ACMGRSVTWYHKDBN"


def read_bam(path: str) -> Iterator[Tuple[str, int, str]]:
    """Yield (name, flag, seq_in_original_orientation) per record."""
    with gzip.open(path, "rb") as fh:
        magic = fh.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", fh.read(4))
        fh.read(l_text)
        (n_ref,) = struct.unpack("<i", fh.read(4))
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", fh.read(4))
            fh.read(l_name + 4)
        while True:
            head = fh.read(4)
            if len(head) < 4:
                break
            (block_size,) = struct.unpack("<i", head)
            rec = fh.read(block_size)
            if len(rec) < block_size:
                break
            (_ref_id, _pos, l_read_name, _mapq, _bin, n_cigar, flag,
             l_seq, _next_ref, _next_pos, _tlen) = struct.unpack(
                "<iiBBHHHiiii", rec[:32])
            off = 32
            name = rec[off:off + l_read_name - 1].decode()
            off += l_read_name
            off += 4 * n_cigar
            seq_bytes = rec[off:off + (l_seq + 1) // 2]
            bases = []
            for b in seq_bytes:
                bases.append(_SEQ_CODES[b >> 4])
                bases.append(_SEQ_CODES[b & 0xF])
            seq = "".join(bases[:l_seq])
            if flag & 0x10:
                seq = revcomp(seq)
            yield name, flag, seq


def bam_to_fasta(bam_path: str, fasta_path: str) -> int:
    """Write primary records as fasta; returns the count."""
    n = 0
    with open(fasta_path, "w") as out:
        for name, flag, seq in read_bam(bam_path):
            if flag & 0x100 or flag & 0x800:
                continue
            out.write(f">{name}\n{seq}\n")
            n += 1
    return n
