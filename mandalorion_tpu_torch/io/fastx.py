"""fasta / fastq reading and writing (plain or gzipped), fofn expansion,
reverse complement.

Replaces mappy's C `fastx_read` / `revcomp` (used throughout the reference:
`Mando.py:310`, `assignReadsToIsoforms.py:59`, `filterIsoforms.py:77`,
`emtrey.py:48`) with a dependency-free implementation. A native C++ fast path
is used when the compiled extension is available (mandalorion_tpu.native).
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, Iterator, List, Optional, Tuple

_COMP = bytes.maketrans(
    b"ACGTUacgtuNnRYSWKMBDHVryswkmbdhv-",
    b"TGCAAtgcaaNnYRSWMKVHDBYRSWMKVHDB-",
)


def revcomp(seq: str) -> str:
    """Reverse complement (IUPAC-aware, like mappy.revcomp)."""
    return seq.translate(_COMP)[::-1]


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_fastx(path: str) -> Iterator[Tuple[str, str, Optional[str]]]:
    """Yield (name, seq, qual) from a fasta or fastq file, optionally
    gzipped. Format is auto-detected from the first character. Name is
    truncated at the first whitespace (mappy behavior)."""
    with _open(path) as fh:
        first = fh.read(1)
        if not first:
            return
        if first == ">":
            name = fh.readline().strip().split()[0]  # '>' already consumed
            chunks: List[str] = []
            for line in fh:
                if line.startswith(">"):
                    yield name, "".join(chunks), None
                    name = line[1:].strip().split()[0]
                    chunks = []
                else:
                    chunks.append(line.strip())
            yield name, "".join(chunks), None
        elif first == "@":
            # fastq: strictly 4-line records (standard for long-read data)
            name = fh.readline().strip().split()[0]
            while True:
                seq = fh.readline()
                if not seq:
                    break
                fh.readline()  # '+'
                qual = fh.readline()
                yield name, seq.strip(), qual.strip()
                header = fh.readline()
                if not header:
                    break
                name = header.strip().lstrip("@").split()[0]
        else:
            raise ValueError(f"{path}: not a fasta/fastq file (starts {first!r})")


def scan_record_offsets(path: str):
    """Byte offset of every record start in a PLAIN (non-gzip) fasta or
    fastq file, via one buffered binary scan — len() is the record count
    and offsets[k] seeks straight to record k (read_fastx_slice), so
    module A's fork workers can jump to their slice instead of
    skip-parsing every record before it. Returns None for gzipped input
    (no cheap random access) — callers fall back to islice."""
    with open(path, "rb") as fh:
        head = fh.read(2)
        if head[:2] == b"\x1f\x8b":
            return None
        if not head:
            return []
        # a 1-byte non-gzip file falls through to the normal scan so a
        # malformed header raises here instead of reporting 0 records
        fasta = head[:1] == b">"
        if not fasta and head[:1] != b"@":
            raise ValueError(f"{path}: not a fasta/fastq file")
        fh.seek(0)
        offsets: List[int] = []
        pos = 0
        line_idx = 0
        CHUNK = 1 << 20
        pending = b""
        while True:
            block = fh.read(CHUNK)
            if not block:
                break
            block = pending + block
            pending = b""
            start = 0
            while True:
                nl = block.find(b"\n", start)
                if nl < 0:
                    pending = block[start:]
                    break
                line = block[start:nl]
                if fasta:
                    if line[:1] == b">":
                        offsets.append(pos + start)
                else:
                    # fastq: strictly 4-line records; only every 4th
                    # line is a header (quality lines may start with @)
                    if line_idx % 4 == 0:
                        offsets.append(pos + start)
                line_idx += 1
                start = nl + 1
            pos += len(block) - len(pending)
        if pending:
            if fasta:
                if pending[:1] == b">":
                    offsets.append(pos)
            elif line_idx % 4 == 0:
                offsets.append(pos)
    return offsets


def read_fastx_slice(path: str, offset: int, count: int
                     ) -> Iterator[Tuple[str, str, Optional[str]]]:
    """read_fastx starting at a record byte offset (from
    scan_record_offsets), yielding at most `count` records. Plain files
    only."""
    import itertools
    with open(path) as fh:
        fh.seek(offset)
        first = fh.read(1)
        if not first:
            return
        if first == ">":
            name = fh.readline().strip().split()[0]
            chunks: List[str] = []
            emitted = 0
            for line in fh:
                if line.startswith(">"):
                    yield name, "".join(chunks), None
                    emitted += 1
                    if emitted >= count:
                        return
                    name = line[1:].strip().split()[0]
                    chunks = []
                else:
                    chunks.append(line.strip())
            yield name, "".join(chunks), None
        elif first == "@":
            name = fh.readline().strip().split()[0]
            emitted = 0
            while True:
                seq = fh.readline()
                if not seq:
                    break
                fh.readline()  # '+'
                qual = fh.readline()
                yield name, seq.strip(), qual.strip()
                emitted += 1
                if emitted >= count:
                    return
                header = fh.readline()
                if not header:
                    break
                name = header.strip().lstrip("@").split()[0]
        else:
            raise ValueError(f"{path}: not a fasta/fastq record at "
                             f"offset {offset} (starts {first!r})")


def fastx_to_dict(path: str) -> Dict[str, str]:
    """name -> sequence dict (reference `read_fasta`, filterIsoforms.py:74-79)."""
    return {name: seq for name, seq, _ in read_fastx(path)}


def write_fasta(path: str, records, append: bool = False) -> None:
    """Write (name, seq) pairs as fasta."""
    mode = "a" if append else "w"
    with open(path, mode) as fh:
        for name, seq in records:
            fh.write(f">{name}\n{seq}\n")


def expand_fofn(spec: str) -> List[str]:
    """Expand a reads argument: a .fofn file (one path per line), a comma
    separated list, or a single path (`Mando.py:224-230`)."""
    if ".fofn" in spec:
        with open(spec) as fh:
            return [line.strip() for line in fh if line.strip()]
    return spec.split(",")


def combine_fastx(paths: List[str], out_path: str) -> Tuple[str, bool]:
    """Merge multiple fasta/q inputs into one fasta (`Mando.py:290-314`).
    Returns (path_to_use, any_reads). Single existing input is passed
    through untouched; missing/empty inputs are reported and skipped."""
    usable = [p for p in paths if os.path.exists(p) and os.path.getsize(p) > 0]
    for p in paths:
        if p not in usable:
            print(f"\t{p} does not exist or is an empty file")
    if not usable:
        return out_path, False
    if len(paths) == 1 and usable:
        return usable[0], True
    with open(out_path, "w") as out:
        for p in usable:
            for name, seq, _ in read_fastx(p):
                out.write(f">{name}\n{seq}\n")
    return out_path, True
