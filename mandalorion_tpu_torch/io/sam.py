"""SAM parsing and SAM → (extended) PSL conversion.

Behavioral equivalent of the reference's `emtrey.py` converter: only 'M'
CIGAR ops open PSL blocks, 'I' advances the query offset, 'D'/'N' advance the
target offset, col 3 counts intron ('N') bases, accuracy =
matches/(matches+mismatch+I+D+ambig) with mismatch = NM-(I+D)-nn clamped at 0
(`emtrey.py:31-152`, probed semantics in SURVEY §2.4). The mando extension
appends accuracy, the long-form cs string, and the read sequence restored to
its original sequencing orientation (`emtrey.py:147-148`).

Our own aligner emits extended PSL directly (align/aligner.py); this module
exists for SAM interop and parity testing.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

from mandalorion_tpu_torch.io.fastx import revcomp

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def sam_to_psl_line(fields, t_size: int, mando: bool = False) -> Optional[str]:
    """Convert one aligned SAM record (split fields) to a PSL line.
    Returns None for unmapped records."""
    if fields[2] == "*":
        return None
    name = fields[0]
    flag = int(fields[1])
    t_start = int(fields[3]) - 1
    strand = "-" if flag & 16 else "+"
    cigar = fields[5]
    sequence = fields[9]
    if strand == "-":
        # SAM stores the target-forward sequence; undo to the original
        # sequencing orientation for extended-PSL col 23.
        sequence = revcomp(sequence)

    block_sizes = []
    q_starts = []
    t_starts = [t_start]
    q_start = 0
    q_end_clip = 0
    M = I = nI = D = nD = N = S = H = EQ = X = 0
    ops = _CIGAR_RE.findall(cigar)
    q_starts.append(0)
    for i, (num_s, op) in enumerate(ops):
        n = int(num_s)
        if op in "SH":
            if i == 0:
                q_start = n
                q_starts[0] = n
            elif i == len(ops) - 1:
                q_end_clip = n
            if op == "S":
                S += n
            else:
                H += n
        elif op == "M":
            M += n
            block_sizes.append(n)
            q_starts.append(n + q_starts[-1])
            t_starts.append(n + t_starts[-1])
        elif op == "I":
            I += n
            nI += 1
            q_starts[-1] += n
        elif op == "D":
            D += n
            nD += 1
            t_starts[-1] += n
        elif op == "N":
            N += n
            t_starts[-1] += n
        elif op == "=":
            EQ += n
        elif op == "X":
            X += n

    ID = I + D
    q_size = M + I + S + H + EQ + X
    consume_ref = M + D + N + EQ + X
    t_end = t_start + consume_ref
    q_end = q_size if q_end_clip == 0 else q_size - q_end_clip
    q_starts = q_starts[:-1] if q_starts else q_starts
    t_starts = t_starts[:-1] if t_starts else t_starts

    nm = ambig = 0
    cs = ""
    for col in fields[9:]:
        if "NM:i:" in col:
            nm = int(col.split(":")[2])
        elif "nn:i:" in col:
            ambig = int(col.split(":")[2])
        elif "ts:A:" in col:
            # transcript strand: a '-' ts tag flips the reported strand
            if col.split(":")[2] == "-":
                strand = "+" if strand == "-" else "-"
        elif "cs:Z:" in col:
            # DELIBERATE divergence from emtrey.py:130-131, which does
            # col.split(':')[2] and so harvests '' for SHORT-form cs
            # (values like ':6-ata:10' contain colons). Unreachable in
            # production — the pipeline always runs --cs=long, where the
            # two expressions agree — but we keep the whole tag value so
            # short-form input degrades to a truthful cs column instead
            # of an empty one. Ledger: docs/design.md §quirks.
            cs = col.split(":", 2)[2]
    mismatch = max(nm - ID - ambig, 0)
    matches = M - mismatch
    denom = matches + mismatch + ID + ambig
    accuracy = matches / denom if denom else 0.0

    bs = ",".join(str(x) for x in block_sizes) + ","
    qs = ",".join(str(x) for x in q_starts) + ","
    ts = ",".join(str(x) for x in t_starts) + ","
    line = (f"{matches}\t{mismatch}\t0\t{N}\t{nI}\t{I}\t{nD}\t{D}\t{strand}\t"
            f"{name}\t{q_size}\t{q_start}\t{q_end}\t{fields[2]}\t{t_size}\t"
            f"{t_start}\t{t_end}\t{len(block_sizes)}\t{bs}\t{qs}\t{ts}")
    if mando:
        line += f"\t{accuracy}\t{cs}\t{sequence}"
    return line


_POOL_JOB = None  # (chrom_sizes, mando) set by _init_pool in each worker


def _init_pool(chrom_sizes, mando) -> None:
    """Pool initializer: works under fork AND spawn (spawn workers start
    from a fresh interpreter, so module globals must be shipped here)."""
    global _POOL_JOB
    _POOL_JOB = (chrom_sizes, mando)


def _convert_batch(lines) -> str:
    chrom_sizes, mando = _POOL_JOB
    parts = []
    for line in lines:
        fields = line.rstrip("\n").split("\t")
        if fields[2] == "*":
            continue
        psl = sam_to_psl_line(fields, chrom_sizes[fields[2]], mando=mando)
        if psl is not None:
            parts.append(psl + "\n")
    return "".join(parts)


def sam_to_psl(sam_path: str, psl_path: str, mando: bool = False,
               threads: int = 1, batch_lines: int = 100_000) -> None:
    """Convert a SAM file to (extended) PSL. With threads > 1, alignment
    lines convert in pooled 100k-line batches with an ordered merge —
    mirroring the reference emtrey's pool structure
    (`emtrey.py:154-195`); output is byte-identical to the serial path."""
    import os as _os
    chrom_sizes: Dict[str, int] = {}
    with open(sam_path) as fh, open(psl_path, "w") as out:
        while True:  # readline keeps tell() usable (iteration disables it)
            body_start = fh.tell()
            line = fh.readline()
            if not line or not line.startswith("@"):
                break
            if line.startswith("@SQ"):
                a = line.rstrip("\n").split("\t")
                sn = next(x for x in a if x.startswith("SN:"))[3:]
                ln = int(next(x for x in a if x.startswith("LN:"))[3:])
                chrom_sizes[sn] = ln
        fh.seek(body_start)

        workers = max(1, min(threads, _os.cpu_count() or 1))
        if workers > 1:
            import multiprocessing as mp

            def batches():
                buf = []
                for line in fh:
                    buf.append(line)
                    if len(buf) >= batch_lines:
                        yield buf
                        buf = []
                if buf:
                    yield buf

            # fork only while single-threaded with CUDA uninitialised (a
            # CUDA context does not survive fork, and Python 3.12 warns
            # on any multi-threaded fork);
            # otherwise spawn — the job state is tiny, so spawn's
            # re-import cost amortizes over the 100k-line batches
            from mandalorion_tpu_torch.runtime import fork_ok
            ctx = mp.get_context("fork" if fork_ok() else "spawn")
            with ctx.Pool(workers, initializer=_init_pool,
                          initargs=(chrom_sizes, mando)) as pool:
                # imap preserves submission order: deterministic merge
                for chunk in pool.imap(_convert_batch, batches()):
                    out.write(chunk)
            return
        for line in fh:
            fields = line.rstrip("\n").split("\t")
            if fields[2] == "*":
                continue
            psl = sam_to_psl_line(fields, chrom_sizes[fields[2]],
                                  mando=mando)
            if psl is not None:
                out.write(psl + "\n")


def filter_sam(sam_path: str, out_path: str) -> None:
    """Drop secondary (flag 0x100) and supplementary (0x800) alignments
    (`filterIsoforms.filter_sam`, :443-459)."""
    with open(sam_path) as fh, open(out_path, "w") as out:
        for line in fh:
            if line.startswith("@"):
                out.write(line)
                continue
            flag = int(line.split("\t", 2)[1])
            if flag & 0x100 or flag & 0x800:
                continue
            out.write(line)


def psl_to_sam_line(rec, min_intron: int = 30) -> str:
    """Extended PSL record -> SAM line (interop out). Blocks break at every
    indel/intron, so the CIGAR reconstructs exactly: gaps between blocks
    with dq>0 emit I, dt>=min_intron emit N, else D."""
    cigar = []
    if rec.q_start > 0:
        cigar.append(f"{rec.q_start}S")
    for i, size in enumerate(rec.block_sizes):
        cigar.append(f"{size}M")
        if i + 1 < len(rec.block_sizes):
            dq = rec.q_starts[i + 1] - (rec.q_starts[i] + size)
            dt = rec.t_starts[i + 1] - (rec.t_starts[i] + size)
            if dq > 0:
                cigar.append(f"{dq}I")
            if dt > 0:
                cigar.append(f"{dt}N" if dt >= min_intron else f"{dt}D")
    tail = rec.q_size - rec.q_end
    if tail > 0:
        cigar.append(f"{tail}S")
    flag = 16 if rec.strand == "-" else 0
    seq = rec.sequence or "*"
    if rec.strand == "-" and seq != "*":
        seq = revcomp(seq)  # SAM stores target-forward orientation
    nm = rec.mismatches + rec.q_base_insert + rec.t_base_insert
    fields = [rec.q_name, str(flag), rec.t_name, str(rec.t_start + 1),
              "60", "".join(cigar), "*", "0", "0", seq,
              "*", f"NM:i:{nm}", "ts:A:+"]
    if rec.cs:
        fields.append(f"cs:Z:{rec.cs}")
    return "\t".join(fields)


def write_sam(path: str, records, chrom_sizes) -> None:
    """Write SAM with @SQ headers from a chrom -> size mapping."""
    with open(path, "w") as out:
        out.write("@HD\tVN:1.6\tSO:unknown\n")
        for name, size in chrom_sizes.items():
            out.write(f"@SQ\tSN:{name}\tLN:{size}\n")
        out.write("@PG\tID:mando-tpu\tPN:mando-tpu\n")
        for rec in records:
            out.write(psl_to_sam_line(rec) + "\n")
