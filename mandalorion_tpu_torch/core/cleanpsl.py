"""PSL cleaning (small-gap merging) and locus splitting.

Behavioral equivalents of `SpliceDefineConsensus.clean_psl` (SDC.py:14-93)
and `SpliceDefineConsensus.get_chromosomes` (SDC.py:442-495):

- clean_psl merges alignment gaps < minimum_intron_size (10) into their
  flanking blocks (the gap bases count as aligned), keeps gaps >= 10 as
  introns, and RECOMPUTES qStarts as qStart + cumulative cleaned block sizes
  — deliberately dropping read-insertion offsets (probed quirk, SURVEY §5.9).
  With primary=True only the first alignment per read name is kept.
- split_loci streams a sorted PSL and starts a new locus when the chromosome
  changes or start > previous_end (overlap chaining).
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Tuple

from mandalorion_tpu_torch.io.psl import PslRecord, parse_psl_line, format_psl


def merge_small_gaps(sizes: List[int], starts: List[int], t_start: int,
                     q_start: int, minimum_intron_size: int
                     ) -> Tuple[List[int], List[int], List[int]]:
    """The clean_psl core: merge sub-intron gaps into blocks and recompute
    qStarts cumulatively (dropping insertion offsets, the probed quirk).
    Returns (sizes, q_starts, t_starts). Single source of truth for
    clean_record and clean_sort_split."""
    merged = 0
    pending: List[Tuple[int, int]] = []  # (merged_block_size, following_gap)
    for i, size in enumerate(sizes):
        merged += size
        if i + 1 < len(sizes):
            gap = starts[i + 1] - (starts[i] + size)
            if gap < minimum_intron_size:
                merged += gap
            else:
                pending.append((merged, gap))
                merged = 0
    new_sizes: List[int] = []
    new_tstarts: List[int] = []
    new_qstarts: List[int] = []
    t_pos = t_start
    q_pos = q_start
    for block, gap in pending:
        new_tstarts.append(t_pos)
        new_sizes.append(block)
        new_qstarts.append(q_pos)
        t_pos += block + gap
        q_pos += block
    new_tstarts.append(t_pos)
    new_sizes.append(merged)
    new_qstarts.append(q_pos)
    return new_sizes, new_qstarts, new_tstarts


def clean_record(rec: PslRecord, minimum_intron_size: int = 10) -> PslRecord:
    """Merge sub-intron gaps into blocks; recompute qStarts cumulatively."""
    ns, nq, nt = merge_small_gaps(rec.block_sizes, rec.t_starts,
                                  rec.t_start, rec.q_start,
                                  minimum_intron_size)
    out = PslRecord(**{**rec.__dict__})
    out.block_count = len(ns)
    out.block_sizes = ns
    out.q_starts = nq
    out.t_starts = nt
    return out


def clean_psl_file(psl_path: str, out_path: str, primary: bool,
                   minimum_intron_size: int = 10) -> None:
    """File-level clean_psl with first-alignment-per-name dedup."""
    used = set()
    with open(psl_path) as fh, open(out_path, "w") as out:
        for line in fh:
            if not line.strip():
                continue
            rec = parse_psl_line(line)
            if primary and rec.q_name in used:
                continue
            out.write(format_psl(clean_record(rec, minimum_intron_size)) + "\n")
            used.add(rec.q_name)


def iter_loci(lines: Iterable[str]) -> Iterator[Tuple[str, int, int, List[str]]]:
    """Group sorted PSL lines into loci. Yields (chrom, start, end, lines).

    A new locus starts when the chromosome changes or start > previous_end;
    previous_end grows to max(end, previous_end) within a locus
    (SDC.py:442-495, including the v4.0.0 first-read fix at :479).
    """
    reads: List[str] = []
    prev_chrom = ""
    prev_start = 0
    prev_end = 0
    for line in lines:
        if not line.strip():
            continue
        a = line.split("\t", 17)
        chrom = a[13]
        start = int(a[15])
        end = int(a[16])
        if chrom != prev_chrom or start > prev_end:
            if reads:
                yield prev_chrom, prev_start, prev_end, reads
            reads = [line]
            prev_chrom = chrom
            prev_start = start
            prev_end = end
        else:
            prev_end = max(end, prev_end)
            reads.append(line)
    if reads:
        yield prev_chrom, prev_start, prev_end, reads


def split_loci(sorted_psl_path: str, out_dir: str) -> Dict[str, str]:
    """Write one `<chrom>~<start>~<end>.psl` per locus (locus PSL contract,
    SURVEY §2.4). Returns read_name -> locus_root."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    read_to_root: Dict[str, str] = {}
    with open(sorted_psl_path) as fh:
        for chrom, start, end, lines in iter_loci(fh):
            root = f"{chrom}~{start}~{end}"
            with open(os.path.join(out_dir, root + ".psl"), "w") as out:
                for line in lines:
                    out.write(line)
                    read_to_root[line.split("\t", 10)[9]] = root
    return read_to_root


def clean_sort_split(psl_path: str, clean_path: str, sorted_path: str,
                     out_dir: str, minimum_intron_size: int = 10
                     ) -> Dict[str, str]:
    """One-pass module P: parse each alignment once, clean it, then write
    all three stage artifacts (clean, clean.sorted, per-locus files) from
    the in-memory lines — the -M resume contract unchanged, the extended
    PSL (long lines carry read sequences) parsed only once."""
    import os

    used = set()
    # decorate-sort-undecorate: each entry is (chrom, tStart, line, tEnd,
    # name) so the sort needs no key function and the locus split no
    # re-parse. Natural tuple order == psl_sort_key's GNU `sort -k 14,14
    # -k 16,17n` C-collation order: UTF-8 encoding preserves codepoint
    # order, so comparing the str chrom/line equals comparing their
    # bytes; tEnd/name only break ties between IDENTICAL lines, where
    # any order is the same output.
    cleaned: List[tuple] = []
    with open(psl_path) as fh, open(clean_path, "w") as out:
        buf: List[str] = []
        for line in fh:
            if not line.strip():
                continue
            # cleaning only rewrites cols 17-20; surgical splice avoids a
            # full record parse/format round-trip on the long lines, and
            # maxsplit leaves the long tail (cs + sequence) unscanned
            a = line.rstrip("\n").split("\t", 21)
            name = a[9]
            if name in used:  # primary only
                continue
            used.add(name)
            sizes = [int(x) for x in a[18].split(",")[:-1]]
            starts = [int(x) for x in a[20].split(",")[:-1]]
            ns, nq, nt = merge_small_gaps(sizes, starts, int(a[15]),
                                          int(a[11]), minimum_intron_size)
            a[17] = str(len(ns))
            a[18] = ",".join(map(str, ns)) + ","
            a[19] = ",".join(map(str, nq)) + ","
            a[20] = ",".join(map(str, nt)) + ","
            out_line = "\t".join(a) + "\n"
            cleaned.append((a[13], int(a[15]), out_line, int(a[16]), name))
            buf.append(out_line)
            if len(buf) == 4096:  # chunked writes: IO-bound stage
                out.write("".join(buf))
                buf = []
        if buf:
            out.write("".join(buf))
    cleaned.sort()
    with open(sorted_path, "w") as out:
        out.writelines(entry[2] for entry in cleaned)
    os.makedirs(out_dir, exist_ok=True)
    read_to_root: Dict[str, str] = {}
    # locus grouping on the carried (chrom, tStart, tEnd): a new locus
    # when the chromosome changes or start > previous_end, previous_end
    # growing to max(end, previous_end) — exactly iter_loci's rule
    # (SDC.py:442-495 incl. the v4.0.0 first-read fix)
    i = 0
    n_entries = len(cleaned)
    while i < n_entries:
        chrom, start, _line, end, _name = cleaned[i]
        j = i + 1
        while j < n_entries:
            c2, s2, _l2, e2, _n2 = cleaned[j]
            if c2 != chrom or s2 > end:
                break
            end = max(end, e2)
            j += 1
        root = f"{chrom}~{start}~{end}"
        with open(os.path.join(out_dir, root + ".psl"), "w") as out:
            out.write("".join(cleaned[k][2] for k in range(i, j)))
        for k in range(i, j):
            read_to_root[cleaned[k][4]] = root
        i = j
    return read_to_root


def _shard_ranges(path: str, n: int) -> List[Tuple[int, int]]:
    """Split a file into up to n line-aligned byte ranges."""
    import os
    size = os.path.getsize(path)
    if size == 0:
        return []
    cuts = [0]
    with open(path, "rb") as fh:
        for k in range(1, n):
            pos = size * k // n
            if pos <= cuts[-1]:
                continue
            fh.seek(pos)
            fh.readline()
            p = fh.tell()
            if cuts[-1] < p < size:
                cuts.append(p)
    cuts.append(size)
    return list(zip(cuts, cuts[1:]))


def _clean_shard_worker(job):
    """Fork-pool worker: parse + clean the lines in one byte range of the
    input PSL (all in bytes — int() accepts ASCII bytes, so no decode)
    and return the cleaned blob plus the per-line sort keys (chrom,
    tStart, tEnd, name, blob offset/length) the parent needs for the
    global sort and locus split. The blob travels via a SharedMemory
    segment — shard files doubled the stage's disk traffic, and pool
    pipes move ~600 MB of pickle at single-digit-GB/s through a single
    result queue. The parent names the segment and unlinks it, whether
    or not this worker gets as far as creating it."""
    import numpy as np
    from multiprocessing import shared_memory, resource_tracker
    psl_path, lo, hi, mis, seg_name = job
    with open(psl_path, "rb") as fh:
        fh.seek(lo)
        data = fh.read(hi - lo)
    out_parts: List[bytes] = []
    names: List[bytes] = []
    chroms: List[bytes] = []
    tstarts: List[int] = []
    tends: List[int] = []
    lens: List[int] = []
    for ln in data.split(b"\n"):
        if not ln.strip():
            continue
        a = ln.split(b"\t", 21)
        sizes = [int(x) for x in a[18].split(b",")[:-1]]
        starts = [int(x) for x in a[20].split(b",")[:-1]]
        ns, nq, nt = merge_small_gaps(sizes, starts, int(a[15]),
                                      int(a[11]), mis)
        a[17] = b"%d" % len(ns)
        a[18] = b",".join(b"%d" % x for x in ns) + b","
        a[19] = b",".join(b"%d" % x for x in nq) + b","
        a[20] = b",".join(b"%d" % x for x in nt) + b","
        out = b"\t".join(a) + b"\n"
        out_parts.append(out)
        names.append(a[9])
        chroms.append(a[13])
        tstarts.append(int(a[15]))
        tends.append(int(a[16]))
        lens.append(len(out))
    blob = b"".join(out_parts)
    shm = shared_memory.SharedMemory(name=seg_name, create=True,
                                     size=max(len(blob), 1))
    # the PARENT owns cleanup (it unlinks every segment name it handed
    # out, in a finally); unregister here so this process's resource
    # tracker doesn't reclaim or warn about a segment it does not own
    resource_tracker.unregister(shm._name, "shared_memory")
    try:
        shm.buf[:len(blob)] = blob
    finally:
        shm.close()
    name = seg_name
    size = len(blob)
    lens_a = np.array(lens, np.int64)
    offs = np.zeros(len(lens), np.int64)
    np.cumsum(lens_a[:-1], out=offs[1:])
    return ((name, size), names, chroms, np.array(tstarts, np.int64),
            np.array(tends, np.int64), offs, lens_a)


def clean_sort_split_parallel(psl_path: str, clean_path: str,
                              sorted_path: str, out_dir: str,
                              minimum_intron_size: int = 10,
                              threads: int = 2,
                              defer_checkpoints: bool = False):
    """clean_sort_split with the PARSE sharded over a fork pool (module
    A's byte-range pattern): workers clean disjoint line-aligned byte
    ranges and hand back cleaned blobs through SharedMemory segments
    plus compact sort keys; the parent concatenates the blobs into
    clean.psl, numpy-lexsorts (chrom, tStart) with the GNU last-resort
    whole-line tie-break applied only inside equal-key runs, and writes
    the sorted + per-locus artifacts as byte slices — no line is parsed
    twice anywhere. Byte-identical to clean_sort_split at any worker
    count (tests/test_core_parity.py). The serial path remains the
    fallback (and handles the primary-dedup case: duplicate read names
    can only come from external PSL/SAM input, never module A).

    With defer_checkpoints=True the clean.psl / clean.sorted.psl writes
    happen in a background fork and the return is
    (read_to_root, writer_process) — see module_p."""
    import os
    import multiprocessing as mp

    import numpy as np

    ranges = _shard_ranges(psl_path, max(threads, 1) * 2)
    if len(ranges) < 2:
        return clean_sort_split(psl_path, clean_path, sorted_path,
                                out_dir, minimum_intron_size)
    import uuid
    from multiprocessing import shared_memory
    # the parent names every segment up front, so that it can unlink them
    # all in the finally below even when a worker fails and pool.map
    # raises without returning the other workers' results
    tag = f"mando_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    seg_names = [f"{tag}_{k}" for k in range(len(ranges))]
    jobs = [(psl_path, lo, hi, minimum_intron_size, seg_name)
            for (lo, hi), seg_name in zip(ranges, seg_names)]
    ctx = mp.get_context("fork")
    segs = []
    try:
        with ctx.Pool(min(threads, len(jobs))) as pool:
            shards = pool.map(_clean_shard_worker, jobs)
        for sh in shards:
            name, size = sh[0]
            segs.append((shared_memory.SharedMemory(name=name), size))
        return _finish_parallel(shards, segs, psl_path, clean_path,
                                sorted_path, out_dir,
                                minimum_intron_size, defer_checkpoints)
    finally:
        attached = {seg.name.lstrip("/") for seg, _size in segs}
        for seg, _size in segs:
            seg.close()
            seg.unlink()
        for seg_name in seg_names:
            if seg_name in attached:
                continue
            try:
                seg = shared_memory.SharedMemory(name=seg_name)
            except FileNotFoundError:
                continue  # the worker never created it
            seg.close()
            seg.unlink()


def _finish_parallel(shards, segs, psl_path, clean_path, sorted_path,
                     out_dir, minimum_intron_size, defer):
    import os
    import numpy as np
    all_names: List[bytes] = []
    for sh in shards:
        all_names.extend(sh[1])
    if len(set(all_names)) != len(all_names):
        # primary-only dedup needs global first-seen order: rare
        # (external input only) — use the serial reference path
        d = clean_sort_split(psl_path, clean_path, sorted_path,
                             out_dir, minimum_intron_size)
        return (d, None) if defer else d

    # one memcpy out of shared memory (so the segments can be closed
    # without exported-pointer bookkeeping); the bytes serve every write
    blobs = [bytes(seg.buf[:size]) for seg, size in segs]

    chroms = [c for sh in shards for c in sh[2]]
    tstart = np.concatenate([sh[3] for sh in shards]) \
        if shards else np.zeros(0, np.int64)
    tend = np.concatenate([sh[4] for sh in shards])
    shard_id = np.concatenate(
        [np.full(len(sh[1]), si, np.int32)
         for si, sh in enumerate(shards)])
    off = np.concatenate([sh[5] for sh in shards])
    ln = np.concatenate([sh[6] for sh in shards])
    vocab = sorted(set(chroms))
    cid_of = {c: i for i, c in enumerate(vocab)}
    cid = np.fromiter((cid_of[c] for c in chroms), np.int32,
                      len(chroms))

    def line_at(i: int) -> bytes:
        return blobs[shard_id[i]][off[i]:off[i] + ln[i]]

    # stable (chrom, tStart) sort, then the whole-line last-resort
    # tie-break inside equal-key runs only (decorate-sort-undecorate's
    # third tuple element, applied lazily)
    order = np.lexsort((np.arange(len(cid)), tstart, cid))
    k0 = 0
    n = len(order)
    while k0 < n:
        k1 = k0 + 1
        i0 = order[k0]
        while k1 < n and cid[order[k1]] == cid[i0] \
                and tstart[order[k1]] == tstart[i0]:
            k1 += 1
        if k1 - k0 > 1:
            run = sorted(order[k0:k1].tolist(), key=line_at)
            order[k0:k1] = run
        k0 = k1

    def write_checkpoints():
        # clean.psl (input order) + clean.sorted.psl: -M resume
        # checkpoints no stage reads during the run — with defer=True
        # they write in a background fork (overlapping module D)
        with open(clean_path, "wb") as out:
            for blob in blobs:
                out.write(blob)
        with open(sorted_path, "wb") as out:
            buf: List[bytes] = []
            for i in order:
                buf.append(line_at(i))
                if len(buf) == 4096:
                    out.write(b"".join(buf))
                    buf = []
            out.write(b"".join(buf))

    os.makedirs(out_dir, exist_ok=True)
    read_to_root: Dict[str, str] = {}
    names = all_names
    k0 = 0
    while k0 < n:
        i0 = order[k0]
        chrom_b = chroms[i0]
        start = int(tstart[i0])
        end = int(tend[i0])
        k1 = k0 + 1
        while k1 < n:
            i1 = order[k1]
            if chroms[i1] != chrom_b or int(tstart[i1]) > end:
                break
            e2 = int(tend[i1])
            end = e2 if e2 > end else end
            k1 += 1
        root = f"{chrom_b.decode()}~{start}~{end}"
        with open(os.path.join(out_dir, root + ".psl"), "wb") as out:
            out.write(b"".join(line_at(order[k]) for k in range(k0, k1)))
        for k in range(k0, k1):
            read_to_root[names[order[k]].decode()] = root
        k0 = k1
    if defer:
        import multiprocessing as mp
        proc = mp.get_context("fork").Process(target=write_checkpoints)
        proc.start()
        return read_to_root, proc
    write_checkpoints()
    return read_to_root


def discover_loci(out_dir: str) -> List[str]:
    """Re-discover locus roots from a tmp_SS directory, sorted by
    (chrom, start) like `defineIsoforms.py:126`."""
    import os

    roots = []
    for f in os.listdir(out_dir):
        if f.endswith(".psl") and os.path.isfile(os.path.join(out_dir, f)):
            roots.append(f[:-len(".psl")])
    return sorted(roots, key=lambda r: (r.split("~")[0], int(r.split("~")[1])))
