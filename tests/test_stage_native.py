"""Native device-path staging (stage_*_batch_c) parity.

The staged device path (aligner._map_batch_device_staged: C seed ->
chain kernel -> C fill -> fused DP kernel -> C emit, two fetches total)
must be byte-identical to the Python-staged device path AND to the host
path — the same invariant the backend-parity tests enforce pairwise
(VERDICT r4 #1: both paths share the native staging engine).
"""

import os

import pytest

from mandalorion_tpu.config import AlignConfig
from mandalorion_tpu.align.aligner import SpliceAligner
from mandalorion_tpu.native import load_native

pytestmark = pytest.mark.skipif(load_native() is None,
                                reason="native library unavailable")


def _dataset(tmp_path, seed=0, n_genes=3, reads_per_gene=20):
    from mandalorion_tpu.utils.simulate import make_dataset
    from mandalorion_tpu.io.fastx import read_fastx, fastx_to_dict
    d = str(tmp_path / f"ds{seed}")
    make_dataset(d, n_genes=n_genes, n_reads_per_gene=reads_per_gene,
                 genome_len=30_000 * n_genes, seed=seed)
    genome = fastx_to_dict(os.path.join(d, "genome.fasta"))
    reads = [(nm, sq) for nm, sq, _q in
             read_fastx(os.path.join(d, "reads.fasta"))]
    return genome, reads


def test_staged_matches_python_and_host(tmp_path):
    genome, reads = _dataset(tmp_path)
    host = SpliceAligner(genome, AlignConfig())
    dev = SpliceAligner(genome, AlignConfig(chain_backend="device",
                                            dp_backend="rowscan"))
    out_host = [str(r) for r in host.map_batch(reads)]
    staged = dev._map_batch_device_staged(reads)
    assert staged is not None, "staged path unexpectedly unavailable"
    out_staged = [str(r) for r in staged]
    # the python-staged device path (bypassing the native staging)
    picks = dev._chain_batch_device(reads)
    from mandalorion_tpu.align.aligner import cfg_min_len
    from mandalorion_tpu.align.extend import DpProblem
    problems, pendings = [], []
    for (name, seq), picked in zip(reads, picks):
        if picked is None:
            continue
        chain, strand, ci, q_codes = picked
        if float(sum(s.length for s in chain)) < cfg_min_len(dev.cfg):
            continue
        pend = dev._fill(name, seq, strand, q_codes, chain, ci, problems)
        if pend is not None:
            pendings.append(pend)
    modes = [p.mode for p in problems]
    results = dev.dp_backend(problems, dev.cfg)
    out_py = []
    for pend in pendings:
        rec = dev._emit(pend, results, modes)
        if rec is not None:
            out_py.append(str(rec))

    assert out_staged == out_py, "staged != python-staged device path"
    assert out_staged == out_host, "staged device path != host path"


def test_staged_handles_unalignable_and_empty(tmp_path):
    genome, reads = _dataset(tmp_path, seed=1, n_genes=2, reads_per_gene=5)
    dev = SpliceAligner(genome, AlignConfig(chain_backend="device",
                                            dp_backend="rowscan"))
    # junk reads seed no candidates; an empty batch returns []
    junk = [("junk1", "ACGT" * 8), ("junk2", "TTTTGGGGCCCCAAAA")]
    out = dev._map_batch_device_staged(reads + junk)
    host = SpliceAligner(genome, AlignConfig())
    assert [str(r) for r in out] == \
        [str(r) for r in host.map_batch(reads + junk)]
    assert dev._map_batch_device_staged([]) == []


def test_staged_via_public_map_batch(tmp_path):
    """map_batch routes chain_backend='device' through the staged path
    (same records, public surface)."""
    genome, reads = _dataset(tmp_path, seed=2)
    host = SpliceAligner(genome, AlignConfig())
    dev = SpliceAligner(genome, AlignConfig(chain_backend="device",
                                            dp_backend="rowscan"))
    assert [str(r) for r in dev.map_batch(reads)] == \
        [str(r) for r in host.map_batch(reads)]


def test_staged_multichromosome(tmp_path):
    """Candidates split per chromosome and must iterate read -> strand ->
    chromosome ASCENDING in the native seed stage, matching the Python
    staging's pick order — a 3-chromosome genome exercises the ordering
    and the cross-chromosome tie-breaks end to end."""
    import numpy as np
    sys_path = __import__("sys").path
    import synthdata
    from mandalorion_tpu.io.fastx import revcomp

    rng = np.random.default_rng(5)
    genomes = {}
    reads = []
    for ci in range(3):
        chrom = f"chr{ci + 1}"
        genome = synthdata.make_genome(25_000, seed=300 + ci)
        base = 4000
        exons = [(base, base + 400), (base + 1500, base + 2000),
                 (base + 3500, base + 3900)]
        strand = "+" if ci % 2 == 0 else "-"
        genome = synthdata.plant_introns(genome, exons, strand=strand)
        t = synthdata.transcript_seq(genome, exons)
        if strand == "-":
            t = revcomp(t)
        for k in range(15):
            r, _ = synthdata.mutate_read(t, rng, 0.03)
            reads.append((f"c{ci}r{k}", r))
        genomes[chrom] = genome

    host = SpliceAligner(genomes, AlignConfig())
    dev = SpliceAligner(genomes, AlignConfig(chain_backend="device",
                                             dp_backend="rowscan"))
    out_staged = dev._map_batch_device_staged(reads)
    assert out_staged is not None
    assert [str(r) for r in out_staged] == \
        [str(r) for r in host.map_batch(reads)]


def test_staged_seed_capacity_retry_and_cross_chrom_candidates(tmp_path):
    """Reads homologous to ALL chromosomes produce 2*chroms candidates
    per read — more than the seed stage's initial 2-per-read capacity
    guess, so the -needed retry path runs; the best-candidate pick must
    still match the Python staging's strict-> order across chromosomes
    (first chromosome wins score ties)."""
    import numpy as np
    import synthdata

    rng = np.random.default_rng(9)
    core = synthdata.make_genome(6000, seed=77)
    genomes = {}
    for ci in range(6):
        # same core sequence on every chromosome, lightly diverged on
        # all but chr1 so chr1 wins most picks but others still seed
        g = list(core)
        for _ in range(ci * 25):
            p = int(rng.integers(0, len(g)))
            g[p] = "ACGT"[int(rng.integers(0, 4))]
        genomes[f"chr{ci + 1}"] = "".join(g)
    reads = []
    for k in range(20):
        r, _ = synthdata.mutate_read(core[500:3500], rng, 0.02)
        reads.append((f"r{k}", r))
    # 20 reads x 2 orientations x up-to-6 chromosomes > the initial
    # cap of max(64, 2*n_reads): the -needed retry must run
    host = SpliceAligner(genomes, AlignConfig())
    dev = SpliceAligner(genomes, AlignConfig(chain_backend="device",
                                             dp_backend="rowscan"))
    out = dev._map_batch_device_staged(reads)
    assert out is not None
    assert [str(r) for r in out] == [str(r) for r in host.map_batch(reads)]


# ------------------------------------------------ the port's C seed stage
# on threads: mandalorion_tpu_torch.native.native_stage_seed_batch splits
# its reads into blocks of 16 over the threads it is given, and must give
# the serial call's candidates bit for bit.

def _port_seed_inputs(genome, reads):
    """(index, max_occ, codes_all, read_off) of `reads` on the port's
    index of `genome`."""
    import numpy as np
    from mandalorion_tpu_torch.align.aligner import SpliceAligner as Port
    from mandalorion_tpu_torch.align.encode import encode
    from mandalorion_tpu_torch.config import AlignConfig as PortConfig
    aligner = Port(genome, PortConfig())
    codes = [encode(seq) for _name, seq in reads]
    read_off = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(c) for c in codes], out=read_off[1:])
    codes_all = (np.concatenate(codes) if codes
                 else np.zeros(0, np.uint8))
    return aligner, codes_all, read_off


def _seed_case(case, tmp_path):
    """The genome and reads of one case of the thread-count test."""
    import numpy as np
    import synthdata
    from mandalorion_tpu.io.fastx import revcomp
    if case == "many_blocks":
        # 600 reads: 38 blocks, more threads than this host's cores at
        # t8 and above
        return _dataset(tmp_path, seed=4, reads_per_gene=200)
    if case in ("simulated", "empty", "short_and_no_hit"):
        genome, reads = _dataset(tmp_path, seed=3)
        if case == "empty":
            return genome, []
        if case == "short_and_no_hit":
            # a read shorter than k and reads with no hit, in the first,
            # a middle and the last block
            odd = [("short", "ACGTACG"), ("nohit", "ACGT" * 40),
                   ("empty_read", "")]
            reads = odd[:1] + reads[:30] + odd[1:2] + reads[30:] + odd[2:]
        return genome, reads
    rng = np.random.default_rng(5)
    if case == "multichromosome":
        genomes, reads = {}, []
        for ci in range(3):
            genome = synthdata.make_genome(25_000, seed=300 + ci)
            exons = [(4000, 4400), (5500, 6000), (7500, 7900)]
            strand = "+" if ci % 2 == 0 else "-"
            genome = synthdata.plant_introns(genome, exons, strand=strand)
            t = synthdata.transcript_seq(genome, exons)
            if strand == "-":
                t = revcomp(t)
            reads += [(f"c{ci}r{k}", synthdata.mutate_read(t, rng, 0.03)[0])
                      for k in range(15)]
            genomes[f"chr{ci + 1}"] = genome
        order = rng.permutation(len(reads))
        return genomes, [reads[i] for i in order]
    # "homologs": every read seeds on all six chromosomes, more
    # candidates than the stage's first cap of max(64, 2 * n_reads)
    core = synthdata.make_genome(6000, seed=77)
    genomes = {}
    for ci in range(6):
        g = list(core)
        for _ in range(ci * 25):
            g[int(rng.integers(0, len(g)))] = "ACGT"[int(rng.integers(0, 4))]
        genomes[f"chr{ci + 1}"] = "".join(g)
    reads = [(f"r{k}", synthdata.mutate_read(core[500:3500], rng, 0.02)[0])
             for k in range(40)]
    return genomes, reads


@pytest.mark.parametrize("threads", [2, 3, 8, 1000],
                         ids=["t2", "t3", "t8", "more_than_reads"])
@pytest.mark.parametrize("case", ["simulated", "empty", "short_and_no_hit",
                                  "multichromosome", "homologs",
                                  "many_blocks"])
def test_port_seed_batch_same_for_every_thread_count(tmp_path, case,
                                                     threads):
    """native_stage_seed_batch on `threads` threads gives the serial
    call's n_cand and all seven arrays bit for bit; with a cap too small
    the C entry returns the serial call's -needed, and the rows below
    the cap are the serial call's too."""
    import numpy as np
    from mandalorion_tpu_torch import native
    genome, reads = _seed_case(case, tmp_path)
    aligner, codes_all, read_off = _port_seed_inputs(genome, reads)
    cfg = aligner.cfg

    def seed(t):
        return native.native_stage_seed_batch(
            codes_all, read_off, cfg.kmer, cfg.window, aligner.max_occ, 100,
            aligner.index, cfg.max_intron, threads=t)

    want, got = seed(1), seed(threads)
    used = native.native_stage_seed_threads(len(reads), threads)
    assert used == (1 if len(reads) <= 16
                    else min(threads, -(-len(reads) // 16)))
    if case != "empty":
        assert used > 1 and want[0] > 0
    assert got[0] == want[0]
    flat = lambda out: list(out[1:6]) + list(out[6])
    for a, b in zip(flat(got), flat(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)

    # the C entry itself, at a cap below the candidates' count
    lib = native.load_native()
    index = aligner.index
    pos_u32 = 1 if index.sorted_positions.dtype == np.uint32 else 0
    cap = max(1, want[0] // 3)

    def at_cap(t):
        out = [np.zeros(cap, np.int32), np.zeros(cap, np.int8),
               np.zeros(cap, np.int32), np.zeros(cap, np.int64),
               np.zeros(cap, np.int32)] + \
            [np.zeros((cap, 512), np.int32) for _ in range(5)]
        n = lib.stage_seed_batch_c(
            codes_all.ctypes.data, read_off.ctypes.data, len(reads),
            cfg.kmer, cfg.window, aligner.max_occ, 100,
            index.sorted_hashes.ctypes.data, index.bucket_lo.ctypes.data,
            index.bucket_bits, index.sorted_positions.ctypes.data, pos_u32,
            index.chrom_offsets.ctypes.data, len(index.chrom_offsets),
            cfg.max_intron, 512, cap, *(o.ctypes.data for o in out), t)
        return n, out

    n1, rows1 = at_cap(1)
    nt, rows_t = at_cap(threads)
    assert n1 == nt == (want[0] if want[0] <= cap else -want[0])
    for a, b in zip(rows_t, rows1):
        assert np.array_equal(a, b)
