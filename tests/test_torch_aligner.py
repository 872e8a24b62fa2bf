"""TorchSpliceAligner (module A's device route on PyTorch) against the
host SpliceAligner: identical PSL records, record for record.

On the CPU both device stages run their kernels' plain PyTorch versions;
the three native C stages are the port's own library. The harness follows
tests/test_stage_native.py: several chromosomes, the seed stage's
capacity retry, junk and empty reads, and an aligner built from another
one's index. The host aligner is the reference's, on its default (host)
pair; the port aligner runs the pair of the port's default configuration
(`DEVICE_ROUTE`: chain and DP on the device), since a TorchSpliceAligner
runs the route its configuration names. The mixed pairs are in
tests/test_torch_routes.py.
"""

import os

import numpy as np
import pytest
import torch

from mandalorion_tpu.align.aligner import SpliceAligner
from mandalorion_tpu.config import AlignConfig
from mandalorion_tpu.native import load_native
from mandalorion_tpu_torch.align import chain_kernel, kernels
from mandalorion_tpu_torch.align.aligner import (
    SpliceAligner as PortSpliceAligner, TorchSpliceAligner)
from mandalorion_tpu_torch.config import AlignConfig as PortAlignConfig

pytestmark = pytest.mark.skipif(load_native() is None,
                                reason="native library unavailable")

DEVICE_ROUTE = PortAlignConfig()


def _dataset(tmp_path, seed=0, n_genes=3, reads_per_gene=20):
    from mandalorion_tpu.io.fastx import fastx_to_dict, read_fastx
    from mandalorion_tpu.utils.simulate import make_dataset
    d = str(tmp_path / f"ds{seed}")
    make_dataset(d, n_genes=n_genes, n_reads_per_gene=reads_per_gene,
                 genome_len=30_000 * n_genes, seed=seed)
    genome = fastx_to_dict(os.path.join(d, "genome.fasta"))
    reads = [(nm, sq) for nm, sq, _q in
             read_fastx(os.path.join(d, "reads.fasta"))]
    return genome, reads


def _same(port, host, reads):
    got = [str(r) for r in port.map_batch(reads)]
    want = [str(r) for r in host.map_batch(reads)]
    assert got == want
    return got


@pytest.mark.parametrize("seed", [0, 2])
def test_map_batch_matches_host(tmp_path, seed):
    genome, reads = _dataset(tmp_path, seed=seed)
    port = TorchSpliceAligner(genome, DEVICE_ROUTE, device="cpu")
    assert len(_same(port, SpliceAligner(genome, AlignConfig()), reads)) \
        > len(reads) // 2


def test_unalignable_and_empty_batches(tmp_path):
    genome, reads = _dataset(tmp_path, seed=1, n_genes=2, reads_per_gene=5)
    host = SpliceAligner(genome, AlignConfig())
    port = TorchSpliceAligner.from_aligner(host, device="cpu",
                                           cfg=DEVICE_ROUTE)
    junk = [("junk1", "ACGT" * 8), ("junk2", "TTTTGGGGCCCCAAAA")]
    _same(port, host, reads + junk)
    assert port.map_batch(junk) == []
    assert port.map_batch([]) == []


def test_multichromosome(tmp_path):
    """Candidates iterate read -> strand -> chromosome ascending; three
    chromosomes with genes on both strands."""
    import synthdata
    from mandalorion_tpu.io.fastx import revcomp
    rng = np.random.default_rng(5)
    genomes, reads = {}, []
    for ci in range(3):
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
        genomes[f"chr{ci + 1}"] = genome
    host = SpliceAligner(genomes, AlignConfig())
    _same(TorchSpliceAligner.from_aligner(host, device="cpu",
                                          cfg=DEVICE_ROUTE), host, reads)


def test_seed_capacity_retry_and_cross_chrom_candidates():
    """Reads homologous to all six chromosomes give more candidates than
    the seed stage's first capacity guess (2 per read), so its retry
    runs; the first chromosome wins score ties."""
    import synthdata
    rng = np.random.default_rng(9)
    core = synthdata.make_genome(6000, seed=77)
    genomes = {}
    for ci in range(6):
        g = list(core)
        for _ in range(ci * 25):
            p = int(rng.integers(0, len(g)))
            g[p] = "ACGT"[int(rng.integers(0, 4))]
        genomes[f"chr{ci + 1}"] = "".join(g)
    reads = []
    for k in range(20):
        r, _ = synthdata.mutate_read(core[500:3500], rng, 0.02)
        reads.append((f"r{k}", r))
    host = SpliceAligner(genomes, AlignConfig())
    port = TorchSpliceAligner.from_aligner(host, device="cpu",
                                           cfg=DEVICE_ROUTE)
    _codes, _off, seeded = port.seed_batch(reads)
    assert seeded[0] > max(64, 2 * len(reads))
    _same(port, host, reads)


def test_from_aligner_shares_the_index(tmp_path):
    genome, reads = _dataset(tmp_path, seed=3, n_genes=2, reads_per_gene=8)
    host = SpliceAligner(genome, AlignConfig())
    assert TorchSpliceAligner.from_aligner(host, device="cpu").cfg \
        is host.cfg
    port = TorchSpliceAligner.from_aligner(host, device="cpu",
                                           cfg=DEVICE_ROUTE)
    assert port.index is host.index and port.max_occ == host.max_occ
    # on the CPU the resident genome tensor is the index's own buffer
    assert port.genome_codes.data_ptr() == \
        host.index.seq_codes.ctypes.data
    assert port.cfg is DEVICE_ROUTE
    twin = port.host_twin()
    assert type(twin) is PortSpliceAligner and twin.index is host.index
    _same(port, host, reads)
    _same(twin, host, reads)


def test_map_batch_runs_both_device_stages(tmp_path, monkeypatch):
    """map_batch goes through chain_rows and dp_fused, once each per
    batch (on the CPU, their plain versions)."""
    genome, reads = _dataset(tmp_path, seed=4, n_genes=2, reads_per_gene=6)
    port = TorchSpliceAligner(genome, DEVICE_ROUTE, device="cpu")
    calls = []
    for mod, name in ((chain_kernel, "chain_rows_plain"),
                      (kernels, "dp_fused_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    port.map_batch(reads)
    assert calls == ["chain_rows_plain", "dp_fused_plain"]


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    genome, _reads = _dataset(tmp_path, seed=5, n_genes=1, reads_per_gene=2)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchSpliceAligner(genome, AlignConfig(), device="cuda")
    host = SpliceAligner(genome, AlignConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        TorchSpliceAligner.from_aligner(host, device="cuda")


def test_sharded_index_not_ported(tmp_path):
    """index_backend='sharded' now runs: without a mesh the index stays
    replicated (the reference's rule); under a three-shard CPU mesh the
    seed lookups go through the hash-range shards and the records equal
    the host aligner's."""
    from mandalorion_tpu_torch.config import AlignConfig as PortConfig
    from mandalorion_tpu_torch.parallel.mesh import make_mesh, use_mesh
    genome, reads = _dataset(tmp_path, seed=3, n_genes=2, reads_per_gene=8)
    cfg = PortConfig(index_backend="sharded")
    assert TorchSpliceAligner(genome, cfg, device="cpu")._sharded is None
    host = SpliceAligner(genome, AlignConfig())
    with use_mesh(make_mesh(3, device="cpu")):
        port = TorchSpliceAligner(genome, cfg, device="cpu")
        assert port._sharded is not None and port._sharded.n_shards == 3
        assert len(_same(port, host, reads + [("junk", "ACGT" * 8)])) \
            > len(reads) // 2
