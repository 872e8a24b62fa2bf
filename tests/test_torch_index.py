"""Module A on a genome index without its bucket table (`bucket_lo` None),
against mandalorion_tpu on the same index.

Such an index is a caller's own GenomeIndex, or a directory index cache
without bucket_lo.npy (the loader reads the arrays that are present).
The reference seeds it in numpy; so does the port (`numpy_seeding`):

- `GenomeIndex.lookup` takes numpy's searchsorted ranges, equal to the
  reference's and to the bucketed lookup;
- `GenomeIndex.seed_segments` returns None, as the reference's does, on
  a bucket-less index and without the native library;
- the aligner's map_batch, map_batch_runs and map_all_targets on a
  bucket-less index equal the reference aligner's on the same index and
  the port's on the bucketed one, on every (chain, dp) pair;
- `mando-tpu-torch --device cpu --index_cache` on a bucket-less cache
  writes the six artifacts of `mandalorion_tpu`'s run_pipeline on the
  same cache (its 'rowscan' DP standing for 'pallas', as
  tests/test_torch_routes.py runs it) and of the port's own run on the
  bucketed cache, byte for byte, on every (chain, dp) pair;
- `--index_backend sharded` on a bucket-less index raises, naming the
  bucket table (the reference's hash-range split reads it too).

Every comparison is exact.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from mandalorion_tpu.align import index as ref_index
from mandalorion_tpu.align.aligner import SpliceAligner as RefAligner
from mandalorion_tpu.config import AlignConfig as RefAlignConfig
from mandalorion_tpu.config import config_from_args as reference_config
from mandalorion_tpu.pipeline.cli import build_parser as reference_parser
from mandalorion_tpu.pipeline.stages import run_pipeline as reference_run
from mandalorion_tpu_torch import native as port_native
from mandalorion_tpu_torch.align import index as port_index
from mandalorion_tpu_torch.align.aligner import TorchSpliceAligner
from mandalorion_tpu_torch.align.encode import minimizers
from mandalorion_tpu_torch.config import AlignConfig
from mandalorion_tpu_torch.io.fastx import fastx_to_dict, read_fastx
from mandalorion_tpu_torch.pipeline import cli
from mandalorion_tpu_torch.utils.simulate import make_dataset, make_genome

ARTIFACTS = ("Isoforms.filtered.fasta", "Isoforms.filtered.clean.psl",
             "Isoforms.filtered.clean.gtf", "Isoforms.filtered.clean.quant",
             "Isoforms.filtered.clean.tpm",
             os.path.join("tmp", "reads2isoforms.txt"))
# the port's pair, and the reference's pair it is held against
PAIRS = {("device", "device"): ("device", "rowscan"),
         ("device", "rowscan"): ("device", "rowscan"),
         ("device", "numpy"): ("device", "numpy"),
         ("native", "device"): ("native", "rowscan"),
         ("native", "rowscan"): ("native", "rowscan"),
         ("native", "numpy"): ("native", "numpy")}

pytestmark = pytest.mark.skipif(port_native.load_native() is None,
                                reason="native library unavailable")


def _unload(monkeypatch):
    """Both packages as MANDO_TPU_NO_NATIVE leaves them: no library."""
    import mandalorion_tpu.native as ref_native
    for mod in (ref_native, port_native):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_TRIED", True)


def _probe_index(kmer, window):
    """The bucketed index of one 20 kb chromosome and its bucket-less
    copy, and the reference's GenomeIndex on the same arrays."""
    idx = port_index.build_index({"chr1": make_genome(20_000, seed=5)},
                                 kmer, window)
    bare = dataclasses.replace(idx, bucket_lo=None)
    return idx, bare, ref_index.GenomeIndex(**vars(bare))


def _queries(idx, rng):
    """Reads cut from the genome (one reverse-complemented, one with
    substitutions), a random read and an empty one, as code arrays."""
    g = idx.seq_codes
    mutated = g[9_000:11_000].copy()
    hit = rng.random(len(mutated)) < 0.03
    mutated[hit] = rng.integers(0, 4, int(hit.sum()))
    return [g[1_000:3_000].copy(), (3 - g[14_000:15_500])[::-1].copy(),
            mutated, rng.integers(0, 4, 800).astype(np.uint8),
            np.zeros(0, np.uint8)]


@pytest.mark.parametrize("kmer, window", [(15, 10), (15, 5), (13, 3)])
def test_lookup_without_bucket_table_matches_reference_and_bucketed(
        kmer, window):
    idx, bare, ref = _probe_index(kmer, window)
    assert idx.bucket_lo is not None
    seeded = 0
    for codes in _queries(idx, np.random.default_rng(kmer + window)):
        _pos, hashes = minimizers(codes, kmer, window)
        got = bare.lookup(hashes, 500)
        for want in (ref.lookup(hashes, 500), idx.lookup(hashes, 500)):
            assert all(a.dtype == b.dtype and np.array_equal(a, b)
                       for a, b in zip(got, want))
        seeded += len(got[0])
    assert seeded > 0


def _segments(out):
    return None if out is None else [
        (c, [dataclasses.astuple(s) for s in segs]) for c, segs in out]


@pytest.mark.parametrize("case", ["bucketed", "bucket-less", "no library"])
def test_seed_segments_answers_as_the_reference(monkeypatch, case):
    """The fused seeding's segments on the bucketed index with the
    library; None, as the reference answers, on the bucket-less index
    and without the library."""
    idx, bare, _ref = _probe_index(15, 10)
    if case == "no library":
        _unload(monkeypatch)
    port = bare if case == "bucket-less" else idx
    ref = ref_index.GenomeIndex(**vars(port))
    segments = 0
    for codes in _queries(idx, np.random.default_rng(1))[:3]:
        got = _segments(port.seed_segments(codes, 500))
        assert got == _segments(ref.seed_segments(codes, 500))
        assert (got is None) == (case != "bucketed")
        segments += sum(len(segs) for _c, segs in got or ())
    assert (segments > 0) == (case == "bucketed")


# ------------------------------------------------------- the aligner

def _records(aligner, reads):
    name, seq = reads[0]
    return ([str(r) for r in aligner.map_batch(reads)],
            [(n, s, q.tolist(), r) for n, s, q, r in
             aligner.map_batch_runs(reads)],
            [str(r) for r in aligner.map_all_targets(name, seq)])


@pytest.mark.parametrize("pair", list(PAIRS), ids="-".join)
def test_aligner_methods_on_bucketless_index(caches, pair):
    """One read of each gene and two more, on the port aligner with its
    index's bucket table dropped: the records of the bucketed index, and
    of the reference aligner on the bucket-less index."""
    d, _inputs, _bucketed, _bare = caches
    genome = fastx_to_dict(os.path.join(d, "genome.fasta"))
    reads = [(nm, sq) for nm, sq, _q in
             read_fastx(os.path.join(d, "reads.fasta"))][::6]
    port = TorchSpliceAligner(genome, AlignConfig(
        chain_backend=pair[0], dp_backend=pair[1]), device="cpu")
    want = _records(port, reads)
    port.index = dataclasses.replace(port.index, bucket_lo=None)
    assert port.numpy_seeding()
    got = _records(port, reads)
    assert got == want
    ref = RefAligner(genome, RefAlignConfig(chain_backend=PAIRS[pair][0],
                                            dp_backend=PAIRS[pair][1]))
    ref.index = ref_index.GenomeIndex(**vars(port.index))
    assert _records(ref, reads) == got
    assert len(got[0]) >= 3 and got[1] and got[2]


# ---------------------------------------------------- the command line

def _artifacts(out_dir):
    blobs = {}
    for name in ARTIFACTS:
        with open(os.path.join(out_dir, name), "rb") as fh:
            blobs[name] = fh.read()
        assert blobs[name], name
    return blobs


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """tests/test_torch_routes.py's dataset (3 genes x 10 reads on 90 kb),
    its directory index cache as the port's host route writes it, and a
    copy of that cache without bucket_lo.npy."""
    d = str(tmp_path_factory.mktemp("bucketless"))
    make_dataset(d, n_genes=3, n_reads_per_gene=10, genome_len=90_000,
                 seed=0)
    inputs = ["-G", os.path.join(d, "genome.fasta"),
              "-g", os.path.join(d, "ann.gtf"),
              "-f", os.path.join(d, "reads.fasta"), "-t", "1"]
    bucketed = os.path.join(d, "genome.idx")
    assert cli.main(["-p", os.path.join(d, "write-cache"), *inputs,
                     "--device", "cpu", "--index_cache", bucketed]) == 0
    bare = os.path.join(d, "bare.idx")
    shutil.copytree(bucketed, bare)
    os.remove(os.path.join(bare, "bucket_lo.npy"))
    assert port_index.load_index(bare).bucket_lo is None
    return d, inputs, bucketed, bare


def _port_run(d, inputs, pair, cache, tag, *flags):
    out = os.path.join(d, f"port-{tag}-" + "-".join(pair))
    assert cli.main(["-p", out, *inputs, "--device", "cpu",
                     "--chain_backend", pair[0], "--dp_backend", pair[1],
                     "--index_cache", cache, *flags]) == 0
    return _artifacts(out)


@pytest.mark.parametrize("pair", list(PAIRS), ids="-".join)
def test_cli_on_bucketless_cache_matches_reference_and_bucketed(caches,
                                                                pair):
    d, inputs, bucketed, bare = caches
    ref_pair = PAIRS[pair]
    ref_out = os.path.join(d, "ref-" + "-".join(pair))
    args = reference_parser().parse_args([
        "-p", ref_out, *inputs, "--chain_backend", ref_pair[0],
        "--dp_backend", ref_pair[1], "--index_cache", bare])
    reference_run(args.path, args.genome_sequence, args.genome_annotation,
                  args.Consensus_reads, reference_config(args))
    got = _port_run(d, inputs, pair, bare, "bare")
    assert got == _artifacts(ref_out)
    assert got == _port_run(d, inputs, pair, bucketed, "bucketed")
    # neither run rewrote the bucket-less cache
    assert not os.path.exists(os.path.join(bare, "bucket_lo.npy"))


def test_sharded_index_backend_on_bucketless_index_raises(caches):
    d, inputs, _bucketed, bare = caches
    with pytest.raises(ValueError, match=r"bucket table \(bucket_lo\)"):
        _port_run(d, inputs, ("native", "device"), bare, "sharded",
                  "--devices", "2", "--index_backend", "sharded")
