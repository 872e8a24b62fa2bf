"""The port's own host layers against the JAX package's.

The port keeps its own copy of the host layers and builds its own native
library. Here the port's host route (native C++ chain and DP in forked
workers, native consensus) must give byte-identical artifacts to the JAX
package's default run, and the two native libraries equal outputs."""

import os

import numpy as np
import pytest

import mandalorion_tpu.native as ref_native
import mandalorion_tpu_torch.native as port_native
from mandalorion_tpu.align.encode import encode
from mandalorion_tpu.align.index import build_index as ref_build_index
from mandalorion_tpu.config import PipelineConfig as ReferenceConfig
from mandalorion_tpu.pipeline.stages import run_pipeline as reference_run
from mandalorion_tpu.poa.graph import PoaParams as RefPoaParams
from mandalorion_tpu.utils.simulate import make_dataset
from mandalorion_tpu_torch.align.index import build_index as port_build_index
from mandalorion_tpu_torch.config import AlignConfig, PipelineConfig
from mandalorion_tpu_torch.core import cleanpsl
from mandalorion_tpu_torch.io.fastx import fastx_to_dict, read_fastx
from mandalorion_tpu_torch.pipeline import cli, stages
from mandalorion_tpu_torch.poa.graph import PoaParams

pytestmark = pytest.mark.skipif(ref_native.load_native() is None,
                                reason="reference native library "
                                       "unavailable")

ARTIFACTS = ("Isoforms.filtered.fasta", "Isoforms.filtered.clean.psl",
             "Isoforms.filtered.clean.gtf", "Isoforms.filtered.clean.quant",
             "Isoforms.filtered.clean.tpm",
             os.path.join("tmp", "reads2isoforms.txt"))
HOST_ROUTE = dict(chain_backend="native", dp_backend="numpy")


def _artifacts(out_dir):
    blobs = {}
    for name in ARTIFACTS:
        with open(os.path.join(out_dir, name), "rb") as fh:
            blobs[name] = fh.read()
        assert blobs[name], name
    return blobs


@pytest.fixture
def dataset(tmp_path):
    make_dataset(str(tmp_path), n_genes=3, n_reads_per_gene=20,
                 genome_len=90_000, seed=0)
    return [os.path.join(tmp_path, f) for f in
            ("genome.fasta", "ann.gtf", "reads.fasta")]


def test_the_two_libraries_are_separate_builds():
    ref, port = ref_native.load_native(), port_native.load_native()
    assert ref is not port and ref._name != port._name
    assert os.path.dirname(port._name) == os.path.join(
        os.path.dirname(port_native.__file__), "_build")


@pytest.mark.parametrize("threads", [1, 2])
def test_host_route_matches_reference(tmp_path, dataset, threads):
    reference_run(str(tmp_path / "ref"), *dataset,
                  ReferenceConfig(threads=threads))
    cfg = PipelineConfig(threads=threads, align=AlignConfig(**HOST_ROUTE))
    stages.run_pipeline(str(tmp_path / "port"), *dataset, cfg)
    assert _artifacts(tmp_path / "port") == _artifacts(tmp_path / "ref")


def test_host_route_cli_never_resolves_a_device(tmp_path, dataset,
                                                monkeypatch):
    """The host route's command line runs without touching the device
    argument (the default, cuda, would raise here)."""
    def refuse(device):
        raise AssertionError(f"resolve_device({device!r}) on the host route")

    monkeypatch.setattr(stages, "resolve_device", refuse)
    genome, ann, reads = dataset
    reference_run(str(tmp_path / "ref"), *dataset, ReferenceConfig(threads=2))
    assert cli.main(["-p", str(tmp_path / "port"), "-G", genome, "-g", ann,
                     "-f", reads, "-t", "2", "--chain_backend", "native",
                     "--dp_backend", "numpy"]) == 0
    assert _artifacts(tmp_path / "port") == _artifacts(tmp_path / "ref")


@pytest.mark.parametrize("chain,dp,route", [
    ("device", "device", "device"),
    ("device", "rowscan", "device-chain/rowscan-dp"),
    ("device", "numpy", "device-chain/host-dp"),
    ("native", "device", "host-chain/device-dp"),
    ("native", "rowscan", "host-chain/rowscan-dp"),
    ("native", "numpy", "host"),
    ("native", "bogus", None),
    ("bogus", "device", None)])
def test_align_route_of_every_pair(chain, dp, route):
    """Every pair of the reference's chain x dp backends has a route (the
    port's 'device' DP is the reference's 'pallas'); only the pair
    ('native', 'numpy') is the host route. A name neither package knows
    raises."""
    cfg = AlignConfig(chain_backend=chain, dp_backend=dp)
    if route is None:
        with pytest.raises(ValueError, match="bogus"):
            stages.align_route(cfg)
    else:
        assert stages.align_route(cfg) == route


def test_cli_takes_every_pair():
    from mandalorion_tpu_torch.config import config_from_args
    parser = cli.build_parser()
    for chain in ("device", "native"):
        for dp in ("device", "rowscan", "numpy"):
            cfg = config_from_args(parser.parse_args(
                ["--chain_backend", chain, "--dp_backend", dp]))
            assert (cfg.align.chain_backend, cfg.align.dp_backend) == \
                (chain, dp)
    assert stages.align_route(config_from_args(
        parser.parse_args([])).align) == "device"
    with pytest.raises(SystemExit):
        parser.parse_args(["--dp_backend", "pallas"])


def test_build_index_arrays_equal(dataset):
    genome = fastx_to_dict(dataset[0])
    ref, port = ref_build_index(genome), port_build_index(genome)
    for name in ("seq_codes", "chrom_offsets", "chrom_sizes",
                 "sorted_hashes", "sorted_positions", "bucket_lo"):
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (ref.chrom_names, ref.bucket_bits, ref.kmer, ref.window) == \
        (port.chrom_names, port.bucket_bits, port.kmer, port.window)


def test_native_poa_consensus_equal():
    rng = np.random.default_rng(3)
    for _ in range(3):
        true = rng.integers(0, 4, int(rng.integers(150, 500))).astype(
            np.uint8)
        reads = []
        for _k in range(6):
            r = true.copy()
            hit = rng.random(len(r)) < 0.05
            r[hit] = rng.integers(0, 4, int(hit.sum()))
            cut = int(rng.integers(10, len(r) - 10))
            reads.append(np.concatenate([r[:cut], r[cut + 2:]]))
        for adaptive in (True, False):
            want = ref_native.native_poa_consensus(
                reads, RefPoaParams(band=24, adaptive=adaptive))
            got = port_native.native_poa_consensus(
                reads, PoaParams(band=24, adaptive=adaptive))
            assert got.tolist() == want.tolist()


def test_native_stages_equal_on_one_batch(dataset):
    """Seed, fill and emit stages of both libraries on one seeded batch,
    with the port's plain chain DP and affine DP between them."""
    import torch
    from mandalorion_tpu_torch.align.chain_kernel import chain_batch_rows
    from mandalorion_tpu_torch.align.kernels import solve_dp_fused
    cfg = AlignConfig()
    index = port_build_index(fastx_to_dict(dataset[0]))
    reads = [sq for _nm, sq, _q in read_fastx(dataset[2])][:30]
    codes = [encode(sq) for sq in reads]
    read_off = np.zeros(len(codes) + 1, np.int64)
    np.cumsum([len(c) for c in codes], out=read_off[1:])
    codes_all = np.concatenate(codes)
    genome_t = torch.from_numpy(index.seq_codes)

    def flat(x):
        if isinstance(x, (tuple, list)):
            return [y for item in x for y in flat(item)]
        return [np.asarray(x)]

    def same(a, b, what, n=None):
        fa, fb = flat(a), flat(b)
        assert len(fa) == len(fb), what
        for x, y in zip(fa, fb):
            if n is not None and x.ndim:
                x, y = x[:n], y[:n]
            assert np.array_equal(x, y), what

    seeded = [lib.native_stage_seed_batch(
        codes_all, read_off, cfg.kmer, cfg.window, cfg.max_occ, 100, index,
        cfg.max_intron) for lib in (ref_native, port_native)]
    n_cand = seeded[0][0]
    assert n_cand == seeded[1][0] and n_cand > 0
    same(seeded[0][1:], seeded[1][1:], "seed stage", n=n_cand)
    _n, c_read, c_strand, c_chrom, c_tbase, c_nseg, segs = seeded[1]
    rows = chain_batch_rows(*segs, c_nseg, n_cand, min_intron=cfg.min_intron,
                            max_intron=cfg.max_intron, device="cpu")
    filled = [lib.native_stage_fill_batch(
        codes_all, read_off, n_cand, c_read, c_strand, c_chrom, c_tbase,
        c_nseg, segs, rows, index, float(cfg.min_chain_score),
        cfg.min_intron, cfg.match, cfg.mismatch, cfg.gap_open,
        cfg.gap_extend, cfg.end_bonus, cfg.zdrop, cfg.band_width,
        cfg.max_end_extend, cfg.splice_slack, cfg.noncanonical_penalty)
        for lib in (ref_native, port_native)]
    same(filled[0], filled[1], "fill stage")
    strand, _chrom, oriented, run_off, runs, probs = filled[1]
    meta, ks, buf, on_host = solve_dp_fused(probs, oriented, read_off,
                                            genome_t, cfg)
    emitted = [lib.native_stage_emit_batch(
        oriented, read_off, index.seq_codes, strand, run_off, runs, probs,
        on_host, meta, ks, buf, cfg.match, cfg.mismatch, cfg.gap_open,
        cfg.gap_extend, cfg.end_bonus, cfg.zdrop)
        for lib in (ref_native, port_native)]
    stats, blk_off, bs, bq, bt, cs_off, cs_raw = emitted[1]
    r_stats, r_blk_off, r_bs, r_bq, r_bt, r_cs_off, r_cs_raw = emitted[0]
    assert stats[:, 7].sum() > 0
    same((stats, blk_off, cs_off), (r_stats, r_blk_off, r_cs_off), "emit")
    nb, nc = int(blk_off[-1]), int(cs_off[-1])
    same((bs[:nb], bq[:nb], bt[:nb]), (r_bs[:nb], r_bq[:nb], r_bt[:nb]),
         "emit blocks")
    assert cs_raw[:nc] == r_cs_raw[:nc]


def _shm_segments():
    """This process's own segments: other runs on the machine share the
    `mando_` prefix."""
    return {f for f in os.listdir("/dev/shm")
            if f.startswith(f"mando_{os.getpid()}_")}


def test_failed_parse_worker_leaves_no_shared_memory(tmp_path):
    """A worker that fails makes pool.map raise; the segments that the
    other workers created must still be unlinked."""
    lines = []
    for k in range(400):
        lines.append("\t".join(
            ["100", "0", "0", "0", "0", "0", "0", "0", "+", f"read{k}",
             "100", "0", "100", "chr1", "5000", str(10 * k),
             str(10 * k + 100), "1", "100,", "0,", f"{10 * k},"]))
    lines[390] = "not a psl line"
    psl = tmp_path / "in.psl"
    psl.write_text("\n".join(lines) + "\n")
    before = _shm_segments()
    with pytest.raises(Exception):
        cleanpsl.clean_sort_split_parallel(
            str(psl), str(tmp_path / "clean.psl"),
            str(tmp_path / "sorted.psl"), str(tmp_path / "ss"), threads=2)
    assert _shm_segments() == before
    # and the same input without the bad line goes through
    lines[390] = lines[389].replace("read389", "read390")
    psl.write_text("\n".join(lines) + "\n")
    cleanpsl.clean_sort_split_parallel(
        str(psl), str(tmp_path / "clean.psl"), str(tmp_path / "sorted.psl"),
        str(tmp_path / "ss"), threads=2)
    assert _shm_segments() == before
    assert os.path.getsize(tmp_path / "sorted.psl") > 0


def _noisy_reads(seed, n=6, length=400, err=0.02):
    rng = np.random.default_rng(seed)
    true = "".join("ACGT"[int(x)] for x in rng.integers(0, 4, length))
    reads = []
    for _ in range(n):
        r = list(true)
        for p in np.flatnonzero(rng.random(length) < err):
            r[int(p)] = "ACGT"[int(rng.integers(0, 4))]
        reads.append("".join(r))
    return reads


@pytest.mark.parametrize("seed", [1, 2])
def test_star_consensus_equal(seed):
    from mandalorion_tpu.poa.star import star_consensus as ref_star
    from mandalorion_tpu_torch.poa.star import star_consensus as port_star
    reads = _noisy_reads(seed)
    assert port_star(reads) == ref_star(reads) != ""


def test_host_aligner_methods_equal(dataset):
    """map_batch, map_batch_runs and map_all_targets of the two host
    aligners on the same reads."""
    from mandalorion_tpu.align.aligner import SpliceAligner as RefAligner
    from mandalorion_tpu.config import AlignConfig as RefAlignConfig
    from mandalorion_tpu_torch.align.aligner import SpliceAligner
    genome = fastx_to_dict(dataset[0])
    reads = [(nm, sq) for nm, sq, _q in read_fastx(dataset[2])][:12]
    ref = RefAligner(genome, RefAlignConfig())
    port = SpliceAligner(genome, AlignConfig(**HOST_ROUTE))
    assert [str(r) for r in port.map_batch(reads)] == \
        [str(r) for r in ref.map_batch(reads)]
    got, want = port.map_batch_runs(reads), ref.map_batch_runs(reads)
    assert len(got) == len(want) > 0
    for (gn, gs, gq, gr), (wn, ws, wq, wr) in zip(got, want):
        assert (gn, gs, gr) == (wn, ws, wr) and np.array_equal(gq, wq)
    name, seq = reads[0]
    assert [str(r) for r in port.map_all_targets(name, seq)] == \
        [str(r) for r in ref.map_all_targets(name, seq)] != []


def test_utils_cli_is_the_ports_own(capsys):
    """The satellite command line answers under the port's script name."""
    from mandalorion_tpu_torch.pipeline import utils_cli
    with pytest.raises(SystemExit):
        utils_cli.main(["--help"])
    assert "mando-tpu-torch-utils" in capsys.readouterr().out
