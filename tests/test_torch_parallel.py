"""The port's parallel/ (mesh, collectives, sharded index) against
mandalorion_tpu's on the CPU's eight virtual JAX devices (conftest.py),
and the port's dispatches under a mesh against their meshless runs.

Virtual CPU shards stand in for cards (`make_mesh(n, device="cpu")`);
without a process group no collective runs and the shards' results are
concatenated in shard order. Every comparison is exact: integers, bytes.
Cross-process meshes (gloo) are in tests/test_torch_multihost.py.

The `cuda` cases run on the card, where jax is absent:
`python -m pytest --noconftest -m cuda tests/test_torch_parallel.py`;
the JAX package comes from fixtures for that reason.
"""

import os
import socket

import numpy as np
import pytest
import torch

from mandalorion_tpu_torch.align import chain_kernel, kernels
from mandalorion_tpu_torch.align.aligner import (
    TorchSpliceAligner, sharded_seed_hits)
from mandalorion_tpu_torch.align.encode import (
    decode, encode, minimizers, revcomp_codes)
from mandalorion_tpu_torch.config import AlignConfig, PipelineConfig
from mandalorion_tpu_torch.native import native_stage_seed_batch
from mandalorion_tpu_torch.parallel import dist as D
from mandalorion_tpu_torch.parallel import mesh as M
from mandalorion_tpu_torch.pipeline import cli
from mandalorion_tpu_torch.pipeline.stages import run_pipeline
from mandalorion_tpu_torch.poa import kernels as K
from mandalorion_tpu_torch.poa.graph import PoaParams
from mandalorion_tpu_torch.utils.simulate import make_dataset

from test_torch_chain import KW as CHAIN_KW, _pack, _random_candidate
from test_torch_dp import MODES, _descriptors, _random_problems
from test_torch_poa import _chunk_arrays, _rand_sets

ARTIFACTS = ("Isoforms.filtered.fasta", "Isoforms.filtered.clean.psl",
             "Isoforms.filtered.clean.gtf", "Isoforms.filtered.clean.quant",
             "Isoforms.filtered.clean.tpm",
             os.path.join("tmp", "reads2isoforms.txt"))


@pytest.fixture
def jax_parallel():
    from mandalorion_tpu.parallel import dist as jd
    from mandalorion_tpu.parallel import mesh as jm
    return jm, jd


def _cpu_mesh(n):
    return M.make_mesh(n, device="cpu")


# ------------------------------------------------------------ the mesh

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_shapes_match_reference(jax_parallel, n):
    jm, _jd = jax_parallel
    ref = jm.make_mesh(n)
    mesh = _cpu_mesh(n)
    assert mesh.shape == ref.devices.shape
    assert mesh.axis_names == tuple(ref.axis_names)
    assert mesh.size == n and mesh.devices == (torch.device("cpu"),) * n
    assert (mesh.group, mesh.rank, mesh.world) == (None, 0, 1)


def test_make_mesh_never_doubles_a_card():
    """No CUDA card here: asking for CUDA shards raises (on a one-card
    machine make_mesh(2) raises ValueError naming the visible count;
    the `cuda` test below checks that)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        M.make_mesh(2, device="cuda")
    with pytest.raises(ValueError, match="unsupported"):
        M.make_mesh(2, device="meta")


@pytest.mark.parametrize("size", [0, 1, 7, 64, 101])
def test_shard_batch_padding_matches_reference(jax_parallel, size):
    jm, _jd = jax_parallel
    rng = np.random.default_rng(size)
    a = rng.integers(0, 100, (size, 3)).astype(np.int32)
    for n, mult in ((1, 1), (3, 1), (8, 1), (2, 8)):
        (ref,), ref_b = jm.shard_batch(jm.make_mesh(n), [a], mult)
        mesh = _cpu_mesh(n)
        shards, b = M.shard_batch(mesh, [a], mult)
        got = np.concatenate([s[0].numpy() for s in shards])
        assert b == ref_b == size
        np.testing.assert_array_equal(got, np.asarray(ref))
        assert len(shards) == n and len({len(s[0]) for s in shards}) == 1


def test_mesh_from_devices_repeats_a_device():
    mesh = M.Mesh.from_devices(["cpu", "cpu", "cpu"])
    assert mesh.size == 3 and mesh.shape == (3,)
    padded, slices = mesh.shard_slices(7)
    assert padded == 9 and [s[1:] for s in slices] == [(0, 3), (3, 6),
                                                       (6, 9)]


# --------------------------------------------------------- collectives

@pytest.mark.parametrize("n", [1, 2, 8])
def test_mesh_count_matrix_matches_reference(jax_parallel, n):
    jm, jd = jax_parallel
    rng = np.random.default_rng(5)
    mesh = _cpu_mesh(n)
    for size in (0, 1, 7, 64, 101):
        ids = rng.integers(0, 30, size=size)
        got = D.mesh_count_matrix(mesh, ids, 30)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, np.bincount(ids, minlength=30))
        np.testing.assert_array_equal(
            got, jd.mesh_count_matrix(jm.make_mesh(n), ids, 30))


def test_sharded_quant_merge_matches_reference(jax_parallel):
    jm, jd = jax_parallel
    rng = np.random.default_rng(4)
    partials = rng.integers(0, 5, size=(4, 6, 3)).astype(np.int32)
    got = D.sharded_quant_merge(_cpu_mesh(4), partials)
    np.testing.assert_array_equal(got, partials.sum(axis=0))
    np.testing.assert_array_equal(
        got, np.asarray(jd.sharded_quant_merge(jm.make_mesh(4, ("reads",)),
                                               partials)))


@pytest.mark.parametrize("n", [1, 2, 8])
def test_sharded_scores_match_reference(jax_parallel, n):
    import jax.numpy as jnp
    jm, jd = jax_parallel
    rng = np.random.default_rng(3)
    q = rng.integers(0, 4, size=(8 * n + 3, 48)).astype(np.int32)
    t = rng.integers(0, 4, size=(8 * n + 3, 128)).astype(np.int32)
    ref = np.asarray(jd._score_batch(jnp.asarray(q), jnp.asarray(t)))
    local = D._score_batch(torch.from_numpy(q), torch.from_numpy(t))
    np.testing.assert_array_equal(local.numpy(), ref)
    np.testing.assert_array_equal(
        D.sharded_batch_score(_cpu_mesh(n), q, t), ref)
    b = 8 * n
    np.testing.assert_array_equal(
        np.asarray(jd.sharded_batch_score(jm.make_mesh(n, ("reads",)),
                                          jnp.asarray(q[:b]),
                                          jnp.asarray(t[:b]))), ref[:b])


# ------------------------------------------------------- sharded index

@pytest.fixture(scope="module")
def genome_index():
    import synthdata
    from mandalorion_tpu_torch.align.index import build_index
    genome = {"chr1": synthdata.make_genome(60_000, seed=31),
              "chr2": synthdata.make_genome(30_000, seed=32)}
    rng = np.random.default_rng(7)
    s = int(rng.integers(0, 50_000))
    read, _ = synthdata.mutate_read(genome["chr1"][s:s + 2000], rng, 0.05)
    return genome, build_index(genome), read


def _queries(idx, read):
    """A read's minimizer hashes, plus hashes >= 2^63 (one of them in
    the index), the all-ones sentinel and a hash no shard holds."""
    _pos, hashes = minimizers(encode(read), 15, 5)
    high = idx.sorted_hashes[idx.sorted_hashes >= np.uint64(1 << 63)]
    extra = np.array([high[0], high[-1], np.uint64(1 << 63),
                      np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64(12345)],
                     np.uint64)
    return np.concatenate([hashes, extra])


def test_shard_index_arrays_match_reference(jax_parallel, genome_index):
    _jm, jd = jax_parallel
    _genome, idx, _read = genome_index
    for n in (1, 2, 3, 8):
        for got, want in zip(D.shard_index_arrays(idx, n),
                             jd.shard_index_arrays(idx, n)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_index_lookup_matches_reference(jax_parallel, genome_index,
                                                n):
    """pos, valid and cnt equal to the reference's, the reference's
    shard count (its mesh's first axis) on the port's n-shard mesh; the
    port expands to the widest kept count w <= max_occ, and every entry
    of the reference past w is invalid."""
    jm, jd = jax_parallel
    _genome, idx, read = genome_index
    queries = _queries(idx, read)
    max_occ = 8
    ref_mesh = jm.make_mesh(n)
    sh, sp, sl = jd.shard_index_arrays(idx, ref_mesh.devices.shape[0])
    r_pos, r_valid, r_cnt = (np.asarray(a) for a in jd.sharded_index_lookup(
        ref_mesh, sh, sp, sl, queries, max_occ))
    pos, valid, cnt = D.sharded_index_lookup(_cpu_mesh(n), sh, sp, sl,
                                             queries, max_occ)
    w = pos.shape[2]
    assert 1 <= w <= max_occ and valid.dtype == bool
    assert pos.shape[:2] == r_pos.shape[:2]
    np.testing.assert_array_equal(pos, r_pos[:, :, :w])
    np.testing.assert_array_equal(valid, r_valid[:, :, :w])
    assert not r_valid[:, :, w:].any()
    np.testing.assert_array_equal(cnt, r_cnt)
    # through the refinement: GenomeIndex.lookup's anchors
    shards = D.place_index_shards(_cpu_mesh(n), sh, sp, sl)
    for got, want in zip(sharded_seed_hits(shards, queries,
                                           [0, len(queries)], max_occ),
                         idx.lookup(queries, max_occ)):
        np.testing.assert_array_equal(got, want)


def test_sharded_seed_hits_budget_cut_per_orientation(genome_index,
                                                      monkeypatch):
    """With a small anchor budget the cut drops repeats per orientation,
    exactly as GenomeIndex.lookup does for each alone."""
    from mandalorion_tpu_torch.align import aligner, index
    _genome, idx, read = genome_index
    monkeypatch.setattr(index, "ANCHOR_BUDGET", 40)
    monkeypatch.setattr(aligner, "ANCHOR_BUDGET", 40)
    hashes = [minimizers(encode(r), 15, 5)[1]
              for r in (read, read[:700], "", read[500:1500])]
    q_off = np.cumsum([0] + [len(h) for h in hashes])
    mesh = _cpu_mesh(3)
    shards = D.place_index_shards(mesh, *D.shard_index_arrays(idx, 3))
    qidx, gpos = sharded_seed_hits(shards, np.concatenate(hashes), q_off, 8)
    for o, h in enumerate(hashes):
        sel = (qidx >= q_off[o]) & (qidx < q_off[o + 1])
        want_q, want_g = idx.lookup(h, 8)
        np.testing.assert_array_equal(qidx[sel] - q_off[o], want_q)
        np.testing.assert_array_equal(gpos[sel], want_g)


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_seed_stage_matches_native(genome_index, n):
    """The seed stage through the sharded index gives the tuple of
    native_stage_seed_batch on the same reads."""
    import synthdata
    genome, _idx, _read = genome_index
    rng = np.random.default_rng(11)
    reads = []
    for k in range(12):
        chrom = "chr1" if k % 3 else "chr2"
        s = int(rng.integers(0, len(genome[chrom]) - 1600))
        r, _ = synthdata.mutate_read(genome[chrom][s:s + 1500], rng, 0.04)
        # every other read from the minus strand
        reads.append((f"r{k}", r if k % 2 else
                      decode(revcomp_codes(encode(r)))))
    reads.append(("short", "ACGT"))
    cfg = AlignConfig(index_backend="sharded")
    with M.use_mesh(_cpu_mesh(n)):
        aligner = TorchSpliceAligner(genome, cfg, device="cpu")
        assert aligner._sharded is not None
        codes_all, read_off, got = aligner.seed_batch(reads)
    want = native_stage_seed_batch(codes_all, read_off, cfg.kmer,
                                   cfg.window, aligner.max_occ, 100,
                                   aligner.index, cfg.max_intron)
    assert got[0] == want[0] >= len(reads) - 1  # "short" seeds nothing
    n_cand = got[0]
    for g, w in zip(got[1:6], want[1:6]):
        np.testing.assert_array_equal(g[:n_cand], w[:n_cand])
    for g, w in zip(got[6], want[6]):
        np.testing.assert_array_equal(g[:n_cand], w[:n_cand])
    plain = TorchSpliceAligner.from_aligner(aligner, device="cpu")
    assert plain._sharded is None  # no mesh: the replicated index


# --------------------------------------------- dispatches under a mesh

@pytest.mark.parametrize("n", [2, 3])
def test_chain_rows_under_mesh_match_meshless(n):
    rng = np.random.default_rng(60 + n)
    cands = [_random_candidate(rng, 40) for _ in range(7)] + [[]]
    segs, n_seg = _pack(cands)
    for b in (1, 2, n + 1, len(cands)):
        want = chain_kernel.chain_batch_rows(
            *segs, n_seg, b, device=torch.device("cpu"), **CHAIN_KW)
        with M.use_mesh(_cpu_mesh(n)):
            got = chain_kernel.chain_batch_rows(
                *segs, n_seg, b, device=torch.device("cpu"), **CHAIN_KW)
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2, 3])
def test_solve_dp_fused_under_mesh_matches_meshless(n):
    cfg = AlignConfig(end_bonus=12, zdrop=25)
    rng = np.random.default_rng(70 + n)
    problems = []
    for mode in MODES:
        problems += _random_problems(rng, 4, mode, max_len=60)
    problems += _random_problems(rng, 1, "global", max_len=2600)
    for b in (1, 2, len(problems)):
        probs, oriented, read_off, genome = _descriptors(problems[-b:])
        want = kernels.solve_dp_fused(probs, oriented, read_off,
                                      torch.from_numpy(genome), cfg)
        with M.use_mesh(_cpu_mesh(n)):
            got = kernels.solve_dp_fused(
                probs, oriented, read_off,
                {torch.device("cpu"): torch.from_numpy(genome)}, cfg)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("walk", ["steps", "sweep"])
@pytest.mark.parametrize("n", [2, 3])
def test_dispatch_chunk_under_mesh_matches_meshless(n, walk):
    """Both walks; a chunk of one problem on n shards (all but one of
    them padding) and a chunk of three. buf/recs are compared up to each
    problem's count (entries past it are unspecified)."""
    params = PoaParams(band=20, adaptive=True)
    arrays, W, l_cap = _chunk_arrays(_rand_sets(42), params, 2)
    for b in (1, 3):
        part = [a[:b] for a in arrays]
        args = (*part, W, l_cap, params, torch.device("cpu"))
        want_rows, want_counts = K.dispatch_chunk(*args, walk=walk)
        with M.use_mesh(_cpu_mesh(n)):
            rows, counts = K.dispatch_chunk(*args, walk=walk)
        np.testing.assert_array_equal(counts, want_counts)
        assert rows.shape == want_rows.shape
        for k, c in enumerate(counts.tolist()):
            np.testing.assert_array_equal(rows[k, :c], want_rows[k, :c])


# ------------------------------------------------------- whole pipeline

@pytest.fixture(scope="module")
def pipeline_data(tmp_path_factory):
    """A small simulated run and the reference's meshless artifacts."""
    from mandalorion_tpu.config import PipelineConfig as ReferenceConfig
    from mandalorion_tpu.pipeline.stages import run_pipeline as reference
    tmp = tmp_path_factory.mktemp("mesh_run")
    make_dataset(str(tmp), n_genes=3, n_reads_per_gene=12,
                 genome_len=90_000, seed=2)
    inputs = [str(tmp / f) for f in ("genome.fasta", "ann.gtf",
                                     "reads.fasta")]
    reference(str(tmp / "ref"), *inputs, ReferenceConfig(threads=1))
    return tmp, inputs, _artifacts(tmp / "ref")


def _artifacts(out_dir):
    blobs = {}
    for name in ARTIFACTS:
        with open(os.path.join(out_dir, name), "rb") as fh:
            blobs[name] = fh.read()
        assert blobs[name], name
    return blobs


@pytest.mark.parametrize("index_backend", ["replicated", "sharded"])
def test_pipeline_under_mesh_matches_reference(pipeline_data,
                                               index_backend):
    tmp, inputs, ref = pipeline_data
    cfg = PipelineConfig(threads=1,
                         align=AlignConfig(index_backend=index_backend))
    out = tmp / f"mesh_{index_backend}"
    M.COLLECTIVES.count = 0
    with M.use_mesh(_cpu_mesh(2)):
        run_pipeline(str(out), *inputs, cfg, device="cpu")
    assert M.COLLECTIVES.count == 0  # no group: shards concatenated here
    assert _artifacts(out) == ref


def test_cli_devices_and_sharded_index_match_reference(pipeline_data):
    tmp, (genome, ann, reads), ref = pipeline_data
    assert cli.main(["-p", str(tmp / "cli4"), "-G", genome, "-g", ann,
                     "-f", reads, "-t", "1", "--device", "cpu",
                     "--devices", "4", "--index_backend", "sharded"]) == 0
    assert M.pipeline_mesh() is None
    assert _artifacts(tmp / "cli4") == ref


def test_host_route_refuses_a_sharded_index_under_a_mesh(pipeline_data):
    tmp, inputs, _ref = pipeline_data
    cfg = PipelineConfig(threads=1, align=AlignConfig(
        chain_backend="native", dp_backend="numpy", index_backend="sharded"))
    with M.use_mesh(_cpu_mesh(2)), pytest.raises(ValueError,
                                                 match="device route"):
        run_pipeline(str(tmp / "host_sharded"), *inputs, cfg, device="cpu")


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
def test_cuda_one_rank_nccl_count_matrix(cuda_device):
    """A one-rank NCCL group: mesh_count_matrix (bincount on the card,
    all_reduce) equals np.bincount; make_mesh(more cards than visible)
    raises."""
    import torch.distributed as dist
    M.multihost_init(f"127.0.0.1:{_free_port()}", 1, 0, timeout_s=60,
                     device="cuda")
    try:
        mesh = M.make_mesh(1)
        assert mesh.group is not None and mesh.comm_device().type == "cuda"
        rng = np.random.default_rng(8)
        before = M.COLLECTIVES.count
        for size in (1, 7, 101, 100_000):
            ids = rng.integers(0, 300, size=size)
            np.testing.assert_array_equal(
                D.mesh_count_matrix(mesh, ids, 300),
                np.bincount(ids, minlength=300))
        assert M.COLLECTIVES.count == before + 4
        with pytest.raises(ValueError, match="visible"):
            M.make_mesh(torch.cuda.device_count() + 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["chain", "dp", "steps", "sweep"])
def test_cuda_dispatches_on_two_shards_of_one_card(cuda_device, what):
    """The padding edge on the card: two shards on one card, batches of
    1, 3 and 2k + 1 problems (the second shard mostly or all padding),
    equal to the meshless dispatch on the card."""
    mesh = M.Mesh.from_devices([cuda_device, cuda_device])
    rng = np.random.default_rng(90)
    if what == "chain":
        cands = [_random_candidate(rng, 300) for _ in range(9)]
        segs, n_seg = _pack(cands)

        def run(b):
            return (chain_kernel.chain_batch_rows(
                *segs, n_seg, b, device=cuda_device, **CHAIN_KW),)
    elif what == "dp":
        problems = []
        for mode in MODES:
            problems += _random_problems(rng, 3, mode, max_len=300)
        cfg = AlignConfig(end_bonus=12, zdrop=30)

        def run(b):
            probs, oriented, read_off, genome = _descriptors(problems[:b])
            return kernels.solve_dp_fused(
                probs, oriented, read_off,
                torch.from_numpy(genome).to(cuda_device), cfg)
    else:
        params = PoaParams(band=20, adaptive=True)
        arrays, W, l_cap = _chunk_arrays(_rand_sets(42, n_sets=9), params, 2)

        def run(b):
            rows, counts = K.dispatch_chunk(
                *[a[:b] for a in arrays], W, l_cap, params, cuda_device,
                walk=what)
            return counts, [rows[k, :c] for k, c in enumerate(counts)]
    for b in (1, 3, 9):
        want = run(b)
        with M.use_mesh(mesh):
            got = run(b)
        for g, w in zip(got, want):
            if isinstance(w, list):
                for gg, ww in zip(g, w):
                    np.testing.assert_array_equal(gg, ww)
            else:
                np.testing.assert_array_equal(g, w)
