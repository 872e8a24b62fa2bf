"""The port's record walk (`poa_sweep`) against the JAX package's Pallas
reverse-sweep walk and against both step walks.

The same rank-space arrays (numpy, from seeded read sets: graphs of
200-260 bases, 4 reads, bands 16-18) go through mandalorion_tpu's Pallas
forward and sweep walk in interpret mode and through the port's plain
PyTorch versions on the CPU. Integers throughout: every comparison is
exact equality, on counts and on recs[b, :counts[b]] (entries beyond are
unspecified). Reference-side queries stay below 32768 bases (its 16-bit
origin decode is signed).

The `cuda` cases hold the CUDA kernel against its plain version on the
card (run them with --noconftest where jax is not installed; the
reference imports are inside the CPU tests for that reason).
"""

import os

import numpy as np
import pytest
import torch

from mandalorion_tpu_torch.native import native_poa_consensus
from mandalorion_tpu_torch.poa import kernels as K
from mandalorion_tpu_torch.poa.graph import NEG, PoaParams
from test_torch_poa import (LONG_BAND, _chunk_arrays, _long_insertion_set,
                            _mutate, _port_mats, _scoring)

PAD_TO = 8                      # the Pallas kernels take tiles of 8 problems


def _random_sets(seed, n_sets=3, length=220, err=0.06):
    rng = np.random.default_rng(seed)
    sets = []
    for _ in range(n_sets):
        true = rng.integers(0, 4, length).astype(np.uint8)
        sets.append([_mutate(rng, true, err) for _ in range(4)])
    return sets


def _indel_heavy_sets(seed, n_sets=2, length=260):
    """Four indels a read, deletions of 1-5 and insertions of 5 bases:
    multi-column insertion runs and the boundary row's run."""
    rng = np.random.default_rng(seed)
    sets = []
    for _ in range(n_sets):
        true = rng.integers(0, 4, length).astype(np.uint8)
        reads = []
        for _ in range(4):
            r = true
            for _k in range(4):
                p = int(rng.integers(10, len(r) - 10))
                if rng.random() < 0.5:
                    r = np.concatenate([r[:p],
                                        r[p + int(rng.integers(1, 6)):]])
                else:
                    ins = rng.integers(0, 4, 5).astype(np.uint8)
                    r = np.concatenate([r[:p], ins, r[p:]])
            reads.append(r)
        sets.append(reads)
    return sets


def _padded(arrays, to=PAD_TO):
    """The chunk with inert problems (no nodes, no query) appended."""
    base, preds, nn, ends, qq, ql, band = arrays
    pad = to - len(nn)

    def more(a, fill=0):
        return np.concatenate([a, np.full((pad,) + a.shape[1:], fill,
                                          a.dtype)])

    return (more(base), more(preds, -1), more(nn), more(ends), more(qq),
            more(ql), more(band, band[0]))


def _sweep_and_steps(arrays, params, W, l_cap, device="cpu"):
    mats, (nn, ends, ql) = _port_mats(arrays, params, W, device)
    recs, counts = K.poa_sweep(nn, ends, ql, mats)
    buf, ks = K.poa_walk(nn, ends, ql, mats, l_cap)
    return (mats, recs.cpu().numpy(), counts.cpu().numpy(),
            buf.cpu().numpy(), ks.cpu().numpy())


def _assert_expands_to(recs, counts, buf, ks):
    for b in range(len(ks)):
        got = K.expand_walk_records(recs[b], int(counts[b]))
        assert np.array_equal(got, buf[b, :ks[b]]), b


# --------------------------------------------- against the Pallas sweep

@pytest.mark.parametrize("make,seed,band", [(_random_sets, 11, 18),
                                            (_indel_heavy_sets, 3, 16)])
def test_sweep_plain_matches_pallas_sweep(make, seed, band):
    """Record for record; the reference holds problem b's records in
    columns 16b, 16b + 1 of a (maxrec, B * 16) array."""
    from mandalorion_tpu.poa.kernels import _traceback_from_mats_batch
    from mandalorion_tpu.poa.pallas_kernel import (poa_forward_pallas,
                                                   poa_walk_pallas)
    params = PoaParams(band=band, adaptive=True)
    sets = make(seed)
    arrays, W, l_cap = _chunk_arrays(sets, params, 3)
    arrays = _padded(arrays)
    base, preds, nn, ends, qq, ql, _band = arrays
    _mats, recs, counts, buf, ks = _sweep_and_steps(arrays, params, W, l_cap)

    ref_mats = poa_forward_pallas(base, preds, nn, qq, ql, int(nn.max()),
                                  *_scoring(params), params.band, W,
                                  interpret=True)
    want, want_counts = poa_walk_pallas(ref_mats, nn, ends, ql,
                                        int(nn.max()), interpret=True)
    want, want_counts = np.asarray(want), np.asarray(want_counts)
    assert recs.shape == (PAD_TO, want.shape[0], 2)
    assert np.array_equal(counts, want_counts)
    assert counts[:len(sets)].min() > 0
    assert not counts[len(sets):].any()          # padding problems
    for b, k in enumerate(counts):
        assert np.array_equal(recs[b, :k], want[:k, 16 * b:16 * b + 2]), b
    assert (recs[:, :, 0] >> 16 == K.REC_INS).any()

    # expanded, the records are both step walks' steps
    _assert_expands_to(recs, counts, buf, ks)
    ref_buf, ref_ks = _traceback_from_mats_batch(
        preds, nn, ends, ql, *ref_mats, params.gap_open, params.gap_extend,
        params.gap_open2, params.gap_extend2, W, l_cap)
    _assert_expands_to(recs, counts, np.asarray(ref_buf), np.asarray(ref_ks))


@pytest.mark.parametrize("make,seed", [(_random_sets, 12),
                                       (_indel_heavy_sets, 4)])
def test_expand_matches_the_reference_expander(make, seed):
    from mandalorion_tpu.poa.pallas_kernel import (
        expand_walk_records as reference_expand)
    params = PoaParams(band=18, adaptive=True)
    arrays, W, l_cap = _chunk_arrays(make(seed), params, 2)
    _mats, recs, counts, _buf, _ks = _sweep_and_steps(arrays, params, W,
                                                      l_cap)
    for b, k in enumerate(counts):
        assert np.array_equal(K.expand_walk_records(recs[b], int(k)),
                              reference_expand(recs[b], int(k))), b
    assert K.expand_walk_records(recs[0], 0).shape == (0, 2)


# ------------------------------------- against the port's own step walk

@pytest.mark.parametrize("make,seed", [(_random_sets, 13),
                                       (_indel_heavy_sets, 5)])
def test_sweep_static_band_matches_step_walk(make, seed):
    """The reference reaches its sweep only behind the adaptive band."""
    params = PoaParams(band=12, adaptive=False)
    arrays, W, l_cap = _chunk_arrays(make(seed), params, 2)
    _mats, recs, counts, buf, ks = _sweep_and_steps(arrays, params, W, l_cap)
    assert counts.min() > 0
    _assert_expands_to(recs, counts, buf, ks)


def test_sweep_long_back_edge_matches_step_walk():
    """A predecessor more than 256 rows back: outside the reference's
    Pallas route altogether."""
    params = PoaParams(band=LONG_BAND, adaptive=True)
    arrays, W, l_cap = _chunk_arrays([_long_insertion_set(21)], params, 3)
    assert K.max_back_distance(arrays[1][0], int(arrays[2][0])) > 256
    _mats, recs, counts, buf, ks = _sweep_and_steps(arrays, params, W, l_cap)
    _assert_expands_to(recs, counts, buf, ks)
    # round 1 threads the read that carries the 320-base insertion: one
    # record for the whole run
    arrays, W, l_cap = _chunk_arrays([_long_insertion_set(21)], params, 1)
    _mats, recs, counts, buf, ks = _sweep_and_steps(arrays, params, W, l_cap)
    _assert_expands_to(recs, counts, buf, ks)
    live = recs[0, :int(counts[0])]
    runs = live[live[:, 0] >> 16 == K.REC_INS]
    assert ((runs[:, 0] & 0xFFFF) - (runs[:, 1] & 0xFFFF)).max() >= 300
    assert int(counts[0]) < int(ks[0]) - 300


def _tier2_problem():
    """Two hand-made matrix rows whose window starts near column 40,000:
    the end cell is a tier-2 insertion with origin 39,990 >= 32768, then a
    diagonal into row 0, then row 0's run down to column 0."""
    W, n_cap = 256, 64
    off, qlen, origin = 39_900, 40_000, 39_990
    hpack = np.zeros((1, n_cap + 1, W), np.int32)
    opack = np.zeros_like(hpack)
    d1p, d2p = np.zeros_like(hpack), np.zeros_like(hpack)
    offs = np.zeros((1, n_cap + 1), np.int32)
    endcol = np.full((1, n_cap + 1), NEG, np.int32)
    hpack[0, 0] = 1
    offs[0, 1] = off
    hpack[0, 1, qlen - off] = 3 | (0 << 3) | ((0 + 2) << 6)
    opack[0, 1, qlen - off] = np.uint32(origin << 16).astype(np.int32)
    hpack[0, 1, origin - off] = 0 | (0 << 3) | ((0 + 2) << 6)
    endcol[0, 1] = 5
    mats = tuple(torch.from_numpy(m) for m in
                 (hpack, opack, d1p, d2p, offs, endcol))
    ends = torch.zeros((1, n_cap), dtype=torch.uint8)
    ends[0, 0] = 1
    nn = torch.tensor([1], dtype=torch.int32)
    ql = torch.tensor([qlen], dtype=torch.int32)
    want = [((qlen - 1) | K.REC_INS << 16, origin | 1 << 16),
            ((origin - 1) | K.REC_DIAG << 16, 0 | (0 + 2) << 16),
            ((origin - 2) | K.REC_INS << 16, 0 | 1 << 16)]
    return (nn, ends, ql, mats), np.array(want, np.int32)


def test_sweep_decodes_tier2_origins_as_unsigned():
    (nn, ends, ql, mats), want = _tier2_problem()
    recs, counts = K.poa_sweep_plain(nn, ends, ql, mats)
    assert int(counts[0]) == 3
    assert np.array_equal(recs[0, :3].numpy(), want)
    # expanded: every query base once, from the last to the first, the
    # one at column origin - 1 on the diagonal into rank 0
    steps = K.expand_walk_records(recs[0].numpy(), 3)
    qlen = int(ql[0])
    assert np.array_equal(steps[:, 0], np.arange(qlen - 1, -1, -1))
    on_node = np.flatnonzero(steps[:, 1] >= 0)
    assert on_node.tolist() == [qlen - (want[1, 0] & 0xFFFF) - 1]
    assert steps[on_node[0], 1] == 0 and (np.delete(steps[:, 1],
                                                    on_node) == -1).all()


def test_sweep_rejects_bad_arguments(monkeypatch):
    params = PoaParams(band=16, adaptive=True)
    arrays, W, _l = _chunk_arrays(_random_sets(1, n_sets=1), params, 1)
    mats, (nn, ends, ql) = _port_mats(arrays, params, W)
    with pytest.raises(ValueError, match="int32"):
        K.poa_sweep(nn.long(), ends, ql, mats)
    with pytest.raises(ValueError, match="shape"):
        K.poa_sweep(nn, ends[:, :-1].contiguous(), ql, mats)
    monkeypatch.setattr(K, "SWEEP_RANK_LIMIT", mats[0].shape[1] + 1)
    with pytest.raises(ValueError, match="rank field"):
        K.poa_sweep(nn, ends, ql, mats)


# ---------------------------------------------------------- the route

def test_consensus_sweep_matches_every_engine(monkeypatch):
    from mandalorion_tpu.poa.graph import PoaParams as RefParams
    from mandalorion_tpu.poa.kernels import (
        poa_consensus_batch as reference_batch)
    sets = _random_sets(21, n_sets=1, length=200, err=0.04) \
        + _indel_heavy_sets(22, n_sets=1, length=200)
    params = PoaParams(band=16, adaptive=True)
    steps = K.poa_consensus_batch(sets, params, device="cpu", walk="steps")
    swept = K.poa_consensus_batch(sets, params, device="cpu", walk="sweep")
    assert [s.tolist() for s in swept] == [s.tolist() for s in steps]
    for reads, got in zip(sets, swept):
        assert got.tolist() == native_poa_consensus(reads, params).tolist()
    monkeypatch.setenv("MANDO_POA_PALLAS", "interpret")
    monkeypatch.setenv("MANDO_POA_SWEEP", "1")
    want = reference_batch(sets, RefParams(band=16, adaptive=True))
    assert [s.tolist() for s in swept] == [w.tolist() for w in want]
    with pytest.raises(ValueError, match="unknown walk"):
        K.poa_consensus_batch(sets, params, device="cpu", walk="records")


def _count_walks(monkeypatch):
    """Count the calls of both walk wrappers (on the CPU the launch
    counters stand still: nothing is launched)."""
    calls = {"steps": 0, "sweep": 0}
    real_walk, real_sweep = K.poa_walk, K.poa_sweep

    def walk(*args):
        calls["steps"] += 1
        return real_walk(*args)

    def sweep(*args):
        calls["sweep"] += 1
        return real_sweep(*args)

    monkeypatch.setattr(K, "poa_walk", walk)
    monkeypatch.setattr(K, "poa_sweep", sweep)
    return calls


def test_rank_limit_sends_oversize_chunks_to_the_step_walk(monkeypatch):
    assert K.SWEEP_RANK_LIMIT == 1 << 15
    assert K.chunk_walk("sweep", (1 << 15) - 3) == "sweep"
    assert K.chunk_walk("sweep", (1 << 15) - 2) == "steps"
    assert K.chunk_walk("steps", 64) == "steps"
    # a round's row cap is its largest graph's: 512 while the 400-base
    # graph is live (rounds 1-2), 128 after (rounds 3-4). With the limit
    # between the two only the late rounds are swept
    rng = np.random.default_rng(31)
    sets = []
    for length, n_reads in ((100, 5), (400, 3)):
        true = rng.integers(0, 4, length).astype(np.uint8)
        sets.append([_mutate(rng, true, 0.04) for _ in range(n_reads)])
    params = PoaParams(band=16, adaptive=True)
    want = K.poa_consensus_batch(sets, params, device="cpu")
    obs = K.RunObserver()
    monkeypatch.setattr(K, "OBSERVER", obs)
    monkeypatch.setattr(K, "SWEEP_RANK_LIMIT", 256)
    calls = _count_walks(monkeypatch)
    got = K.poa_consensus_batch(sets, params, device="cpu", walk="sweep")
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    under = sum(K.chunk_walk("sweep", c[1]) == "sweep" for c in obs.chunks)
    assert 0 < under < len(obs.chunks)
    assert calls == {"sweep": under, "steps": len(obs.chunks) - under}


def test_pipeline_sweep_route_matches_reference(tmp_path, monkeypatch):
    """MANDO_POA_SWEEP=1 reaches module D's round loop through the
    pipeline; the six artifacts equal mandalorion_tpu's default run."""
    from mandalorion_tpu.config import PipelineConfig as ReferenceConfig
    from mandalorion_tpu.pipeline.stages import run_pipeline as reference_run
    from mandalorion_tpu.utils.simulate import make_dataset
    from mandalorion_tpu_torch.config import PipelineConfig, PoaConfig
    from mandalorion_tpu_torch.pipeline.stages import run_pipeline
    from test_torch_pipeline import _artifacts
    make_dataset(str(tmp_path), n_genes=1, n_reads_per_gene=8,
                 genome_len=40_000, seed=1)
    dataset = [os.path.join(tmp_path, f) for f in
               ("genome.fasta", "ann.gtf", "reads.fasta")]
    reference_run(str(tmp_path / "ref"), *dataset, ReferenceConfig(threads=2))
    monkeypatch.setenv("MANDO_POA_SWEEP", "1")
    calls = _count_walks(monkeypatch)
    run_pipeline(str(tmp_path / "port"), *dataset,
                 PipelineConfig(threads=2, poa=PoaConfig(backend="device")),
                 device="cpu")
    assert calls["sweep"] > 0 and calls["steps"] == 0
    assert _artifacts(tmp_path / "port") == _artifacts(tmp_path / "ref")


# ------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_kernel_matches_plain(nn, ends, ql, mats):
    before = K.POA_SWEEP_LAUNCHES.count
    recs, counts = K.poa_sweep(nn, ends, ql, mats)
    torch.cuda.synchronize()
    assert K.POA_SWEEP_LAUNCHES.count == before + 1
    want, want_counts = K.poa_sweep_plain(nn, ends, ql, mats)
    assert torch.equal(counts, want_counts)
    for b, k in enumerate(want_counts.tolist()):
        assert torch.equal(recs[b, :k], want[b, :k]), b
    return recs.cpu().numpy(), counts.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("make,seed", [(_random_sets, 11),
                                       (_indel_heavy_sets, 3)])
def test_cuda_sweep_matches_plain(cuda_device, make, seed, adaptive):
    params = PoaParams(band=18, adaptive=adaptive)
    arrays, W, l_cap = _chunk_arrays(make(seed), params, 3)
    mats, (nn, ends, ql) = _port_mats(_padded(arrays), params, W,
                                      cuda_device)
    recs, counts = _assert_kernel_matches_plain(nn, ends, ql, mats)
    buf, ks = K.poa_walk(nn, ends, ql, mats, l_cap)
    _assert_expands_to(recs, counts, buf.cpu().numpy(), ks.cpu().numpy())


@pytest.mark.cuda
def test_cuda_sweep_long_back_edge(cuda_device):
    params = PoaParams(band=LONG_BAND, adaptive=True)
    arrays, W, _l = _chunk_arrays([_long_insertion_set(21)], params, 3)
    mats, (nn, ends, ql) = _port_mats(arrays, params, W, cuda_device)
    _assert_kernel_matches_plain(nn, ends, ql, mats)


@pytest.mark.cuda
def test_cuda_sweep_decodes_tier2_origins_as_unsigned(cuda_device):
    (nn, ends, ql, mats), want = _tier2_problem()
    recs, counts = _assert_kernel_matches_plain(
        nn.to(cuda_device), ends.to(cuda_device), ql.to(cuda_device),
        tuple(m.to(cuda_device) for m in mats))
    assert int(counts[0]) == 3 and np.array_equal(recs[0, :3], want)


@pytest.mark.cuda
def test_cuda_consensus_sweep_matches_native(cuda_device, monkeypatch):
    sets = _random_sets(21) + _indel_heavy_sets(22)
    params = PoaParams(band=18, adaptive=True)
    obs = K.RunObserver()
    monkeypatch.setattr(K, "OBSERVER", obs)
    before = (K.POA_SWEEP_LAUNCHES.count, K.POA_WALK_LAUNCHES.count)
    got = K.poa_consensus_batch(sets, params, device=cuda_device,
                                walk="sweep")
    assert (K.POA_SWEEP_LAUNCHES.count, K.POA_WALK_LAUNCHES.count) == \
        (before[0] + len(obs.chunks), before[1])
    for reads, g in zip(sets, got):
        assert g.tolist() == native_poa_consensus(reads, params).tolist()


# ------------------------------------------- hand-made and random matrices

def _ladder_problem(n_cap, qlen, off):
    """One problem whose rows n_cap .. 1 are a ladder of diagonal steps
    (row r into row r - 1) and whose row 1 jumps back up to row n_cap (a
    predecessor that is not an earlier row): the walk climbs the ladder
    again and again, 32 diagonal steps a tile, until a bound cuts it."""
    W = 256
    rows = n_cap + 1
    node = np.arange(rows) - 1 + 2                  # row r: into row r - 1
    node[1] = n_cap + 2                             # row 1: up to row n_cap
    hpack = np.zeros((1, rows, W), np.int32)
    hpack[0, 1:] = (node[1:] << 6)[:, None]         # op 0: diagonal
    zeros = np.zeros_like(hpack)
    offs = np.full((1, rows), off, np.int32)
    endcol = np.full((1, rows), NEG, np.int32)
    endcol[0, n_cap] = 5
    ends = np.zeros((1, n_cap), np.uint8)
    ends[0, n_cap - 1] = 1
    mats = tuple(torch.from_numpy(m) for m in
                 (hpack, zeros, zeros.copy(), zeros.copy(), offs, endcol))
    return (torch.tensor([n_cap], dtype=torch.int32), torch.from_numpy(ends),
            torch.tensor([qlen], dtype=torch.int32), mats)


@pytest.mark.parametrize("n_cap,cut", [
    (64, K.sweep_record_cap(64)),   # max_rec cuts a tile's records
    (4, 3 * 5),                     # 3 x rows transitions cut first
])
def test_sweep_bounds_cut_a_ladder(n_cap, cut):
    nn, ends, ql, mats = _ladder_problem(n_cap, 400, 145)
    recs, counts = K.poa_sweep_plain(nn, ends, ql, mats)
    assert int(counts[0]) == cut
    live = recs[0, :cut].numpy()
    assert (live[:, 0] >> 16 == K.REC_DIAG).all()
    assert np.array_equal(live[:, 0] & 0xFFFF, np.arange(399, 399 - cut, -1))


def _random_mats(seed, B, n_cap, W, acyclic):
    """Matrices of random cells over query columns 0..W-1: mostly diagonal
    steps a row or a few back (runs inside a tile), some far back or, in a
    tenth of the rows, reads outside a shifted window; every other op, both
    insertion tiers with any origin, deletion pointers with and without
    the extension bit. With `acyclic` every pointer names an earlier row
    and the step walk ends; without, paths may loop until the record
    walk's bounds cut them."""
    rng = np.random.default_rng(seed)
    rows = n_cap + 1
    shape = (B, rows, W)
    r = np.arange(rows)[None, :, None]
    op = rng.choice(8, size=shape, p=[0.86] + [0.02] * 7)
    op0 = rng.choice(8, size=shape, p=[0.44] + [0.08] * 7)
    near = r - rng.geometric(0.6, shape)
    far = (rng.random(shape) * (r if acyclic else rows + 1)).astype(np.int64)
    prev = np.where(rng.random(shape) < 0.9, near, far)
    hpack = (op | op0 << 3 | np.maximum(prev + 2, 0) << 6).astype(np.int32)
    origin = rng.integers(0, W, (2,) + shape)
    opack = (origin[0] | origin[1] << 16).astype(np.uint32).view(np.int32)
    back = rng.random((2,) + shape) * (r if acyclic else rows)
    dptr = (back.astype(np.int64) << 1 | rng.integers(0, 2, (2,) + shape))
    offs = np.where(rng.random((B, rows)) < 0.1,
                    rng.integers(-W // 2, W // 2, (B, rows)), 0)
    endcol = rng.integers(-50, 50, (B, rows)).astype(np.int32)
    ends = (rng.random((B, n_cap)) < 0.3).astype(np.uint8)
    nn = rng.integers(0, n_cap + 1, B).astype(np.int32)
    ql = rng.integers(W // 2, W, B).astype(np.int32)
    mats = tuple(torch.from_numpy(np.ascontiguousarray(m, np.int32))
                 for m in (hpack, opack, dptr[0], dptr[1], offs, endcol))
    return (torch.from_numpy(nn), torch.from_numpy(ends),
            torch.from_numpy(ql), mats)


def test_random_matrices_stay_in_bounds():
    """The plain walks on random cells: the record walk stops within
    max_rec records and writes every record type; on acyclic cells the
    step walk ends within its max_steps."""
    nn, ends, ql, mats = _random_mats(7, 12, 40, 64, acyclic=False)
    recs, counts = K.poa_sweep_plain(nn, ends, ql, mats)
    assert int(counts.max()) <= K.sweep_record_cap(40)
    types = np.concatenate([recs[b, :k, 0].numpy() >> 16 & 3
                            for b, k in enumerate(counts.tolist())])
    assert {K.REC_DIAG, K.REC_DEL, K.REC_INS} <= set(types.tolist())
    nn, ends, ql, mats = _random_mats(8, 12, 40, 64, acyclic=True)
    _buf, ks = K.poa_walk_plain(nn, ends, ql, mats, 64)
    assert 0 < int(ks.max()) <= 40 + 64 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n_cap,cut", [(64, K.sweep_record_cap(64)),
                                       (4, 3 * 5)])
def test_cuda_sweep_bounds_cut_a_ladder(cuda_device, n_cap, cut):
    nn, ends, ql, mats = _ladder_problem(n_cap, 400, 145)
    _recs, counts = _assert_kernel_matches_plain(
        nn.to(cuda_device), ends.to(cuda_device), ql.to(cuda_device),
        tuple(m.to(cuda_device) for m in mats))
    assert int(counts[0]) == cut


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n_cap,W", [(1, 8, 64), (2, 70, 256),
                                          (3, 300, 128)])
def test_cuda_sweep_random_matrices(cuda_device, seed, n_cap, W):
    """Random cells: tiles left every way, insertion runs to any origin
    (across a tile edge or forward), deletion chains, loops cut by max_rec
    and by the 3 x rows bound; the kernel's records equal the plain
    version's, record for record."""
    args = _random_mats(seed, 40, n_cap, W, acyclic=False)
    recs, counts = _assert_kernel_matches_plain(
        *(a.to(cuda_device) for a in args[:3]),
        tuple(m.to(cuda_device) for m in args[3]))
    types = np.concatenate([recs[b, :k, 0] >> 16 & 3
                            for b, k in enumerate(counts)])
    assert {K.REC_DIAG, K.REC_DEL, K.REC_INS} <= set(types.tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n_cap,W", [(4, 8, 64), (5, 70, 256),
                                          (6, 300, 128)])
def test_cuda_step_walk_random_matrices(cuda_device, seed, n_cap, W):
    """The step walk on the shared chase, on random acyclic cells: kernel
    == plain, for the step walk and the record walk. (Their streams need
    not agree here: an insertion origin at or past its column, which the
    forward never writes, sends the two walks different ways.)"""
    nn, ends, ql, mats = _random_mats(seed, 40, n_cap, W, acyclic=True)
    nn, ends, ql = (a.to(cuda_device) for a in (nn, ends, ql))
    mats = tuple(m.to(cuda_device) for m in mats)
    l_cap = W
    buf, ks = K.poa_walk(nn, ends, ql, mats, l_cap)
    want, want_ks = K.poa_walk_plain(nn, ends, ql, mats, l_cap)
    assert torch.equal(ks, want_ks)
    for b, k in enumerate(want_ks.tolist()):
        assert torch.equal(buf[b, :k], want[b, :k]), b
    _assert_kernel_matches_plain(nn, ends, ql, mats)
