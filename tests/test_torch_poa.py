"""The port's graph-POA device functions against the JAX package's.

The same rank-space arrays (numpy, from seeded read sets through
`graph_arrays`) go through mandalorion_tpu's forward (the Pallas kernel
in interpret mode and the vmapped XLA `_align_rows`) and walk
(`_traceback_from_mats_batch`), and through the port's plain PyTorch
versions on the CPU. Integer DP: every comparison is exact equality, on
rows 0..nn[b] of each problem and on buf[:ks]. Reference-side queries
stay below 32768 bases (its 16-bit origin decode is signed).

The `cuda` cases hold each CUDA kernel against its plain version on the
card (run them with --noconftest where jax is not installed; the
reference imports are inside the CPU tests for that reason).
"""

import numpy as np
import pytest
import torch

from mandalorion_tpu_torch.native import native_poa_consensus
from mandalorion_tpu_torch.poa import kernels as K
from mandalorion_tpu_torch.poa.graph import NEG, PoaGraph, PoaParams
from mandalorion_tpu_torch.poa.graph import poa_consensus as port_oracle


def _mutate(rng, base, err):
    out = []
    for b in base:
        u = rng.random()
        if u < err / 3:
            continue
        if u < 2 * err / 3:
            out.extend([b, rng.integers(0, 4)])
        elif u < err:
            out.append(rng.integers(0, 4))
        else:
            out.append(b)
    return np.array(out, np.uint8)


def _rand_sets(seed, n_sets=3, reads_lo=3, reads_hi=7, len_lo=60,
               len_hi=300):
    """The random sets of tests/test_poa.py: a base read and noisy
    copies."""
    rng = np.random.default_rng(seed)
    sets = []
    for _ in range(n_sets):
        base = rng.integers(0, 4, int(rng.integers(len_lo, len_hi)))
        base = base.astype(np.uint8)
        sets.append([base.copy()] + [
            _mutate(rng, base, 0.04)
            for _ in range(int(rng.integers(reads_lo, reads_hi)))])
    return sets


def _indel_sets(seed, n_sets=2, n_reads=6, length=300):
    """The indel-heavy sets of tests/test_poa_pallas.py: 1-3 base
    deletions and 3-base insertions shift the band offsets between
    rows."""
    rng = np.random.default_rng(seed)
    sets = []
    for _ in range(n_sets):
        true = rng.integers(0, 4, length).astype(np.uint8)
        reads = []
        for _ in range(n_reads):
            r = true
            for _k in range(3):
                p = int(rng.integers(20, len(r) - 20))
                if rng.random() < 0.5:
                    r = np.concatenate([r[:p],
                                        r[p + int(rng.integers(1, 4)):]])
                else:
                    ins = rng.integers(0, 4, 3).astype(np.uint8)
                    r = np.concatenate([r[:p], ins, r[p:]])
            reads.append(r)
        sets.append(reads)
    return sets


def _long_insertion_set(seed, length=700, insert=320):
    """One read carries an `insert`-base insertion: once it is threaded
    into the graph (by a band wide enough to align it, LONG_BAND), the
    node after it has a predecessor `insert` + 1 rows back."""
    rng = np.random.default_rng(seed)
    true = rng.integers(0, 4, length).astype(np.uint8)
    ins = rng.integers(0, 4, insert).astype(np.uint8)
    with_ins = np.concatenate([true[:350], ins, true[350:]])
    return [true, with_ins, _mutate(rng, true, 0.03),
            _mutate(rng, with_ins, 0.03), _mutate(rng, true, 0.03)]


LONG_BAND = 340


def _chunk_arrays(sets, params, round_k):
    """Rank-space arrays of round `round_k` (reads 1..round_k-1 threaded
    by the Python engine) for every set, padded as the round loop pads
    them; one width class (asserted)."""
    graphs, queries = [], []
    for reads in sets:
        g = PoaGraph(reads[0])
        for q in reads[1:round_k]:
            g.add_read(q, params)
        graphs.append(g)
        queries.append(reads[round_k])
    orders = [g.topo_order() for g in graphs]
    n_cap = K._rank_cap(max(len(o) for o in orders))
    l_cap = K._pow2_at_least(max(len(q) for q in queries))
    p_cap = K._pow2_at_least(max(len(g.preds[v]) for g in graphs
                                 for v in range(len(g.base))), floor=4)
    widths = {K._item_width(len(o), len(q), params.band, l_cap,
                            params.adaptive)
              for o, q in zip(orders, queries)}
    assert len(widths) == 1
    B = len(sets)
    base = np.zeros((B, n_cap), np.int32)
    preds = np.full((B, n_cap, p_cap), -1, np.int32)
    ends = np.zeros((B, n_cap), bool)
    nn = np.zeros(B, np.int32)
    qq = np.zeros((B, l_cap), np.int32)
    ql = np.zeros(B, np.int32)
    for bi, (g, q, order) in enumerate(zip(graphs, queries, orders)):
        base[bi], preds[bi], ends[bi], _ = K.graph_arrays(g, n_cap, p_cap,
                                                         order)
        nn[bi], ql[bi] = len(order), len(q)
        qq[bi, :len(q)] = q
    return (base, preds, nn, ends, qq, ql), widths.pop(), l_cap


def _port_mats(arrays, params, W, device="cpu"):
    base, preds, nn, ends, qq, ql = K.problems_from_numpy(*arrays, device)
    return K.poa_forward(base, preds, nn, qq, ql, params, W), (nn, ends, ql)


def _scoring(p):
    return (p.match, p.mismatch, p.gap_open, p.gap_extend, p.gap_open2,
            p.gap_extend2)


def _reference_xla_mats(arrays, params, W):
    """vmapped `_align_rows`: batch-major mats like the port's."""
    import jax
    import jax.numpy as jnp
    from mandalorion_tpu.poa.kernels import _align_rows
    base, preds, nn, _ends, qq, ql = arrays
    fn = jax.vmap(lambda b, p, n, q, l: _align_rows(
        b, p, n, q, l, jnp.int32(int(nn.max())), *_scoring(params),
        params.band, W, params.adaptive))
    return [np.asarray(m) for m in fn(base, preds, nn, qq, ql)]


def _reference_pallas_mats(arrays, params, W):
    """The Pallas kernel in interpret mode; its (n_cap+1, B, ...) layout
    transposed to the port's."""
    from mandalorion_tpu.poa.pallas_kernel import poa_forward_pallas
    base, preds, nn, _ends, qq, ql = arrays
    outs = poa_forward_pallas(base, preds, nn, qq, ql, int(nn.max()),
                              *_scoring(params), params.band, W,
                              interpret=True)
    return [np.swapaxes(np.asarray(m), 0, 1) for m in outs]


def _assert_mats_equal(got, want, nn):
    names = ("hpack", "opack", "d1p", "d2p", "offs", "endcol")
    for name, g, w in zip(names, got, want):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, name
        for b, n in enumerate(nn):
            assert np.array_equal(g[b, :n + 1], w[b, :n + 1]), (name, b)


# ------------------------------------------------------------ forward

@pytest.mark.parametrize("seed,make,band", [(42, _rand_sets, 16),
                                            (7, _rand_sets, 24),
                                            (5, _indel_sets, 24),
                                            (6, _indel_sets, 20)])
@pytest.mark.parametrize("round_k", [1, 3])
def test_forward_plain_matches_pallas_and_xla(seed, make, band, round_k):
    params = PoaParams(band=band, adaptive=True)
    arrays, W, _l = _chunk_arrays(make(seed), params, round_k)
    got, _ = _port_mats(arrays, params, W)
    _assert_mats_equal(got, _reference_xla_mats(arrays, params, W),
                       arrays[2])
    _assert_mats_equal(got, _reference_pallas_mats(arrays, params, W),
                       arrays[2])


@pytest.mark.parametrize("seed,make", [(11, _rand_sets), (12, _indel_sets)])
def test_forward_plain_static_band_matches_xla(seed, make):
    params = PoaParams(band=12, adaptive=False)
    arrays, W, _l = _chunk_arrays(make(seed), params, 2)
    got, _ = _port_mats(arrays, params, W)
    _assert_mats_equal(got, _reference_xla_mats(arrays, params, W),
                       arrays[2])


def test_forward_rows_past_a_problem_are_inert():
    params = PoaParams(band=16, adaptive=True)
    arrays, W, _l = _chunk_arrays(_rand_sets(3), params, 2)
    got, _ = _port_mats(arrays, params, W)
    nn = arrays[2]
    assert nn.min() < nn.max()
    for b, n in enumerate(nn):
        for mat in got[:5]:
            assert not mat[b, n + 1:].any()
        assert bool((got[5][b, n + 1:] == NEG).all())


def test_forward_reads_rows_beyond_the_reference_ring():
    """A predecessor more than ring_depth(W) - 1 rows back: the reference
    gates such graphs off its Pallas kernel; the port's forward reads any
    earlier row, and agrees with the XLA forward."""
    from mandalorion_tpu.poa.pallas_kernel import ring_depth
    params = PoaParams(band=LONG_BAND, adaptive=True)
    arrays, W, _l = _chunk_arrays([_long_insertion_set(21)], params, 3)
    _base, preds, nn, *_ = arrays
    assert K.max_back_distance(preds[0], int(nn[0])) > \
        max(256, ring_depth(W) - 1)
    got, _ = _port_mats(arrays, params, W)
    _assert_mats_equal(got, _reference_xla_mats(arrays, params, W), nn)


def test_forward_rejects_bad_arguments():
    params = PoaParams(band=16, adaptive=True)
    arrays, W, _l = _chunk_arrays(_rand_sets(1, n_sets=1), params, 1)
    base, preds, nn, _ends, qq, ql = K.problems_from_numpy(*arrays, "cpu")
    with pytest.raises(ValueError, match="power of two"):
        K.poa_forward(base, preds, nn, qq, ql, params, 300)
    with pytest.raises(ValueError, match="int32"):
        K.poa_forward(base.long(), preds, nn, qq, ql, params, W)
    with pytest.raises(ValueError, match="node counts"):
        K.poa_forward(base, preds, nn + base.shape[1], qq, ql, params, W)


# --------------------------------------------------------------- walk

@pytest.mark.parametrize("seed,make,adaptive", [(42, _rand_sets, True),
                                                (5, _indel_sets, True),
                                                (9, _rand_sets, False)])
def test_walk_plain_matches_reference_walk(seed, make, adaptive):
    from mandalorion_tpu.poa.kernels import _traceback_from_mats_batch
    params = PoaParams(band=20, adaptive=adaptive)
    arrays, W, l_cap = _chunk_arrays(make(seed), params, 2)
    _base, preds, nn, ends, _qq, ql = arrays
    mats, (t_nn, t_ends, t_ql) = _port_mats(arrays, params, W)
    buf, ks = K.poa_walk(t_nn, t_ends, t_ql, mats, l_cap)
    # the reference walk takes (n_cap+1, B, ...) mats, batch axis 1
    ref_mats = [np.swapaxes(m.numpy(), 0, 1) for m in mats]
    want_buf, want_ks = _traceback_from_mats_batch(
        preds, nn, ends, ql, *ref_mats, params.gap_open, params.gap_extend,
        params.gap_open2, params.gap_extend2, W, l_cap)
    want_buf, want_ks = np.asarray(want_buf), np.asarray(want_ks)
    assert np.array_equal(ks.numpy(), want_ks)
    assert ks.min() > 0
    for b, k in enumerate(want_ks):
        assert np.array_equal(buf[b, :k].numpy(), want_buf[b, :k]), b


def test_walk_decodes_tier2_origins_as_unsigned():
    """Two hand-made matrix rows whose window starts near column 40,000:
    the end cell is a tier-2 insertion with origin 39,990 >= 32768. The
    walk must emit the ten inserted bases 39,999..39,990, then one
    diagonal step into row 0 and row 0's insertions down to column 0."""
    W, n_cap, l_cap = 256, 64, 65536
    off, qlen, origin = 39_900, 40_000, 39_990
    hpack = np.zeros((1, n_cap + 1, W), np.int32)
    opack = np.zeros_like(hpack)
    d1p, d2p = np.zeros_like(hpack), np.zeros_like(hpack)
    offs = np.zeros((1, n_cap + 1), np.int32)
    endcol = np.full((1, n_cap + 1), NEG, np.int32)
    hpack[0, 0] = 1                      # row 0: insertions
    offs[0, 1] = off
    # row 1, column qlen: final op 3 (tier-2 insertion), op0 0 (diag),
    # node0 0 (the virtual source row)
    hpack[0, 1, qlen - off] = 3 | (0 << 3) | ((0 + 2) << 6)
    opack[0, 1, qlen - off] = np.uint32(origin << 16).astype(np.int32)
    # row 1, column `origin`: pre-insertion op is the diagonal
    hpack[0, 1, origin - off] = 0 | (0 << 3) | ((0 + 2) << 6)
    endcol[0, 1] = 5
    mats = tuple(torch.from_numpy(m) for m in
                 (hpack, opack, d1p, d2p, offs, endcol))
    ends = torch.zeros((1, n_cap), dtype=torch.uint8)
    ends[0, 0] = 1
    nn = torch.tensor([1], dtype=torch.int32)
    ql = torch.tensor([qlen], dtype=torch.int32)
    buf, ks = K.poa_walk_plain(nn, ends, ql, mats, l_cap)
    k = int(ks[0])
    steps = buf[0, :k].numpy()
    n_ins = qlen - origin
    assert np.array_equal(steps[:n_ins, 0],
                          np.arange(qlen - 1, origin - 1, -1))
    assert (steps[:n_ins, 1] == -1).all()
    assert tuple(steps[n_ins]) == (origin - 1, 0)      # the diagonal
    assert np.array_equal(steps[n_ins + 1:, 0],
                          np.arange(origin - 2, -1, -1))
    assert k == qlen


# ---------------------------------------------------------- consensus

@pytest.mark.parametrize("seed,make", [(42, _rand_sets), (43, _rand_sets),
                                       (5, _indel_sets), (6, _indel_sets)])
def test_consensus_matches_every_engine(monkeypatch, seed, make):
    from mandalorion_tpu.poa.graph import PoaParams as RefParams
    from mandalorion_tpu.poa.kernels import (
        poa_consensus_batch as reference_batch)
    sets = make(seed)
    params = PoaParams(band=20, adaptive=True)
    got = K.poa_consensus_batch(sets, params, device="cpu")
    ref_params = RefParams(band=20, adaptive=True)
    for mode in ("interpret", "0"):
        monkeypatch.setenv("MANDO_POA_PALLAS", mode)
        want = reference_batch(sets, ref_params)
        assert [g.tolist() for g in got] == [w.tolist() for w in want], mode
    for reads, g in zip(sets, got):
        assert g.tolist() == port_oracle(reads, params).tolist()
        assert g.tolist() == native_poa_consensus(reads, params).tolist()


def test_consensus_static_band_matches_oracle():
    sets = _rand_sets(17)
    params = PoaParams(band=12, adaptive=False)
    got = K.poa_consensus_batch(sets, params, device="cpu")
    for reads, g in zip(sets, got):
        assert g.tolist() == port_oracle(reads, params).tolist()


def test_consensus_with_a_long_back_edge(monkeypatch):
    reads = _long_insertion_set(21)
    params = PoaParams(band=LONG_BAND, adaptive=True)
    obs = K.RunObserver(keep_rounds=range(1, len(reads)))
    monkeypatch.setattr(K, "OBSERVER", obs)
    got = K.poa_consensus_batch([reads], params, device="cpu")
    seen = [K.max_back_distance(a[1][0], int(a[2][0]))
            for _k, _W, _l, a in obs.kept]
    assert max(seen) > 300
    assert got[0].tolist() == native_poa_consensus(reads, params).tolist()


def test_align_graph_batch_matches_python_engine():
    """Per-read device DP + walk == PoaGraph.align, step for step."""
    params = PoaParams()
    for reads in _rand_sets(42):
        g_py, g_k = PoaGraph(reads[0]), PoaGraph(reads[0])
        for q in reads[1:]:
            p_py = g_py.align(q, params)
            p_k = K.align_graph_batch([g_k], [q], params, device="cpu")[0]
            assert p_py == p_k
            g_py.apply_path(q, p_py)
            g_k.apply_path(q, p_k)
        assert np.array_equal(g_py.consensus(), g_k.consensus())


def test_chunking_changes_padding_only(monkeypatch):
    sets = _rand_sets(8, n_sets=5)
    params = PoaParams(band=16, adaptive=True)
    want = K.poa_consensus_batch(sets, params, device="cpu")
    obs = K.RunObserver()
    monkeypatch.setattr(K, "OBSERVER", obs)
    monkeypatch.setattr(K, "CHUNK_BYTES", 1)     # one problem a chunk
    got = K.poa_consensus_batch(sets, params, device="cpu")
    assert obs.chunks and all(c[0] == 1 for c in obs.chunks)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]


def test_query_length_limit():
    with pytest.raises(ValueError, match="65536"):
        K.poa_consensus_batch(
            [[np.zeros(10, np.uint8), np.zeros(1 << 16, np.uint8)]],
            PoaParams(), device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        K.poa_consensus_batch(_rand_sets(1, n_sets=1), PoaParams(),
                              device="cuda")


# ------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_kernels_match_plain(arrays, params, W, l_cap, device):
    """Forward and walk kernels against their plain versions on the
    card: whole tensors, buf[:ks] and ks."""
    base, preds, nn, ends, qq, ql = K.problems_from_numpy(*arrays, device)
    before = (K.POA_FWD_LAUNCHES.count, K.POA_WALK_LAUNCHES.count)
    mats = K.poa_forward(base, preds, nn, qq, ql, params, W)
    buf, ks = K.poa_walk(nn, ends, ql, mats, l_cap)
    torch.cuda.synchronize()
    assert (K.POA_FWD_LAUNCHES.count, K.POA_WALK_LAUNCHES.count) == \
        (before[0] + 1, before[1] + 1)
    want = K.poa_forward_plain(base, preds, nn, qq, ql, params, W)
    for g, w in zip(mats, want):
        assert torch.equal(g, w)
    want_buf, want_ks = K.poa_walk_plain(nn, ends, ql, want, l_cap)
    assert torch.equal(ks, want_ks)
    for b, k in enumerate(want_ks.tolist()):
        assert torch.equal(buf[b, :k], want_buf[b, :k])


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("seed,make", [(42, _rand_sets), (5, _indel_sets)])
def test_cuda_kernels_match_plain(cuda_device, seed, make, adaptive):
    params = PoaParams(band=20, adaptive=adaptive)
    arrays, W, l_cap = _chunk_arrays(make(seed), params, 2)
    _assert_kernels_match_plain(arrays, params, W, l_cap, cuda_device)


@pytest.mark.cuda
def test_cuda_kernels_long_back_edge(cuda_device):
    params = PoaParams(band=LONG_BAND, adaptive=True)
    arrays, W, l_cap = _chunk_arrays([_long_insertion_set(21)], params, 3)
    _assert_kernels_match_plain(arrays, params, W, l_cap, cuda_device)


@pytest.mark.cuda
def test_cuda_consensus_matches_native(cuda_device):
    sets = _rand_sets(42) + _indel_sets(5)
    params = PoaParams(band=20, adaptive=True)
    got = K.poa_consensus_batch(sets, params, device=cuda_device)
    for reads, g in zip(sets, got):
        assert g.tolist() == native_poa_consensus(reads, params).tolist()
