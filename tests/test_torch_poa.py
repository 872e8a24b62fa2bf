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

import dataclasses

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


def _chunk_arrays(sets, params, round_k, bands=None):
    """Rank-space arrays of round `round_k` (reads 1..round_k-1 threaded
    by the Python engine) for every set, padded as the round loop pads
    them; one width class (asserted). `bands` gives each set its own band
    half-width (default: params.band for all)."""
    bands = [params.band] * len(sets) if bands is None else list(bands)
    graphs, queries = [], []
    for reads, band in zip(sets, bands):
        g = PoaGraph(reads[0])
        for q in reads[1:round_k]:
            g.add_read(q, dataclasses.replace(params, band=band))
        graphs.append(g)
        queries.append(reads[round_k])
    orders = [g.topo_order() for g in graphs]
    n_cap = K._rank_cap(max(len(o) for o in orders))
    l_cap = K._pow2_at_least(max(len(q) for q in queries))
    p_cap = K._pow2_at_least(max(len(g.preds[v]) for g in graphs
                                 for v in range(len(g.base))), floor=4)
    widths = {K._item_width(len(o), len(q), band, l_cap, params.adaptive)
              for o, q, band in zip(orders, queries, bands)}
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
    band = np.array(bands, np.int32)
    return (base, preds, nn, ends, qq, ql, band), widths.pop(), l_cap


def _port_mats(arrays, params, W, device="cpu"):
    base, preds, nn, ends, qq, ql, band = K.problems_from_numpy(*arrays,
                                                                device)
    return (K.poa_forward(base, preds, nn, qq, ql, params, W, band),
            (nn, ends, ql))


def _scoring(p):
    return (p.match, p.mismatch, p.gap_open, p.gap_extend, p.gap_open2,
            p.gap_extend2)


def _reference_xla_mats(arrays, params, W):
    """vmapped `_align_rows`: batch-major mats like the port's."""
    import jax
    import jax.numpy as jnp
    from mandalorion_tpu.poa.kernels import _align_rows
    base, preds, nn, _ends, qq, ql, _band = arrays
    fn = jax.vmap(lambda b, p, n, q, l: _align_rows(
        b, p, n, q, l, jnp.int32(int(nn.max())), *_scoring(params),
        params.band, W, params.adaptive))
    return [np.asarray(m) for m in fn(base, preds, nn, qq, ql)]


def _reference_pallas_mats(arrays, params, W):
    """The Pallas kernel in interpret mode; its (n_cap+1, B, ...) layout
    transposed to the port's."""
    from mandalorion_tpu.poa.pallas_kernel import poa_forward_pallas
    base, preds, nn, _ends, qq, ql, _band = arrays
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


# a narrow band between wider ones, a wide one between narrower ones
MIXED_BANDS = (24, 12, 20, 12, 24)


def _mixed_band_chunk(seed, adaptive, round_k=3):
    params = PoaParams(band=MIXED_BANDS[0], adaptive=adaptive)
    sets = _rand_sets(seed, n_sets=3) + _indel_sets(seed + 1)
    return _chunk_arrays(sets, params, round_k, MIXED_BANDS) + (params,)


def _one_band_at_a_time(arrays, params):
    """The chunk's problems regrouped by band: [(params of that band,
    problem indices, the arrays of those problems)]."""
    band = arrays[6]
    groups = []
    for value in sorted(set(band.tolist())):
        idx = np.flatnonzero(band == value)
        groups.append((dataclasses.replace(params, band=value), idx,
                       tuple(a[idx] for a in arrays)))
    return groups


@pytest.mark.parametrize("adaptive", [True, False])
def test_forward_mixed_bands_match_one_band_at_a_time(adaptive):
    """One chunk of five problems under three bands: every problem's
    matrices are those of a launch that holds its band alone (band read
    from params, as before bands were an input), and those are the
    reference's at that band. Exact."""
    arrays, W, _l, params = _mixed_band_chunk(31, adaptive)
    assert len(set(arrays[6].tolist())) == 3 and arrays[2].min() > 0
    mixed, _ = _port_mats(arrays, params, W)
    for p_band, idx, sub in _one_band_at_a_time(arrays, params):
        base, preds, nn, _e, qq, ql, _b = K.problems_from_numpy(*sub, "cpu")
        alone = K.poa_forward(base, preds, nn, qq, ql, p_band, W)
        _assert_mats_equal([m[idx] for m in mixed],
                           [m.numpy() for m in alone], sub[2])
        _assert_mats_equal(alone, _reference_xla_mats(sub, p_band, W),
                           sub[2])
        if adaptive:
            _assert_mats_equal(alone, _reference_pallas_mats(sub, p_band, W),
                               sub[2])


def test_forward_rejects_a_bad_band():
    arrays, W, _l, params = _mixed_band_chunk(31, True)
    base, preds, nn, _e, qq, ql, band = K.problems_from_numpy(*arrays, "cpu")
    with pytest.raises(ValueError, match="band"):
        K.poa_forward(base, preds, nn, qq, ql, params, W, band[:2])
    with pytest.raises(ValueError, match="band"):
        K.poa_forward(base, preds, nn, qq, ql, params, W, band.long())
    with pytest.raises(ValueError, match="band"):
        K.problems_from_numpy(*arrays[:6], -arrays[6], "cpu")


def _fan_in_chunk(seed, fan=40, n=150, qlen=120):
    """Two hand-made rank-space graphs in which every node has all of the
    `fan` (problem 0) or 3 (problem 1) ranks before it as predecessors,
    nearest first: lists longer than a warp, most entries far back."""
    rng = np.random.default_rng(seed)
    n_cap, l_cap = K._rank_cap(n), K._pow2_at_least(qlen)
    p_cap = K._pow2_at_least(fan, floor=4)
    base = np.zeros((2, n_cap), np.int32)
    preds = np.full((2, n_cap, p_cap), -1, np.int32)
    ends = np.zeros((2, n_cap), bool)
    qq = np.zeros((2, l_cap), np.int32)
    for b, width in enumerate((fan, 3)):
        base[b, :n] = rng.integers(0, 4, n)
        for r in range(n):          # rank r is matrix row r + 1
            rows = np.arange(r, max(r - width, -1), -1)
            preds[b, r, :len(rows)] = rows
        ends[b, n - 1] = True
        qq[b, :qlen] = base[b, rng.choice(n, qlen, replace=False).argsort()]
    nn = np.full(2, n, np.int32)
    ql = np.full(2, qlen, np.int32)
    band = np.array([20, 28], np.int32)
    return (base, preds, nn, ends, qq, ql, band), 256, l_cap


def test_forward_plain_long_predecessor_lists_match_xla():
    arrays, W, _l = _fan_in_chunk(3)
    assert arrays[1].shape[2] == 64
    params = PoaParams(band=20, adaptive=True)
    got, _ = _port_mats(arrays, params, W)
    for _p, idx, sub in _one_band_at_a_time(arrays, params):
        _assert_mats_equal([m[idx] for m in got],
                           _reference_xla_mats(sub, _p, W), sub[2])


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
    base, preds, nn, _ends, qq, ql, _band = K.problems_from_numpy(*arrays,
                                                                  "cpu")
    with pytest.raises(ValueError, match="power of two"):
        K.poa_forward(base, preds, nn, qq, ql, params, 300)
    with pytest.raises(ValueError, match="int32"):
        K.poa_forward(base.long(), preds, nn, qq, ql, params, W)
    with pytest.raises(ValueError, match="node counts"):
        K.poa_forward(base, preds, nn + base.shape[1], qq, ql, params, W)


def test_forward_warps_are_the_kernels():
    """The warp count the launcher records (`poa.fwd.warps`) is the one
    csrc/poa_fwd.cu is built with, and splits a tile of 256 columns evenly
    over its lanes."""
    import os
    import re
    from mandalorion_tpu_torch import _build
    with open(os.path.join(_build.CSRC, "poa_fwd.cu")) as fh:
        src = fh.read()
    warps = re.search(r"constexpr int kWarps = (\d+);", src)
    assert int(warps.group(1)) == K.FWD_WARPS
    assert 256 % (32 * K.FWD_WARPS) == 0


# --------------------------------------------------------------- walk

@pytest.mark.parametrize("seed,make,adaptive", [(42, _rand_sets, True),
                                                (5, _indel_sets, True),
                                                (9, _rand_sets, False)])
def test_walk_plain_matches_reference_walk(seed, make, adaptive):
    from mandalorion_tpu.poa.kernels import _traceback_from_mats_batch
    params = PoaParams(band=20, adaptive=adaptive)
    arrays, W, l_cap = _chunk_arrays(make(seed), params, 2)
    _base, preds, nn, ends, _qq, ql, _band = arrays
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
    (nn, ends, ql, mats, l_cap), (qlen, origin) = _tier2_origin_problem("cpu")
    buf, ks = K.poa_walk_plain(nn, ends, ql, mats, l_cap)
    _assert_tier2_origin_steps(buf[0, :int(ks[0])].numpy(), qlen, origin)


def _tier2_origin_problem(device):
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
    mats = tuple(torch.from_numpy(m).to(device) for m in
                 (hpack, opack, d1p, d2p, offs, endcol))
    ends = torch.zeros((1, n_cap), dtype=torch.uint8)
    ends[0, 0] = 1
    nn = torch.tensor([1], dtype=torch.int32)
    ql = torch.tensor([qlen], dtype=torch.int32)
    return ((nn.to(device), ends.to(device), ql.to(device), mats, l_cap),
            (qlen, origin))


def _assert_tier2_origin_steps(steps, qlen, origin):
    k = len(steps)
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


def _banded_sets(seed):
    """Five read sets and a band for each: three distinct bands."""
    return _rand_sets(seed, n_sets=3) + _indel_sets(seed + 1), MIXED_BANDS


def _grouped_consensi(sets, bands, params, run):
    """run(sets of one band, params of that band) for each band in turn,
    as a caller that groups by the whole params does; results in the
    order of `sets`."""
    out = [None] * len(sets)
    for value in sorted(set(bands)):
        idx = [i for i, b in enumerate(bands) if b == value]
        got = run([sets[i] for i in idx],
                  dataclasses.replace(params, band=value))
        for i, cons in zip(idx, got):
            out[i] = cons
    return out


def test_consensus_per_set_bands_match_grouped_calls(monkeypatch):
    """One call with a band a set == one call a band, the native engine
    and the JAX package's batch path at each band; and the observer sees
    one chunk a round where the grouped calls dispatched one a band."""
    from mandalorion_tpu.poa.graph import PoaParams as RefParams
    from mandalorion_tpu.poa.kernels import (
        poa_consensus_batch as reference_batch)
    sets, bands = _banded_sets(31)
    params = PoaParams(adaptive=True)
    merged = K.RunObserver()
    monkeypatch.setattr(K, "OBSERVER", merged)
    got = K.poa_consensus_batch(sets, params, device="cpu", bands=bands)
    grouped_obs = K.RunObserver()
    monkeypatch.setattr(K, "OBSERVER", grouped_obs)
    grouped = _grouped_consensi(
        sets, bands, params,
        lambda ss, p: K.poa_consensus_batch(ss, p, device="cpu"))
    monkeypatch.setattr(K, "OBSERVER", None)
    assert [g.tolist() for g in got] == [w.tolist() for w in grouped]
    monkeypatch.setenv("MANDO_POA_PALLAS", "0")
    reference = _grouped_consensi(
        sets, bands, params,
        lambda ss, p: reference_batch(ss, RefParams(band=p.band,
                                                    adaptive=True)))
    assert [g.tolist() for g in got] == [w.tolist() for w in reference]
    for reads, band, g in zip(sets, bands, got):
        assert g.tolist() == native_poa_consensus(
            reads, dataclasses.replace(params, band=band)).tolist()
    # one width class here: a chunk a round, every live set in it
    rounds = max(len(reads) for reads in sets) - 1
    assert merged.rounds == rounds and len(merged.chunks) == rounds
    assert merged.chunks[0][0] == len(sets)
    assert len({c[2] for c in merged.chunks}) == 1
    assert len(grouped_obs.chunks) > len(merged.chunks)
    assert max(c[0] for c in grouped_obs.chunks) < len(sets)


def test_consensus_rejects_a_band_list_of_the_wrong_length():
    with pytest.raises(ValueError, match="one band"):
        K.poa_consensus_batch(_rand_sets(1, n_sets=2), PoaParams(),
                              device="cpu", bands=[16])


def test_resolve_jobs_of_three_bands(monkeypatch):
    """Jobs whose params differ in the band only go through the device
    backend as one group (one chunk a round) and come out as the calls
    grouped by band and the native backend give them."""
    from mandalorion_tpu_torch.align.encode import decode
    from mandalorion_tpu_torch.poa.consensus import (ConsensusJob,
                                                     resolve_consensus_jobs)
    sets, bands = _banded_sets(31)
    params = PoaParams(adaptive=True)

    def jobs():
        return [ConsensusJob([f"r{i}"], oriented=reads, fallback="N",
                             params=dataclasses.replace(params, band=band))
                for i, (reads, band) in enumerate(zip(sets, bands))] \
            + [ConsensusJob(["done"], result="ACGT")]

    obs = K.RunObserver()
    monkeypatch.setattr(K, "OBSERVER", obs)
    got = resolve_consensus_jobs(jobs(), backend="device", device="cpu")
    monkeypatch.setattr(K, "OBSERVER", None)
    assert got[-1] == ("ACGT", ["done"])
    assert got == resolve_consensus_jobs(jobs(), backend="native")
    grouped = _grouped_consensi(
        sets, bands, params,
        lambda ss, p: K.poa_consensus_batch(ss, p, device="cpu"))
    assert [c for c, _names in got[:-1]] == [decode(g) for g in grouped]
    assert len(obs.chunks) == obs.rounds == max(len(r) for r in sets) - 1


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


# a forward launch of the chunk's few problems, a block and an SM each, or
# of the chunk repeated past the card's SM count, where several problems'
# blocks share an SM
LAUNCHES = ("few", "wide")


def _assert_kernels_match_plain(arrays, params, W, l_cap, device,
                                launch="few"):
    """Forward and walk kernels against their plain versions on the
    card: the matrices' rows 0..nn[b] (`clear_rows_past`), buf[:ks] and
    ks. A "wide" launch holds the chunk's problems repeated until they
    outnumber the SMs, and each copy is held to the plain version of its
    problem."""
    B = len(arrays[2])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    copies = 1 if launch == "few" else sms // B + 1
    base, preds, nn, ends, qq, ql, band = K.problems_from_numpy(
        *(np.concatenate([a] * copies) for a in arrays), device)
    before = (K.POA_FWD_LAUNCHES.count, K.POA_WALK_LAUNCHES.count)
    mats = K.poa_forward(base, preds, nn, qq, ql, params, W, band)
    buf, ks = K.poa_walk(nn, ends, ql, mats, l_cap)
    torch.cuda.synchronize()
    assert (K.POA_FWD_LAUNCHES.count, K.POA_WALK_LAUNCHES.count) == \
        (before[0] + 1, before[1] + 1)
    one = (base[:B], preds[:B], nn[:B], qq[:B], ql[:B])
    want = K.poa_forward_plain(*one, params, W, band[:B])
    for g, w in zip(K.clear_rows_past(mats, nn), want):
        assert torch.equal(g, w.repeat(copies, *[1] * (w.dim() - 1)))
    want_buf, want_ks = K.poa_walk_plain(nn[:B], ends[:B], ql[:B], want,
                                         l_cap)
    assert torch.equal(ks, want_ks.repeat(copies))
    for b, k in enumerate(want_ks.tolist() * copies):
        assert torch.equal(buf[b, :k], want_buf[b % B, :k])


@pytest.mark.cuda
@pytest.mark.parametrize("launch", LAUNCHES)
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("seed,make", [(42, _rand_sets), (5, _indel_sets)])
def test_cuda_kernels_match_plain(cuda_device, seed, make, adaptive, launch):
    params = PoaParams(band=20, adaptive=adaptive)
    arrays, W, l_cap = _chunk_arrays(make(seed), params, 2)
    _assert_kernels_match_plain(arrays, params, W, l_cap, cuda_device,
                                launch)


@pytest.mark.cuda
@pytest.mark.parametrize("launch", LAUNCHES)
def test_cuda_kernels_long_back_edge(cuda_device, launch):
    """A predecessor over 320 rows back, at W = 1024: four tiles a row."""
    params = PoaParams(band=LONG_BAND, adaptive=True)
    arrays, W, l_cap = _chunk_arrays([_long_insertion_set(21)], params, 3)
    assert W == 1024
    _assert_kernels_match_plain(arrays, params, W, l_cap, cuda_device,
                                launch)


@pytest.mark.cuda
@pytest.mark.parametrize("launch", LAUNCHES)
@pytest.mark.parametrize("adaptive", [True, False])
def test_cuda_kernels_mixed_bands(cuda_device, adaptive, launch):
    """The mixed-band chunk on the card: kernels == plain, and every
    problem's matrices are those of a launch with its band alone."""
    arrays, W, l_cap, params = _mixed_band_chunk(31, adaptive)
    _assert_kernels_match_plain(arrays, params, W, l_cap, cuda_device,
                                launch)
    base, preds, nn, _e, qq, ql, band = K.problems_from_numpy(*arrays,
                                                              cuda_device)
    mixed = K.clear_rows_past(
        K.poa_forward(base, preds, nn, qq, ql, params, W, band), nn)
    for p_band, idx, sub in _one_band_at_a_time(arrays, params):
        base, preds, nn, _e, qq, ql, _b = K.problems_from_numpy(*sub,
                                                                cuda_device)
        alone = K.clear_rows_past(
            K.poa_forward(base, preds, nn, qq, ql, p_band, W), nn)
        for m, a in zip(mixed, alone):
            assert torch.equal(m[torch.from_numpy(idx).to(cuda_device)], a)


@pytest.mark.cuda
@pytest.mark.parametrize("launch", LAUNCHES)
def test_cuda_kernels_long_predecessor_lists(cuda_device, launch):
    """64-entry predecessor lists (two parts of 32 lanes), 40 of them in
    use, most beyond the shared-memory ring."""
    arrays, W, l_cap = _fan_in_chunk(3)
    _assert_kernels_match_plain(arrays, PoaParams(band=20, adaptive=True),
                                W, l_cap, cuda_device, launch)


# an insertion of 40 bases under a band of 60: W stays 256, where the
# forward keeps 16 rows in shared memory, and the walk's tile holds 64
RING_SET = dict(length=700, insert=40)
RING_BAND = 60


@pytest.mark.cuda
@pytest.mark.parametrize("launch", LAUNCHES)
@pytest.mark.parametrize("round_k", [2, 3, 4])
def test_cuda_forward_ring_hit_and_miss_in_one_problem(cuda_device, round_k,
                                                       launch):
    """Predecessors the row before (the shared-memory ring) and more than
    16 rows back (the state scratch) in one problem at W = 256; the walk
    crosses the 40 inserted nodes in one diagonal step (a branch out of
    its tile) or threads the 40 bases (rounds 3 and 2, 4)."""
    params = PoaParams(band=RING_BAND, adaptive=True)
    arrays, W, l_cap = _chunk_arrays([_long_insertion_set(21, **RING_SET)],
                                     params, round_k)
    assert W == 256
    _base, preds, nn, *_ = arrays
    rows = np.arange(1, int(nn[0]) + 1)[:, None]
    back = np.where(preds[0, :nn[0]] >= 1, rows - preds[0, :nn[0]], 0)
    assert (back == 1).any() and back.max() > 16
    _assert_kernels_match_plain(arrays, params, W, l_cap, cuda_device,
                                launch)


@pytest.mark.cuda
@pytest.mark.parametrize("launch", LAUNCHES)
@pytest.mark.parametrize("adaptive", [True, False])
def test_cuda_forward_w512_in_tiles(cuda_device, adaptive, launch):
    """Queries of about 400-450 bases under a band of 140: W = 512, a row
    in two tiles of 256, the insertion scans carried from one to the
    next."""
    params = PoaParams(band=140, adaptive=adaptive)
    arrays, W, l_cap = _chunk_arrays(
        _rand_sets(8, n_sets=2, len_lo=380, len_hi=460), params, 2)
    assert W == 512
    _assert_kernels_match_plain(arrays, params, W, l_cap, cuda_device,
                                launch)


@pytest.mark.cuda
@pytest.mark.parametrize("launch", LAUNCHES)
def test_cuda_forward_reads_stale_padding_as_plain(cuda_device, launch):
    """Query columns past ql, and rows past nn, hold whatever a reused
    staging buffer left there, any int32: the kernel reads the query's as
    the plain forward does (values that agree with a base code in their
    low byte, and negative ones, among them) and the rows' not at all."""
    params = PoaParams(band=20, adaptive=True)
    arrays, W, l_cap = _chunk_arrays(_rand_sets(42), params, 2)
    base, preds, nn, ends, qq, ql, band = (a.copy() for a in arrays)
    rng = np.random.default_rng(7)
    for b, (n, q) in enumerate(zip(nn.tolist(), ql.tolist())):
        stale = rng.integers(0, 4, l_cap - q) + 256 * rng.integers(
            -1000, 1000, l_cap - q)
        qq[b, q:] = stale
        base[b, n:] = rng.integers(-1 << 20, 1 << 20, base.shape[1] - n)
        preds[b, n:] = rng.integers(-1 << 20, 1 << 20, preds[b, n:].shape)
    assert ((qq >= 256) & (qq % 256 < 4)).any() and (qq < 0).any()
    _assert_kernels_match_plain((base, preds, nn, ends, qq, ql, band),
                                params, W, l_cap, cuda_device, launch)


# stored columns where one warp's columns end and the next one's begin:
# a warp takes 64 columns of a tile at 4 warps a problem (32 at the 8 that
# tools/poa_kernel_phases.py also builds)
WARP_EDGES = (31, 32, 63, 64, 127, 128, 191, 192)


def _chain_problem(graph, query, band):
    """One hand-made problem: the graph a chain of `graph`'s bases (each
    rank's one predecessor the rank before), `query` against it, W 256."""
    n, qlen = len(graph), len(query)
    n_cap, l_cap = K._rank_cap(n), K._pow2_at_least(qlen)
    base = np.zeros((1, n_cap), np.int32)
    preds = np.full((1, n_cap, 4), -1, np.int32)
    ends = np.zeros((1, n_cap), bool)
    qq = np.zeros((1, l_cap), np.int32)
    base[0, :n] = graph
    preds[0, :n, 0] = np.arange(n)
    ends[0, n - 1] = True
    qq[0, :qlen] = query
    arrays = (base, preds, np.array([n], np.int32), ends, qq,
              np.array([qlen], np.int32), np.array([band], np.int32))
    return arrays, 256, l_cap


def _first_max_ties():
    """A chain of 230 A against 10 C then 240 A, gaps free and mismatches
    0 (match 1): row r holds r at every in-band column from 10 + r on and
    less before it, so its first maximum, which centres the next row's
    band of 40, is column 10 + r with ties to its right: the ties sweep
    across every warp edge."""
    params = PoaParams(match=1, mismatch=0, gap_open=0, gap_extend=0,
                       gap_open2=0, gap_extend2=0, band=40, adaptive=True)
    query = np.r_[np.ones(10, np.int32), np.zeros(240, np.int32)]
    return _chain_problem(np.zeros(230, np.int32), query, 40) + (params,)


def _insertions_from_warp_edges(seed=4):
    """A chain of 200 random bases against the same bases with 20 others
    inserted after the 63rd and 20 after the 108th (query column 128):
    the two insertion runs open at a warp edge and run into the next
    warps."""
    rng = np.random.default_rng(seed)
    graph = rng.integers(0, 4, 200).astype(np.int32)
    junk = rng.integers(0, 4, (2, 20)).astype(np.int32)
    query = np.r_[graph[:63], junk[0], graph[63:108], junk[1], graph[108:]]
    params = PoaParams(band=120, adaptive=True)
    return _chain_problem(graph, query, 120) + (params,)


@pytest.mark.parametrize("make", [_first_max_ties,
                                  _insertions_from_warp_edges])
def test_forward_warp_edge_problems_hit_the_edges(make):
    """The hand-made problems of the warp-edge case do what it needs, by
    the plain forward: insertions whose origin lies on a warp edge and
    whose cell lies in a later warp, or first maxima at the lowest of the
    tied columns (the band's right edge, column 50 + r, reaches the
    query's end, 250, from row 200 on, where H is r)."""
    arrays, W, _l, params = make()
    hpack, opack, _d1, _d2, offs, endcol = _port_mats(arrays, params, W)[0]
    n = int(arrays[2][0])
    if make is _first_max_ties:
        rows = torch.arange(1, n + 1)
        assert (offs[0] == 0).all()
        assert torch.equal(endcol[0, 1:n + 1],
                           torch.where(rows >= 200, rows, NEG).int())
        return
    op = hpack[0, 1:n + 1] & 7
    origin = opack[0, 1:n + 1] & 0xFFFF
    col = torch.arange(W)[None, :] + offs[0, 1:n + 1, None]
    from_edge = (op == 1) & torch.isin(origin, torch.tensor(WARP_EDGES)) \
        & (col // 32 > origin // 32)
    assert set(origin[from_edge].tolist()) >= {63, 127}


@pytest.mark.cuda
@pytest.mark.parametrize("launch", LAUNCHES)
@pytest.mark.parametrize("make", [_first_max_ties,
                                  _insertions_from_warp_edges])
def test_cuda_forward_warp_edges(cuda_device, make, launch):
    """First maxima tied across warp edges, and insertions opened at a
    warp edge, on both launches."""
    arrays, W, l_cap, params = make()
    _assert_kernels_match_plain(arrays, params, W, l_cap, cuda_device,
                                launch)


@pytest.mark.cuda
@pytest.mark.parametrize("round_k", [2, 4])
def test_cuda_walk_leaves_its_tile(cuda_device, round_k):
    """A path that mixes runs of diagonal steps with deletions, insertion
    runs and a branch to a predecessor far outside the staged tile (over
    320 rows back): every way out of the walk kernel's tile."""
    params = PoaParams(band=LONG_BAND, adaptive=True)
    reads = _long_insertion_set(21)
    # the query: a read without the 320-base insertion, with a 5-base
    # deletion and a 7-base insertion of its own
    q = reads[round_k]
    q = np.concatenate([q[:100], q[105:200], np.array([0, 1, 2, 3, 0, 1, 2],
                                                      np.uint8), q[200:]])
    reads = reads[:round_k] + [q]
    arrays, W, l_cap = _chunk_arrays([reads], params, round_k)
    base, preds, nn, ends, qq, ql, band = K.problems_from_numpy(*arrays,
                                                                cuda_device)
    want = K.poa_forward_plain(base, preds, nn, qq, ql, params, W, band)
    want_buf, want_ks = K.poa_walk_plain(nn, ends, ql, want, l_cap)
    steps = want_buf[0, :int(want_ks[0])].cpu().numpy()
    diag = steps[(steps[:, 0] >= 0) & (steps[:, 1] >= 0), 1]
    assert (steps[:, 0] < 0).sum() >= 5            # deleted nodes
    assert (steps[:, 1] < 0).sum() >= 7            # inserted bases
    assert (diag[:-1] - diag[1:]).max() > 300      # the far branch
    _assert_kernels_match_plain(arrays, params, W, l_cap, cuda_device)


@pytest.mark.cuda
def test_cuda_walk_decodes_tier2_origins_as_unsigned(cuda_device):
    """The hand-made matrices of the CPU test: two runs of inserted bases
    (10 and 39,989 steps) written by all lanes at once."""
    (nn, ends, ql, mats, l_cap), (qlen, origin) = _tier2_origin_problem(
        cuda_device)
    buf, ks = K.poa_walk(nn, ends, ql, mats, l_cap)
    _assert_tier2_origin_steps(buf[0, :int(ks[0])].cpu().numpy(), qlen,
                               origin)


@pytest.mark.cuda
def test_cuda_consensus_matches_native(cuda_device):
    sets = _rand_sets(42) + _indel_sets(5)
    params = PoaParams(band=20, adaptive=True)
    got = K.poa_consensus_batch(sets, params, device=cuda_device)
    for reads, g in zip(sets, got):
        assert g.tolist() == native_poa_consensus(reads, params).tolist()
