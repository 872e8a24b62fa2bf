"""Module D's round loop staged a chunk at a time: `stage_graphs` and
`apply_graphs` (one native call each, on threads) against each graph's
Python `PoaGraph` twin (`graph_arrays`, `PoaGraph.apply_path`),
`poa_consensus_batch` on buffers that hold stale values from round to
round, and the loop on native and on Python graphs side by side.

The graphs are NativePoaGraphs grown along the native engine's paths,
each beside its twin. This file imports no jax: its `cuda` cases run on
a card with --noconftest.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from mandalorion_tpu_torch.native import (load_native, native_poa_align,
                                          native_poa_consensus)
from mandalorion_tpu_torch.poa import kernels as K
from mandalorion_tpu_torch.poa.graph import PoaGraph, PoaParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = PoaParams(band=16, adaptive=True)
THREADS = (1, 2, 3, 8, 1000)
POISON_I32, POISON_U8 = 0x5A5A5A5A, 0x5A


@pytest.fixture(autouse=True)
def _native():
    if load_native() is None:
        pytest.skip("native library unavailable")


def _noisy(rng, template, subs=3):
    read = template.copy()
    at = rng.choice(len(read), subs, replace=False)
    read[at] = (read[at] + 1) % 4
    return read


def _sets(case, seed=0):
    """Read sets a case stages: the graphs are read 0 with the rest
    threaded in, the query is one more read."""
    rng = np.random.default_rng(seed)

    def one(length, n_reads):
        t = rng.integers(0, 4, length).astype(np.uint8)
        return [_noisy(rng, t) for _ in range(n_reads)]

    if case == "none":
        return []
    if case == "one":
        return [one(90, 4)]
    if case == "sizes":  # graphs of 30 to 700 nodes side by side
        return [one(30, 2), one(400, 5), one(60, 3), one(650, 4),
                one(45, 2)]
    # queries longer than the tallest graph
    sets = [one(50, 3), one(80, 2), one(70, 4)]
    for s in sets:
        s[-1] = np.concatenate([s[-1], rng.integers(0, 4, 150).astype(
            np.uint8)])
    return sets


def _grown(reads):
    """NativePoaGraph of reads[0] with reads[1:] threaded in along the
    native engine's paths by `stage_graphs` and `apply_graphs` on its one
    handle, and its PoaGraph twin grown along the same paths (the twin's
    topo order resolves the ranks)."""
    g, twin = K.NativePoaGraph(reads[0]), PoaGraph(reads[0])
    h = np.array([g._h], np.uintp)
    for q in reads[1:]:
        (n,), (p,) = K.graph_sizes(h)
        q_start, q_len = np.zeros(1, np.int64), np.array([len(q)])
        K.stage_graphs(h, q, q_start, q_len, np.zeros(1, np.int32),
                       _poisoned_chunk(1, (n, p, len(q))))
        rank = {v: r for r, v in enumerate(twin.topo_order())}
        path = native_poa_align(twin, q, PARAMS)
        steps = np.array([(qi, -1 if v is None else rank[v])
                          for qi, v in path][::-1], np.int32)
        K.apply_graphs(h, q, q_start, steps.reshape(1, -1, 2),
                       np.array([len(steps)], np.int32))
        twin.apply_path(q, path)
    assert g.consensus().tolist() == twin.consensus().tolist()
    return g, twin


def _problems(sets):
    """(graphs, twins, handles, codes, q_start, q_len, bands, caps) of a
    case: graph i is sets[i][:-1] grown, beside its PoaGraph twin, its
    query sets[i][-1]."""
    grown = [_grown(s[:-1]) for s in sets]
    graphs, twins = [g for g, _ in grown], [t for _, t in grown]
    queries = [s[-1] for s in sets]
    q_len = np.array([len(q) for q in queries], np.int64)
    codes = np.concatenate(queries or [np.zeros(0, np.uint8)])
    q_start = np.cumsum(q_len) - q_len
    bands = np.arange(16, 16 + len(sets), dtype=np.int32)
    handles = np.array([g._h for g in graphs], np.uintp)
    nodes, maxp = K.graph_sizes(handles)
    caps = (K._rank_cap(int(nodes.max(initial=1))),
            K._pow2_at_least(int(maxp.max(initial=1)), floor=4),
            K._pow2_at_least(int(q_len.max(initial=1))))
    return graphs, twins, handles, codes, q_start, q_len, bands, caps


def _twin_fill(twins, queries, bands, caps):
    """What the staging writes, made of the PoaGraph twins by
    `graph_arrays` (padding past nn and ql as graph_arrays pads)."""
    n_cap, p_cap, l_cap = caps
    B = len(twins)
    base = np.zeros((B, n_cap), np.int32)
    preds = np.full((B, n_cap, p_cap), -1, np.int32)
    ends = np.zeros((B, n_cap), np.uint8)
    nn, qq = np.zeros(B, np.int32), np.zeros((B, l_cap), np.int32)
    for i, twin in enumerate(twins):
        base[i], preds[i], ends[i], order = K.graph_arrays(twin, n_cap,
                                                           p_cap)
        nn[i] = len(order)
        qq[i, :len(queries[i])] = queries[i]
    ql = np.array([len(q) for q in queries], np.int32)
    return base, preds, nn, ends, qq, ql, np.asarray(bands, np.int32)


def _poisoned_chunk(B, caps):
    staging = K.ChunkStaging(torch.device("cpu"))
    arrays = staging.chunk(B, *caps)
    staging.host_in.numpy().view(np.uint8)[:] = POISON_U8
    return arrays


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", ["none", "one", "sizes", "long_queries"])
def test_batched_fill_writes_what_fill_arrays_writes(case, threads):
    """Rows 0..nn-1 of base, preds and ends, nn, qq[:ql], ql and band as
    `graph_arrays` makes them of the PoaGraph twins; nothing past nn or
    ql is written; the call ran on min(threads, problems) threads."""
    sets = _sets(case)
    _graphs, twins, handles, codes, q_start, q_len, bands, caps = \
        _problems(sets)
    queries = [s[-1] for s in sets]
    want = _twin_fill(twins, queries, bands, caps)
    got = _poisoned_chunk(len(sets), caps)
    with K.StagePool(threads) as pool:
        used = K.stage_graphs(handles, codes, q_start, q_len, bands, got,
                              pool)
    assert used == max(1, min(threads, len(sets)))
    base, preds, nn, ends, qq, ql, band = got
    assert nn.tolist() == want[2].tolist()
    assert ql.tolist() == want[5].tolist() == q_len.tolist()
    assert band.tolist() == bands.tolist()
    if case == "long_queries":
        assert q_len.max() > nn.max()
    for i, (n, m) in enumerate(zip(nn, ql)):
        assert np.array_equal(base[i, :n], want[0][i, :n])
        assert np.array_equal(preds[i, :n], want[1][i, :n])
        assert np.array_equal(ends[i, :n], want[3][i, :n])
        assert np.array_equal(qq[i, :m], want[4][i, :m])
        assert (base[i, n:] == POISON_I32).all()
        assert (preds[i, n:] == POISON_I32).all()
        assert (ends[i, n:] == POISON_U8).all()
        assert (qq[i, m:] == POISON_I32).all()


def test_batched_fill_refuses_caps_too_small():
    sets = _sets("sizes")
    _graphs, _twins, handles, codes, q_start, q_len, bands, caps = \
        _problems(sets)
    n_cap, p_cap, l_cap = caps
    for small in ((n_cap // 4, p_cap, l_cap), (n_cap, p_cap, 64)):
        with K.StagePool(3) as pool, pytest.raises(ValueError,
                                                   match="caps too small"):
            K.stage_graphs(handles, codes, q_start, q_len, bands,
                           _poisoned_chunk(len(sets), small), pool)


def _threads_alive() -> int:
    return len(os.listdir("/proc/self/task"))


def test_stage_pool_threads_live_only_while_it_is_open(monkeypatch):
    """A pool starts its threads as calls first need them, min(threads,
    problems) a call with the caller's, and joins them when closed; the
    round loop closes its pool before it returns."""
    sets = _sets("sizes")
    _graphs, _twins, handles, codes, q_start, q_len, bands, caps = \
        _problems(sets)
    before = _threads_alive()
    with K.StagePool(4) as pool:
        for n, want in ((2, 2), (5, 4), (1, 1), (3, 3)):
            used = K.stage_graphs(handles[:n], codes, q_start[:n],
                                  q_len[:n], bands[:n],
                                  _poisoned_chunk(n, caps), pool)
            assert used == want
        assert _threads_alive() == before + 3
    assert _threads_alive() == before
    made = []

    class Seen(K.StagePool):
        def __init__(self, threads):
            super().__init__(threads)
            made.append(self)

    monkeypatch.setattr(K, "StagePool", Seen)
    K.poa_consensus_batch([s[:2] for s in _sets("long_queries")], PARAMS,
                          "cpu", threads=4)
    [pool] = made
    assert pool._h is None


@pytest.fixture(scope="module")
def walked():
    """Each walk's outputs for the `sizes` and `long_queries` graphs
    (the plain versions on the CPU): {(case, walk): (rows, counts)}."""
    out = {}
    for case in ("sizes", "long_queries"):
        sets = _sets(case)
        _graphs, _twins, handles, codes, q_start, q_len, bands, caps = \
            _problems(sets)
        arrays = _poisoned_chunk(len(sets), caps)
        K.stage_graphs(handles, codes, q_start, q_len, bands, arrays)
        W = max(K._item_width(int(n), int(m), int(b), caps[2],
                               PARAMS.adaptive)
                for n, m, b in zip(arrays[2], q_len, bands))
        for walk in K.WALKS:
            out[case, walk] = K.dispatch_chunk(
                *arrays, W, caps[2], PARAMS, torch.device("cpu"),
                walk=walk)
    return out


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("walk", K.WALKS)
@pytest.mark.parametrize("case", ["sizes", "long_queries"])
def test_batched_apply_gives_the_per_graph_graphs(walked, case, walk,
                                                  threads):
    """The same walk outputs applied by one call on threads and, by
    PoaGraph.apply_path of the expanded walk, to the PoaGraph twins: the
    same graphs (arrays and consensus)."""
    rows, counts = walked[case, walk]
    sets = _sets(case)
    queries = [s[-1] for s in sets]
    graphs, twins, handles, codes, q_start, q_len, bands, caps = \
        _problems(sets)
    for twin, q, r, k in zip(twins, queries, rows, counts):
        steps = (K.expand_walk_records(r, int(k)) if walk == "sweep"
                 else r[:k])
        order = twin.topo_order()
        twin.apply_path(q, [(int(qi), order[rank] if rank >= 0 else None)
                            for qi, rank in steps[::-1]])
    with K.StagePool(threads) as pool:
        K.stage_graphs(handles, codes, q_start, q_len, bands,
                       _poisoned_chunk(len(sets), caps), pool)
        used = K.apply_graphs(handles, codes, q_start, rows, counts, walk,
                              pool)
    assert used == min(threads, len(sets))
    assert [g.consensus().tolist() for g in graphs] == \
        [g.consensus().tolist() for g in twins]
    nodes, maxp = K.graph_sizes(handles)
    grown = (K._rank_cap(int(nodes.max())),
             K._pow2_at_least(int(maxp.max()), floor=4), caps[2])
    got = _poisoned_chunk(len(sets), grown)
    K.stage_graphs(handles, codes, q_start, q_len, bands, got)
    want = _twin_fill(twins, queries, bands, grown)
    assert got[2].tolist() == want[2].tolist()
    for i, n in enumerate(got[2]):
        for a in (0, 1, 3):  # base, preds, ends
            assert np.array_equal(got[a][i, :n], want[a][i, :n])


def _round_sets(seed=3):
    """Sets whose rounds shrink while the graphs grow: one set of
    unrelated reads (its graph grows by most of a read a round) beside
    two short sets that end after one and two rounds."""
    rng = np.random.default_rng(seed)
    sets = []
    for length, n_reads in ((70, 2), (90, 3)):
        t = rng.integers(0, 4, length).astype(np.uint8)
        sets.append([_noisy(rng, t) for _ in range(n_reads)])
    sets.append([rng.integers(0, 4, 200).astype(np.uint8) for _ in range(6)])
    return sets


class _Poisoned(K.ChunkStaging):
    """ChunkStaging whose buffers are poisoned (seeded random bytes)
    before every chunk is staged and every walk output fetched."""

    made: list = []

    def __init__(self, device):
        super().__init__(device)
        self.rng = np.random.default_rng(7)
        self.shapes: list = []
        _Poisoned.made.append(self)

    def _poison(self, buf):
        if buf is not None:
            raw = buf.cpu().numpy().view(np.uint8)
            raw[:] = self.rng.integers(0, 256, raw.size, dtype=np.uint8)
            if buf.device.type != "cpu":
                buf.copy_(torch.from_numpy(raw.view(np.int32)))

    def chunk(self, B, n_cap, p_cap, l_cap):
        arrays = super().chunk(B, n_cap, p_cap, l_cap)
        self.shapes.append((B, n_cap))
        for buf in (self.host_in, self.host_out, self.dev_in):
            self._poison(buf)
        return arrays

    def fetch(self, rows, counts):
        self._poison(self.host_out)
        return super().fetch(rows, counts)


@pytest.fixture(scope="module")
def fresh():
    """poa_consensus_batch over `_round_sets` on the CPU, buffers as they
    come, one thread: {walk: consensi}."""
    return {walk: K.poa_consensus_batch(_round_sets(), PARAMS, "cpu", walk)
            for walk in K.WALKS}


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(name)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("walk", K.WALKS)
@pytest.mark.parametrize("threads", [1, 3])
def test_poisoned_buffers_give_the_fresh_consensi(monkeypatch, fresh,
                                                  device, walk, threads):
    """Buffers filled with random bytes before every round's staging and
    every fetch, everywhere past what the staging writes: the consensi of
    a run on fresh buffers and of the native engine. The rounds shrink
    while the row cap grows, so the buffers grow."""
    device = _device(device)
    monkeypatch.setattr(K, "ChunkStaging", _Poisoned)
    _Poisoned.made.clear()
    sets = _round_sets()
    got = K.poa_consensus_batch(sets, PARAMS, device, walk, threads=threads)
    assert [g.tolist() for g in got] == [g.tolist() for g in fresh[walk]]
    assert [g.tolist() for g in got] == [
        native_poa_consensus(s, PARAMS).tolist() for s in sets]
    [staging] = _Poisoned.made
    shapes = staging.shapes
    assert any(b2 < b1 and n2 > n1 for (b1, n1), (b2, n2)
               in zip(shapes, shapes[1:])), shapes
    assert staging.grows >= 2


@pytest.mark.parametrize("walk", K.WALKS)
@pytest.mark.parametrize("shape", ["rounds", "widths"])
def test_native_and_python_graphs_run_the_same_rounds(monkeypatch, shape,
                                                      walk):
    """poa_consensus_batch on NativePoaGraphs and on Python PoaGraphs (no
    native library) through the one round loop: the same consensi, and a
    RunObserver sees the same rounds and chunks. `rounds` shrink while
    the graphs grow; `widths` puts graphs of 30 to 700 nodes at two bands
    into two width classes a round."""
    if shape == "rounds":
        sets, bands = _round_sets(), None
    else:
        sets = [s[:-1] for s in _sets("sizes")]
        bands = [16, 200, 16, 200, 16]
    runs = []
    for native in (True, False):
        if not native:
            monkeypatch.setattr(K, "load_native", lambda: None)
        obs = K.RunObserver()
        monkeypatch.setattr(K, "OBSERVER", obs)
        got = K.poa_consensus_batch(sets, PARAMS, "cpu", walk, bands)
        runs.append(([g.tolist() for g in got], obs.rounds, obs.chunks))
    assert runs[0] == runs[1]
    widths = {W for _b, _n, W, _r, _k in runs[0][2]}
    assert len(widths) == (1 if shape == "rounds" else 2), widths


def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench_torch", os.path.join(ROOT, "bench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod    # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("n_iso", [64, 264])
def test_cuda_staged_rounds_match_native_engine(n_iso, threads):
    """The bench's poa_batch read sets (64 and 264 isoforms of 12 reads
    of 800 bases) through the card's round loop at 1 and 8 staging
    threads: the native engine's consensi."""
    device = _device("cuda")
    bench = _bench()
    seq_sets, _truths = bench.poa_batch_workload(n_iso, **bench.POA_BATCH)
    params = PoaParams()
    got = K.poa_consensus_batch(seq_sets, params, device, threads=threads)
    want = bench.native_batch(seq_sets, params)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
