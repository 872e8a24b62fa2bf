"""The port without its native library (MANDO_TPU_NO_NATIVE) against
mandalorion_tpu without its own.

- Every numpy twin the switch brings into the port equals the
  reference's function exactly, and the port's native function it
  stands in for.
- The segment-list chain entry (`chain_kernel.chain_batch_segments`,
  its plain version on the CPU) equals the reference's `chain_batch_jax`
  on JAX's CPU: chains and float32 scores.
- `mando-tpu-torch --device cpu` and `mando-tpu` (JAX on the CPU, the
  reference's 'pallas' DP through 'rowscan' as in
  tests/test_torch_routes.py), each run in a process of its own with
  MANDO_TPU_NO_NATIVE=1, write the same six artifacts on the host route,
  the default device route and chain native / dp device, and those are
  the port's artifacts without the switch.
- The switch's edges: with it the library is never mapped; without it a
  failed build raises; the native consensus backend under it raises.

Every comparison is exact. The switch is read once a process: the runs
set it in a child process, and in-process tests stand for it with the
`no_native` fixture, which leaves both packages' libraries unloaded as
the switch does (`_LIB` None, `_TRIED` set).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mandalorion_tpu_torch import native as port_native
from mandalorion_tpu_torch.align import chain_kernel, encode as port_encode
from mandalorion_tpu_torch.align import index as port_index
from mandalorion_tpu_torch.align.chain import Segment as PortSegment
from mandalorion_tpu_torch.config import AlignConfig
from mandalorion_tpu_torch.io.fastx import fastx_to_dict, read_fastx
from mandalorion_tpu_torch.pipeline import cli
from mandalorion_tpu_torch.utils.simulate import make_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = ("Isoforms.filtered.fasta", "Isoforms.filtered.clean.psl",
             "Isoforms.filtered.clean.gtf", "Isoforms.filtered.clean.quant",
             "Isoforms.filtered.clean.tpm",
             os.path.join("tmp", "reads2isoforms.txt"))
KW = dict(min_intron=30, max_intron=400_000)


def _unload(monkeypatch):
    """Both packages as MANDO_TPU_NO_NATIVE leaves them: no library."""
    import mandalorion_tpu.native as ref_native
    for mod in (ref_native, port_native):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_TRIED", True)


@pytest.fixture
def no_native(monkeypatch):
    _unload(monkeypatch)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """tests/test_torch_routes.py's dataset."""
    d = str(tmp_path_factory.mktemp("no_native"))
    make_dataset(d, n_genes=3, n_reads_per_gene=10, genome_len=90_000,
                 seed=0)
    inputs = [os.path.join(d, f) for f in ("genome.fasta", "ann.gtf",
                                           "reads.fasta")]
    reads = [(nm, sq) for nm, sq, _q in read_fastx(inputs[2])]
    return d, inputs, fastx_to_dict(inputs[0]), reads


def _codes(rng, n, n_rate=0.0):
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < n_rate] = 4
    return codes


# ------------------------------------------------ minimizers and index

@pytest.mark.parametrize("n, k, w, n_rate", [
    (0, 15, 5, 0.0), (14, 15, 5, 0.0), (17, 15, 5, 0.0), (19, 15, 5, 0.3),
    (5000, 15, 5, 0.0), (5000, 13, 5, 0.002), (3000, 15, 10, 0.01),
    (2000, 11, 3, 0.05), (40, 15, 5, 1.0)])
def test_minimizers_numpy_match_reference_and_native(n, k, w, n_rate):
    from mandalorion_tpu.align import encode as ref_encode
    codes = _codes(np.random.default_rng(n + k + w), n, n_rate)
    got_h, got_v = port_encode.kmer_hashes(codes, k)
    want_h, want_v = ref_encode.kmer_hashes(codes, k)
    assert np.array_equal(got_h, want_h) and np.array_equal(got_v, want_v)
    got = port_encode._minimizers_numpy(codes, k, w)
    for want in (ref_encode._minimizers_numpy(codes, k, w),
                 port_native.native_minimizers(codes, k, w)):
        assert all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(got, want))


def _genome(rng):
    """Three chromosomes with N runs and two tandem repeats (200-base
    units, one 150 times, one 40 times): a read over both seeds past
    ANCHOR_BUDGET, and the budget drops the 150-copy seeds."""
    unit = _codes(rng, 400)
    chroms = {"chr1": _codes(rng, 70_000, 0.001),
              "chr2": np.concatenate([
                  _codes(rng, 5000), np.tile(unit[:200], 150),
                  _codes(rng, 3000), np.tile(unit[200:], 40),
                  _codes(rng, 5000)]),
              "chr3": _codes(rng, 90)}
    chroms["chr1"][30_000:30_500] = 4
    return {name: "".join("ACGTN"[c] for c in codes)
            for name, codes in chroms.items()}, unit


def _index_arrays(idx):
    return [idx.seq_codes, idx.chrom_offsets, idx.chrom_sizes,
            idx.sorted_hashes, idx.sorted_positions, idx.bucket_lo]


@pytest.mark.parametrize("chunk", [1 << 24, 7_001])
def test_build_index_numpy_matches_reference_and_native(chunk):
    from mandalorion_tpu.align import index as ref_index
    genome, _unit = _genome(np.random.default_rng(3))
    native = port_index.build_index(genome, 15, 5, chunk=chunk)
    args = (native.seq_codes, native.chrom_names, native.chrom_offsets,
            native.chrom_sizes, 15, 5, chunk, native.bucket_bits)
    got = port_index._build_index_numpy(*args)
    want = ref_index._build_index_numpy(*args)
    for other in (want, native):
        assert (got.kmer, got.window, got.chrom_names, got.bucket_bits) == \
            (other.kmer, other.window, other.chrom_names, other.bucket_bits)
        for a, b in zip(_index_arrays(got), _index_arrays(other)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.sorted_positions.dtype == np.uint32


def test_build_index_takes_the_numpy_twin_under_the_switch(no_native):
    genome, _unit = _genome(np.random.default_rng(3))
    got = port_index.build_index(genome, 15, 5)
    from mandalorion_tpu.align import index as ref_index
    want = ref_index.build_index(genome, 15, 5)
    assert got.bucket_bits == want.bucket_bits
    for a, b in zip(_index_arrays(got), _index_arrays(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_lookup_numpy_branch_matches_reference_and_native(monkeypatch):
    from mandalorion_tpu.align import index as ref_index
    rng = np.random.default_rng(4)
    genome, unit = _genome(rng)
    idx = port_index.build_index(genome, 15, 5)
    ref_idx = ref_index.GenomeIndex(**vars(idx))
    repeat_read = np.concatenate([np.tile(unit[:200], 6),
                                  np.tile(unit[200:], 6), _codes(rng, 300)])
    plain_read = idx.seq_codes[1000:3000].copy()
    queries = [repeat_read, plain_read, _codes(rng, 500), _codes(rng, 0)]
    want_native = []
    for codes in queries:
        _pos, hashes = port_encode.minimizers(codes, 15, 5)
        want_native.append(idx.lookup(hashes, 500))
    assert len(want_native[0][0]) and len(want_native[1][0])
    _unload(monkeypatch)
    for codes, native in zip(queries, want_native):
        _pos, hashes = port_encode.minimizers(codes, 15, 5)
        got = idx.lookup(hashes, 500)
        for want in (ref_idx.lookup(hashes, 500), native):
            assert all(a.dtype == b.dtype and np.array_equal(a, b)
                       for a, b in zip(got, want))
    # the repeat read seeds past the budget, so the budget cut ran
    _pos, hashes = port_encode.minimizers(repeat_read, 15, 5)
    counts = (np.searchsorted(idx.sorted_hashes, hashes, "right")
              - np.searchsorted(idx.sorted_hashes, hashes, "left"))
    seeded = int(counts[counts <= 500].sum())
    assert seeded > port_index.ANCHOR_BUDGET
    assert 0 < len(want_native[0][0]) < seeded


# ------------------------------------------------------------------ DP

@pytest.mark.parametrize("scoring", [dict(), dict(end_bonus=12),
                                     dict(zdrop=15),
                                     dict(end_bonus=12, zdrop=40)],
                         ids=["default", "end_bonus", "zdrop", "both"])
def test_solve_dp_numpy_matches_reference_and_native(scoring):
    from mandalorion_tpu.align import extend as ref_extend
    from mandalorion_tpu.config import AlignConfig as RefAlignConfig
    from mandalorion_tpu_torch.align import extend
    from test_torch_dp import _random_problems
    rng = np.random.default_rng(len(scoring) + 10 * scoring.get("zdrop", 1))
    problems = []
    for mode in ("global", "extend_right", "extend_left"):
        problems += _random_problems(rng, 12, mode, max_len=80)
        problems += _random_problems(rng, 4, mode, max_len=80,
                                     similar=False)
    e = np.zeros(0, np.uint8)
    t = rng.integers(0, 4, 60).astype(np.uint8)
    problems += [extend.DpProblem(e, t, "global"),
                 extend.DpProblem(t, e, "global"),
                 extend.DpProblem(e, e, "global"),
                 extend.DpProblem(t[:20].copy(), t, "extend_right"),
                 extend.DpProblem(e, t, "extend_left")]
    cfg = AlignConfig(**scoring)
    got = extend.solve_dp_numpy(problems, cfg)
    ref_problems = [ref_extend.DpProblem(p.q, p.t, p.mode) for p in problems]
    want = ref_extend.solve_dp_numpy(ref_problems, RefAlignConfig(**scoring))
    native = extend.solve_dp_native(problems, cfg)
    for k, g in enumerate(got):
        for w in (want[k], native[k]):
            assert (g.ops, g.q_len, g.t_len) == (w.ops, w.q_len, w.t_len), k


def test_solve_dp_native_takes_numpy_under_the_switch(no_native):
    from mandalorion_tpu_torch.align import extend
    from test_torch_dp import _random_problems
    problems = _random_problems(np.random.default_rng(5), 6, "global")
    got = extend.solve_dp_native(problems, AlignConfig())
    want = extend.solve_dp_numpy(problems, AlignConfig())
    assert [(g.ops, g.q_len, g.t_len) for g in got] == \
        [(w.ops, w.q_len, w.t_len) for w in want]


# ------------------------------------------------------ cs, strand, PSL

def _cs_strings(rng, n):
    out = []
    for _ in range(n):
        parts = []
        for _p in range(int(rng.integers(1, 30))):
            op = rng.choice(["=", "+", "-", "*", "~"])
            if op == "*":
                parts.append("*" + "".join(rng.choice(list("acgt"), 2)))
            elif op == "~":
                parts.append(f"~gt{int(rng.integers(30, 5000))}ag")
            else:
                body = "".join(rng.choice(list("ACGT"),
                                          int(rng.integers(1, 40))))
                parts.append(op + (body if op == "=" else body.lower()))
        out.append("".join(parts))
    return out + [""]


def test_cs_index_numpy_matches_reference_and_native():
    from mandalorion_tpu.core import csparse as ref_csparse
    from mandalorion_tpu_torch.core import csparse
    for k, cs in enumerate(_cs_strings(np.random.default_rng(6), 40)):
        got = csparse._build_cs_index_numpy(cs, 1000 + k)
        want = ref_csparse._build_cs_index_numpy(cs, 1000 + k)
        native = port_native.native_parse_cs(cs, 1000 + k)
        for other in ((want.status, want.gp, want.advances, want.introns),
                      native):
            for a, b in zip((got.status, got.gp, got.advances), other[:3]):
                assert np.array_equal(a, b), cs
            assert got.introns == other[3], cs


def test_strand_numpy_matches_reference_and_native(data):
    from mandalorion_tpu.align.pairwise import (
        OrientationAligner as RefOrientation)
    from mandalorion_tpu_torch.align.encode import decode, revcomp_codes
    from mandalorion_tpu_torch.align.pairwise import OrientationAligner
    _d, _inputs, _genome, reads = data
    rng = np.random.default_rng(7)
    target = reads[0][1]
    queries = [seq for _n, seq in reads[:12]]
    queries += [decode(revcomp_codes(port_encode.encode(q)))
                for q in queries[:4]]
    queries += ["".join(rng.choice(list("ACGT"), 300)), "ACGT", ""]
    port = OrientationAligner(target)
    ref = RefOrientation(target)
    got = [port.strand_numpy(q) for q in queries]
    assert got == [ref.strand_numpy(q) for q in queries]
    assert got == [port.strand(q) for q in queries]
    assert {1, -1} <= set(got)


def test_runs_to_psl_numpy_matches_reference_and_native(data):
    from mandalorion_tpu.align.aligner import (
        SpliceAligner as RefAligner, _Pending as RefPending)
    from mandalorion_tpu.config import AlignConfig as RefAlignConfig
    from mandalorion_tpu_torch.align.aligner import SpliceAligner
    _d, _inputs, genome, reads = data
    port = SpliceAligner(genome, AlignConfig())
    ref = RefAligner(genome, RefAlignConfig())
    picks = port._native_picks(reads)
    pendings, problems = port._fill_picks(reads, picks, None)
    results = port._solve_dp(problems)
    modes = [p.mode for p in problems]
    cases = [(pend, port._build_runs(pend, results, modes))
             for pend in pendings]
    # hand-made runs: every op, adjacent M runs that merge into one block
    pend = pendings[0]
    q0, t0 = 10, int(port.index.chrom_offsets[pend.chrom_idx]) + 2000
    cases.append((pend, [("M", q0, t0, 30), ("M", q0 + 30, t0 + 30, 5),
                         ("I", q0 + 35, t0 + 35, 4),
                         ("M", q0 + 39, t0 + 35, 20),
                         ("D", q0 + 59, t0 + 55, 3),
                         ("M", q0 + 59, t0 + 58, 12),
                         ("N", q0 + 71, t0 + 70, 400),
                         ("M", q0 + 71, t0 + 470, 25)]))
    cases.append((pend, []))
    ops = set()
    for pend, runs in cases:
        got = port._runs_to_psl_numpy(pend, runs)
        want = ref._runs_to_psl_numpy(RefPending(**vars(pend)), runs)
        native = port._runs_to_psl(pend, runs)
        if not runs:
            assert got is None and want is None and native is None
            continue
        assert vars(got) == vars(want) == vars(native)
        ops |= {op for op, *_r in runs}
    assert ops == {"M", "I", "D", "N"}
    assert any("*" in vars(port._runs_to_psl_numpy(p, r))["cs"]
               for p, r in cases if r)


# ------------------------------------------------- segment-list chain

def _raw_candidate(rng, n, noise=0):
    """n collinear multi-anchor segments with indel and intron gaps and
    overlaps, then `noise` single-anchor ones, unprepared and unsorted."""
    segs = []
    q = int(rng.integers(0, 30))
    t = int(rng.integers(0, 5000))
    for _ in range(n):
        ln = int(rng.integers(15, 60))
        q = max(q + int(rng.integers(-10, 15)), 0)
        t = max(t + int(rng.choice([-10, 0, 3, 40, 300, 5000, 60000])), 0)
        segs.append((q, q + ln, t, t + ln, 3, int(rng.integers(15, ln + 1))))
        q, t = q + ln, t + ln
    for _ in range(noise):
        nq = int(rng.integers(0, max(q, 1)))
        tt = nq + int(rng.choice([0, 10_000, 900_000]))
        segs.append((nq, nq + 15, tt, tt + 15, 1, 0))
    rng.shuffle(segs)
    return segs


def _tied_candidate(rng, n):
    """Exons in up to three alternatives of equal length and cov, each
    up to three times over, at intron shifts of equal cost."""
    segs = []
    q, t = 0, int(rng.integers(0, 5000))
    while len(segs) < n:
        ln = int(rng.choice([20, 30]))
        for shift in (0, 300, 700)[:int(rng.integers(1, 4))]:
            segs += [(q, q + ln, t + shift, t + shift + ln, 3, ln)] * int(
                rng.integers(1, 4))
        q += ln + int(rng.choice([0, 0, 3]))
        t += ln + int(rng.choice([0, 5000, 5000, 6000]))
    return segs[:n]


def _chain_cases():
    rng = np.random.default_rng(8)
    cands = [_raw_candidate(rng, n) for n in (1, 2, 511, 512, 700)]
    cands += [_raw_candidate(rng, int(n), noise=int(rng.integers(0, 6)))
              for n in rng.integers(1, 40, 20)]
    cands += [_tied_candidate(rng, int(n)) for n in (2, 9, 64, 200)]
    cands += [[], _raw_candidate(rng, 530, noise=20), []]
    return cands


@pytest.mark.parametrize("part", ["all", "short", "empty"])
def test_chain_batch_segments_matches_chain_batch_jax(part):
    from mandalorion_tpu.align import chain_kernel as jc
    from mandalorion_tpu.align.chain import Segment as RefSegment
    cands = _chain_cases()
    if part == "short":
        cands = [c for c in cands if len(c) <= 40]
    elif part == "empty":
        cands = [[], []]
    got = chain_kernel.chain_batch_segments(
        [[PortSegment(*s) for s in c] for c in cands], **KW,
        device=torch.device("cpu"))
    want = jc.chain_batch_jax([[RefSegment(*s) for s in c] for c in cands],
                              **KW)
    assert len(got) == len(want) == len(cands)
    for k, ((gc, gs), (wc, ws)) in enumerate(zip(got, want)):
        assert [vars(s) for s in gc] == [vars(s) for s in wc], k
        assert type(gs) is float and np.float32(gs) == gs and gs == ws, k
    assert chain_kernel.chain_batch_segments(
        [], **KW, device=torch.device("cpu")) == []


# -------------------------------------------------- the switched runs

def _artifacts(out_dir):
    blobs = {}
    for name in ARTIFACTS:
        with open(os.path.join(out_dir, name), "rb") as fh:
            blobs[name] = fh.read()
        assert blobs[name], name
    return blobs


# a child process's script: the CLI's main, then whether any native
# library of either package was mapped into the process
_CHILD_MAIN = r"""
import importlib, json, sys
main = importlib.import_module(sys.argv[1]).main
rc = main(sys.argv[2:])
mapped = [l.split()[-1] for l in open("/proc/self/maps")
          if "libmando_native" in l]
print(json.dumps({"rc": rc, "mapped": sorted(set(mapped))}))
"""

# the port's pair, and the reference's pair it is held against
ROUTES = {("native", "numpy"): ("native", "numpy"),
          ("device", "device"): ("device", "rowscan"),
          ("native", "device"): ("native", "rowscan")}


def _child(module, argv):
    env = dict(os.environ, MANDO_TPU_NO_NATIVE="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT)
    return subprocess.Popen(
        [sys.executable, "-c", _CHILD_MAIN, module, *argv], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("pair", list(ROUTES), ids="-".join)
def test_switched_cli_matches_reference_and_the_native_run(data, pair):
    """Both CLIs under MANDO_TPU_NO_NATIVE=1, each in a child process:
    the six artifacts byte-identical to each other and to the port's run
    with its library; neither child maps a native library."""
    d, (genome, ann, reads), _g, _r = data
    tag = "-".join(pair)
    common = ["-G", genome, "-g", ann, "-f", reads, "-t", "1"]
    port_out = os.path.join(d, "switched-port-" + tag)
    ref_out = os.path.join(d, "switched-ref-" + tag)
    procs = [
        _child("mandalorion_tpu_torch.pipeline.cli",
               ["-p", port_out, *common, "--device", "cpu",
                "--chain_backend", pair[0], "--dp_backend", pair[1]]),
        _child("mandalorion_tpu.pipeline.cli",
               ["-p", ref_out, *common, "--chain_backend",
                ROUTES[pair][0], "--dp_backend", ROUTES[pair][1]])]
    native_out = os.path.join(d, "native-port-" + tag)
    assert cli.main(["-p", native_out, *common, "--device", "cpu",
                     "--chain_backend", pair[0], "--dp_backend",
                     pair[1]]) == 0
    for proc in procs:
        assert _finish(proc) == {"rc": 0, "mapped": []}
    got = _artifacts(port_out)
    assert got == _artifacts(ref_out)
    assert got == _artifacts(native_out)


# ------------------------------------------------------- the edges

_FAILED_BUILD = r"""
import os, sys
from mandalorion_tpu_torch import native
os.makedirs(sys.argv[1])
native._build_dir = lambda: sys.argv[1]
try:
    native.load_native()
except RuntimeError as exc:
    print("raised:", str(exc).splitlines()[0])
else:
    print("loaded")
"""


def test_failed_build_raises_without_the_switch(tmp_path):
    """No g++ on PATH and a fresh build directory: the loader raises,
    and never stands in the numpy twins for the library."""
    empty = tmp_path / "bin"
    empty.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "MANDO_TPU_NO_NATIVE"}
    env.update(PATH=str(empty), PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _FAILED_BUILD,
                          str(tmp_path / "build")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("raised: native library unavailable"), \
        out.stdout
    assert os.listdir(tmp_path / "build") == []


def test_native_consensus_backend_under_the_switch_raises(data, no_native):
    d, (genome, ann, reads), _g, _r = data
    with pytest.raises(RuntimeError, match="MANDO_TPU_NO_NATIVE"):
        cli.main(["-p", os.path.join(d, "refused"), "-G", genome, "-g",
                  ann, "-f", reads, "--device", "cpu",
                  "--consensus_backend", "native"])
    from mandalorion_tpu_torch.poa.consensus import graph_backend
    assert graph_backend("auto") == graph_backend(None) == "device"
    with pytest.raises(RuntimeError, match="MANDO_TPU_NO_NATIVE"):
        graph_backend("native")


@pytest.mark.parametrize("chain, kernel", [("device", "chain"),
                                           ("native", "dp")])
def test_switch_keeps_every_kernel_on_its_device(data, no_native,
                                                 monkeypatch, chain, kernel):
    """Under the switch the device chain goes through the chain kernel's
    wrapper and the DP problem list through the DP kernel's: made to
    stand for the card's launch, each raises for want of nvcc, with no
    fallback; and a CUDA device without a card is refused."""
    from mandalorion_tpu_torch import _build
    from mandalorion_tpu_torch.align import kernels
    from mandalorion_tpu_torch.align.aligner import TorchSpliceAligner
    _d, _inputs, genome, reads = data

    def no_build():
        raise RuntimeError("nvcc: not found")

    monkeypatch.setattr(_build, "load_kernels", no_build)
    if kernel == "chain":
        monkeypatch.setattr(chain_kernel, "chain_rows_plain",
                            lambda *a, **k: chain_kernel._chain_rows_cuda(
                                *a, **k))
    else:
        monkeypatch.setattr(
            kernels, "dp_fused_plain",
            lambda *a: kernels.dp_launch(*a[:7], None, *a[7:]))
    cfg = AlignConfig(chain_backend=chain, dp_backend="device")
    aligner = TorchSpliceAligner(genome, cfg, device="cpu")
    for method in (aligner.map_batch, aligner.map_batch_runs):
        with pytest.raises(RuntimeError, match="nvcc"):
            method(reads)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TorchSpliceAligner(genome, cfg, device="cuda")


def _map_both(aligner, reads):
    return ([str(r) for r in aligner.map_batch(reads)],
            [(n, s, q.tolist(), r) for n, s, q, r in
             aligner.map_batch_runs(reads)])


@pytest.mark.parametrize("chain", ["device", "native"])
def test_sharded_index_under_the_switch_matches_reference(data, no_native,
                                                          chain):
    """Under the switch with index_backend 'sharded' on two CPU shards:
    every orientation is looked up through the hash-range shards, its
    anchors collapse in Python, and the device chain (the segment-list
    entry) or the host chain picks. map_batch and map_batch_runs equal
    the reference's under the switch on two of its virtual devices, and
    the port's on the replicated index. One read of each gene: the
    reference looks each orientation up in its own call."""
    from mandalorion_tpu.align.aligner import SpliceAligner as RefAligner
    from mandalorion_tpu.config import AlignConfig as RefAlignConfig
    from mandalorion_tpu.parallel import mesh as jm
    from mandalorion_tpu_torch.align.aligner import TorchSpliceAligner
    from mandalorion_tpu_torch.parallel import mesh as M
    _d, _inputs, genome, reads = data
    reads = reads[::10]
    with jm.use_mesh(jm.make_mesh(2)):
        ref = RefAligner(genome, RefAlignConfig(
            chain_backend=chain, dp_backend="rowscan",
            index_backend="sharded"))
        want = _map_both(ref, reads)
    assert want[0] and want[1]
    with M.use_mesh(M.make_mesh(2, device="cpu")):
        port = TorchSpliceAligner(genome, AlignConfig(
            chain_backend=chain, dp_backend="device",
            index_backend="sharded"), device="cpu")
        assert port._sharded is not None
        assert _map_both(port, reads) == want
    replicated = TorchSpliceAligner(genome, AlignConfig(
        chain_backend=chain, dp_backend="device"), device="cpu")
    assert _map_both(replicated, reads) == want


# ------------------------------------------------------------- the card

@pytest.mark.cuda
def test_cuda_switched_route(data, no_native, monkeypatch):
    """On the card, under the switch: the default device route and
    `--consensus_backend auto` launch the chain, DP, forward and step
    walk kernels, and write the host route's artifacts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from mandalorion_tpu_torch.align import kernels
    from mandalorion_tpu_torch.poa import kernels as poa
    d, (genome, ann, reads), _g, _r = data
    common = ["-G", genome, "-g", ann, "-f", reads, "-t", "1"]
    counters = (chain_kernel.CHAIN_LAUNCHES, kernels.DP_LAUNCHES,
                poa.POA_FWD_LAUNCHES, poa.POA_WALK_LAUNCHES,
                poa.POA_SWEEP_LAUNCHES)
    for counter in counters:
        counter.count = 0
    out = os.path.join(d, "cuda-switched")
    assert cli.main(["-p", out, *common, "--device", "cuda"]) == 0
    counts = [c.count for c in counters]
    assert min(counts[:4]) > 0 and counts[4] == 0, counts
    host = os.path.join(d, "cuda-switched-host")
    assert cli.main(["-p", host, *common, "--chain_backend", "native",
                     "--dp_backend", "numpy", "--consensus_backend",
                     "device", "--device", "cuda"]) == 0
    assert _artifacts(out) == _artifacts(host)
