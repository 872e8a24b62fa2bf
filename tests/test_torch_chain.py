"""The port's chain DP (mandalorion_tpu_torch/align/chain_kernel.py)
against mandalorion_tpu's `chain_batch_rows` (the JAX chain kernel):
identical packed int16 rows, float32 score bits included.

On the CPU `chain_rows` runs its plain PyTorch version; the CUDA kernel
(csrc/chain.cu) is held against it by the `cuda` tests here and by
chip_smoke.py. The JAX module comes from a fixture, so that the `cuda`
tests also run where jax is absent:
`python -m pytest --noconftest -m cuda tests/test_torch_chain.py`.
"""

import numpy as np
import pytest
import torch

from mandalorion_tpu.align.chain import Segment, prepare_segments
from mandalorion_tpu.config import AlignConfig
from mandalorion_tpu.native import load_native
from mandalorion_tpu_torch.align import chain_kernel

CPU = torch.device("cpu")
KW = dict(min_intron=30, max_intron=400_000)


@pytest.fixture
def jax_chain():
    from mandalorion_tpu.align import chain_kernel as jc
    return jc


def _random_candidate(rng, n_max):
    """Collinear segments with indel and intron gaps, overlaps and
    single-anchor noise, as tests/test_chain_kernel.py draws them; cov
    below the span like merged anchors."""
    segs = []
    q = int(rng.integers(0, 30))
    t = int(rng.integers(0, 5000))
    for _ in range(int(rng.integers(1, n_max))):
        ln = int(rng.integers(15, 300))
        segs.append(Segment(q, q + ln, t, t + ln, n_anchors=3,
                            cov=int(rng.integers(15, ln + 1))))
        q += ln + int(rng.integers(-12, 20))
        t += ln + int(rng.choice([-12, 0, 5, 40, 300, 5000, 60000]))
        q, t = max(q, 0), max(t, 0)
    for _ in range(int(rng.integers(0, 8))):
        nq = int(rng.integers(0, max(q, 1)))
        tt = nq + int(rng.choice([0, 10_000])) + int(rng.integers(0, 60000))
        segs.append(Segment(nq, nq + 15, tt, tt + 15, n_anchors=1))
    return prepare_segments(segs, KW["max_intron"])


def _pack(cands):
    """Candidates as native_stage_seed_batch packs them: (cap, 512) int32
    rows, t normalized to the candidate's first target base, zero
    padding."""
    cap = len(cands) + 5
    qs, qe, ts, te, cov = (np.zeros((cap, 512), np.int32) for _ in range(5))
    n_seg = np.zeros(cap, np.int32)
    for b, segs in enumerate(cands):
        base = min((s.t_start for s in segs), default=0)
        n_seg[b] = len(segs)
        for i, s in enumerate(segs):
            qs[b, i], qe[b, i] = s.q_start, s.q_end
            ts[b, i], te[b, i] = s.t_start - base, s.t_end - base
            cov[b, i] = s.score_len
    return (qs, qe, ts, te, cov), n_seg


def _collinear_candidate(rng, n):
    """Exactly n multi-anchor segments (n <= 512), collinear with indel
    and intron gaps and overlaps, as chip_smoke.py's random set draws
    them."""
    segs = []
    q = t = 0
    for _ in range(n):
        ln = int(rng.integers(15, 60))
        q = max(q + int(rng.integers(-10, 15)), 0)
        t = max(t + int(rng.choice([-10, 0, 3, 40, 300, 5000, 60000])), 0)
        segs.append(Segment(q, q + ln, t, t + ln, n_anchors=3,
                            cov=int(rng.integers(15, ln + 1))))
        q, t = q + ln, t + ln
    return prepare_segments(segs, KW["max_intron"])


def _tied_candidate(rng, n_max):
    """Candidates full of first-max ties: exons in one to three
    alternatives of equal length and cov at target shifts that keep the
    intron to the next exon in one power of two (equal cost), and each
    alternative repeated up to three times (duplicated segments)."""
    segs = []
    q = int(rng.integers(0, 30))
    t = int(rng.integers(0, 5000))
    while len(segs) < n_max:
        ln = int(rng.choice([20, 30]))
        for shift in (0, 300, 700)[:int(rng.integers(1, 4))]:
            seg = Segment(q, q + ln, t + shift, t + shift + ln, n_anchors=3,
                          cov=ln)
            segs.extend([seg] * int(rng.integers(1, 4)))
        q += ln + int(rng.choice([0, 0, 3]))
        t += ln + int(rng.choice([0, 5000, 5000, 6000]))
    return prepare_segments(segs[:n_max], KW["max_intron"])


def _cases(case, rng):
    """The candidates of a test case: int n_max draws 24 random
    candidates of up to n_max segments and two empty ones; "ties" tied
    candidates; "edges" n_seg 0, 1 and the row width 64 with the warp
    boundaries between; "mixed" a batch of 1 to 512 segments."""
    if case == "ties":
        return [_tied_candidate(rng, int(n)) for n in
                rng.integers(2, 64, 20)] + [_tied_candidate(rng, 200), []]
    if case == "edges":
        return [_collinear_candidate(rng, n) for n in
                (0, 1, 2, 31, 32, 33, 63, 64, 64, 1, 0)]
    if case == "mixed":
        return [_collinear_candidate(rng, int(n)) for n in
                rng.integers(1, 40, 24)] + [
            _collinear_candidate(rng, n) for n in (512, 1, 300, 0, 511)]
    return [_random_candidate(rng, case) for _ in range(24)] + [[], []]


SEEDS = {"ties": 7, "edges": 8, "mixed": 9}


@pytest.mark.parametrize("n_max", [12, 90, 400, "ties", "edges", "mixed"])
def test_plain_matches_jax_chain_rows(jax_chain, n_max):
    """Row widths 64, 128 and 512 (pow2 of the batch's longest candidate),
    with empty candidates mixed in; tie-heavy candidates; n_seg 0, 1 and
    the row width in one batch; and a batch of 1 to 512 segments."""
    rng = np.random.default_rng(SEEDS.get(n_max, n_max))
    cands = _cases(n_max, rng)
    segs, n_seg = _pack(cands)
    n = len(cands)
    got = chain_kernel.chain_batch_rows(*segs, n_seg, n, device=CPU, **KW)
    want = jax_chain.chain_batch_rows(*segs, n_seg, n, **KW)
    assert got.dtype == np.int16
    assert got.shape == want.shape == (
        n, chain_kernel.segment_lanes(int(n_seg.max())) + 3)
    np.testing.assert_array_equal(got, want)


def test_segment_lanes_rule():
    assert [chain_kernel.segment_lanes(m) for m in
            (0, 1, 64, 65, 128, 300, 512, 700)] == \
        [64, 64, 64, 128, 128, 512, 512, 512]


@pytest.mark.skipif(load_native() is None,
                    reason="native library unavailable")
def test_plain_matches_jax_on_seed_stage_output(jax_chain, tmp_path):
    """Real candidates: native_stage_seed_batch on simulated reads."""
    import os
    from mandalorion_tpu.align.aligner import SpliceAligner
    from mandalorion_tpu.align.encode import encode
    from mandalorion_tpu.io.fastx import fastx_to_dict, read_fastx
    from mandalorion_tpu.native import native_stage_seed_batch
    from mandalorion_tpu.utils.simulate import make_dataset
    make_dataset(str(tmp_path), n_genes=3, n_reads_per_gene=20,
                 genome_len=90_000, seed=4)
    genome = fastx_to_dict(os.path.join(tmp_path, "genome.fasta"))
    reads = [sq for _n, sq, _q in
             read_fastx(os.path.join(tmp_path, "reads.fasta"))]
    cfg = AlignConfig()
    host = SpliceAligner(genome, cfg)
    codes = [encode(s) for s in reads]
    read_off = np.zeros(len(codes) + 1, np.int64)
    np.cumsum([len(c) for c in codes], out=read_off[1:])
    n, _r, _s, _c, _t, n_seg, segs = native_stage_seed_batch(
        np.concatenate(codes), read_off, cfg.kmer, cfg.window,
        host.max_occ, 100, host.index, cfg.max_intron)
    assert n > len(reads)
    got = chain_kernel.chain_batch_rows(*segs, n_seg, n, device=CPU, **KW)
    np.testing.assert_array_equal(
        got, jax_chain.chain_batch_rows(*segs, n_seg, n, **KW))


def test_wrapper_checks_inputs():
    z = torch.zeros((2, 64), dtype=torch.int32)
    n_seg = torch.tensor([3, 0], dtype=torch.int32)
    rows = chain_kernel.chain_rows(z, z, z, z, z, n_seg, **KW)
    assert rows.shape == (2, 67) and rows.dtype == torch.int16
    order = torch.tensor([1, 0], dtype=torch.int32)
    assert torch.equal(
        chain_kernel.chain_rows(z, z, z, z, z, n_seg, **KW, order=order),
        rows)
    with pytest.raises(ValueError, match="qe"):
        chain_kernel.chain_rows(z, z.long(), z, z, z, n_seg, **KW)
    with pytest.raises(ValueError, match="n_seg outside"):
        chain_kernel.chain_rows(z, z, z, z, z, n_seg + 62, **KW)
    with pytest.raises(ValueError, match="n_seg outside"):
        chain_kernel.chain_rows(z, z, z, z, z, n_seg - 1, **KW)
    with pytest.raises(ValueError, match="order"):
        chain_kernel.chain_rows(z, z, z, z, z, n_seg, **KW,
                                order=order.long())
    with pytest.raises(ValueError, match="not a permutation"):
        chain_kernel.chain_rows(z, z, z, z, z, n_seg, **KW,
                                order=order * 0)
    m = z.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        chain_kernel.chain_rows(m, m, m, m, m, n_seg.to("meta"), **KW)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("bad", [-1, 513])
def test_batch_rows_refuses_bad_n_seg_on_host(monkeypatch, device, bad):
    """chain_batch_rows checks n_seg on its numpy array before it makes
    any tensor (so before any upload), whatever the device."""
    segs, n_seg = _pack([[Segment(0, 20, 0, 20, n_anchors=3)]] * 3)
    n_seg[1] = bad

    def no_tensor(*_a, **_k):
        raise AssertionError("a tensor was made before the check")

    for name in ("from_numpy", "empty", "tensor", "zeros"):
        monkeypatch.setattr(torch, name, no_tensor)
    with pytest.raises(ValueError, match="n_seg outside"):
        chain_kernel.chain_batch_rows(*segs, n_seg, 3,
                                      device=torch.device(device), **KW)


def test_chain_order_longest_first():
    n_seg = np.array([3, 0, 64, 3, 512, 1], np.int32)
    order = chain_kernel.chain_order(n_seg)
    assert order.dtype == np.int32
    assert order.tolist() == [4, 2, 0, 3, 5, 1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_max", [12, 400, "ties", "edges", "mixed"])
def test_cuda_kernel_matches_plain(cuda_device, n_max):
    rng = np.random.default_rng(50 + SEEDS.get(n_max, n_max))
    cands = _cases(n_max, rng) if isinstance(n_max, str) else [
        _random_candidate(rng, n_max) for _ in range(40)] + [[]]
    segs, n_seg = _pack(cands)
    n = len(cands)
    before = chain_kernel.CHAIN_LAUNCHES.count
    got = chain_kernel.chain_batch_rows(*segs, n_seg, n, device=cuda_device,
                                        **KW)
    assert chain_kernel.CHAIN_LAUNCHES.count == before + 1
    np.testing.assert_array_equal(
        got, chain_kernel.chain_batch_rows(*segs, n_seg, n, device=CPU,
                                           **KW))
    # chain_rows on the card's tensors, in index order: the same rows
    msb = got.shape[1] - 3
    args = [torch.from_numpy(np.ascontiguousarray(a[:n, :msb])).to(
        cuda_device) for a in segs]
    rows = chain_kernel.chain_rows(
        *args, torch.from_numpy(n_seg[:n].copy()).to(cuda_device), **KW)
    np.testing.assert_array_equal(rows.cpu().numpy(), got)
