"""The port's affine-gap DP + walk (mandalorion_tpu_torch/align/kernels.py)
against mandalorion_tpu's DP backends, with exact equality.

On the CPU `dp_fused` runs its plain PyTorch version; the CUDA kernel
(csrc/dp.cu) is held against that version by the `cuda` tests here and by
chip_smoke.py. The references: `solve_dp_fused(rowscan=True)` (the staged
route's JAX entry, same descriptors in, same arrays out), the Pallas
kernel in interpret mode, and the numpy oracle `solve_dp_numpy`. The JAX
module comes from a fixture, so that the `cuda` tests also run where jax
is absent: `python -m pytest --noconftest -m cuda tests/test_torch_dp.py`.
"""

import numpy as np
import pytest
import torch

from mandalorion_tpu.align.extend import DpProblem, DpResult, solve_dp_numpy
from mandalorion_tpu.config import AlignConfig
from mandalorion_tpu_torch.align import kernels

MODES = {"global": 0, "extend_right": 1, "extend_left": 2}


@pytest.fixture
def jax_kernels():
    from mandalorion_tpu.align import kernels as jk
    return jk


def _merge_steps(steps):
    """Reverse-order step codes -> merged (op, dq, dt) runs, as the
    reference's `_merge_steps`."""
    ops = []
    for c in steps[::-1]:
        op = "MID"[c - 1]
        dq, dt = int(op != "D"), int(op != "I")
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + dq, ops[-1][2] + dt)
        else:
            ops.append((op, dq, dt))
    return ops


def _random_problems(rng, n, mode, max_len=100, similar=True):
    """Query/target pairs as tests/test_kernels.py builds them: a target
    edited from the query (similar) or an unrelated one (dead extensions,
    zdrop cuts)."""
    problems = []
    for _ in range(n):
        nq = int(rng.integers(1, max_len))
        q = rng.integers(0, 4, size=nq).astype(np.uint8)
        if similar:
            t = list(q)
            for _e in range(int(rng.integers(0, 6))):
                kind = rng.integers(0, 3)
                p = int(rng.integers(0, max(len(t), 1)))
                if kind == 0 and t:
                    t[p] = int(rng.integers(0, 4))
                elif kind == 1:
                    t.insert(p, int(rng.integers(0, 4)))
                elif t:
                    del t[p]
            t = np.asarray(t or [1], np.uint8)
        else:
            t = rng.integers(0, 4, size=int(rng.integers(1, 2 * max_len)))
        problems.append(DpProblem(q, np.asarray(t, np.uint8), mode))
    return problems


def _descriptors(problems):
    """DpProblems as stage_fill_batch_c descriptors: problem k is read k of
    the batch. A mode-2 (extend_left) descriptor names slices that are read
    reversed, so its query and target are stored reversed."""
    oriented, genome = [], []
    read, mode, q0, t0, nq, nt = ([] for _ in range(6))
    t_off = 0
    for k, p in enumerate(problems):
        m = MODES[p.mode]
        oriented.append(p.q[::-1] if m == 2 else p.q)
        genome.append(p.t[::-1] if m == 2 else p.t)
        read.append(k)
        mode.append(m)
        q0.append(len(p.q) if m == 2 else 0)
        t0.append(t_off + len(p.t) if m == 2 else t_off)
        nq.append(len(p.q))
        nt.append(len(p.t))
        t_off += len(p.t)
    read_off = np.zeros(len(problems) + 1, np.int64)
    np.cumsum([len(p.q) for p in problems], out=read_off[1:])
    probs = (np.array(read, np.int32), np.array(mode, np.uint8),
             *(np.array(a, np.int64) for a in (q0, t0, nq, nt)))
    cat = (lambda a: np.concatenate(a).astype(np.uint8) if a
           else np.zeros(0, np.uint8))
    return probs, cat(oriented), read_off, cat(genome)


def _port(problems, cfg):
    probs, oriented, read_off, genome = _descriptors(problems)
    return probs, oriented, read_off, genome, kernels.solve_dp_fused(
        probs, oriented, read_off, torch.from_numpy(genome), cfg)


def _as_results(problems, meta, ks, buf):
    """Fused arrays -> DpResults, as the reference's `_solve_chunk`."""
    out = []
    for k, p in enumerate(problems):
        if p.mode == "global":
            qi, tj = len(p.q), len(p.t)
        else:
            qi, tj = int(meta[k, 0]), int(meta[k, 1])
            if meta[k, 2] <= 0:
                out.append(DpResult([], 0, 0))
                continue
        out.append(DpResult(_merge_steps(buf[k, :ks[k]]), qi, tj))
    return out


def _assert_same(ref, got, tag):
    for k, (r, g) in enumerate(zip(ref, got)):
        assert (g.ops, g.q_len, g.t_len) == (r.ops, r.q_len, r.t_len), \
            f"{tag} problem {k}: {g} != {r}"


@pytest.mark.parametrize("bonus,zdrop", [(0, 0), (12, 0), (0, 25),
                                         (12, 25)])
def test_plain_matches_jax_fused_rowscan(jax_kernels, bonus, zdrop):
    """Same descriptors through the reference's staged JAX entry (rowscan
    backend): the walk codes, step counts, final scores and on_host are
    identical in all three modes, with device-ineligible problems (empty,
    oversize) mixed in. The best cell is identical wherever it is live
    (score > 0). Where no cell beats 0 the rowscan reports its negative
    maximum while the Pallas kernel, like the port, keeps (0, 0, 0); the
    walk and the emit stage treat both as dead."""
    cfg = AlignConfig(end_bonus=bonus, zdrop=zdrop)
    rng = np.random.default_rng(100 + bonus + zdrop)
    problems = []
    for mode in MODES:
        problems += _random_problems(rng, 14, mode, max_len=90)
        problems += _random_problems(rng, 6, mode, max_len=90,
                                     similar=False)
    over = rng.integers(0, 4, 2049).astype(np.uint8)
    problems += [DpProblem(over, over[:300].copy(), "extend_right"),
                 DpProblem(over[:40].copy(), over[:0].copy(), "global"),
                 DpProblem(over[:0].copy(), over[:50].copy(), "global")]
    probs, oriented, read_off, genome, got = _port(problems, cfg)
    meta, ks, buf, on_host = got
    r_meta, r_ks, r_buf, r_on_host = jax_kernels.solve_dp_fused(
        probs, oriented, read_off, genome, cfg, rowscan=True)
    np.testing.assert_array_equal(on_host, r_on_host)
    assert on_host[-3:].tolist() == [1, 1, 1] and not on_host[:-3].any()
    np.testing.assert_array_equal(ks, r_ks)
    np.testing.assert_array_equal(buf, r_buf[:, :buf.shape[1]])
    assert not r_buf[:, buf.shape[1]:].any()
    np.testing.assert_array_equal(meta[:, 3], r_meta[:, 3])
    live = r_meta[:, 2] > 0
    assert live.sum() > len(problems) // 2
    np.testing.assert_array_equal(meta[live], r_meta[live])
    assert not meta[~live, :3].any()


@pytest.mark.parametrize("mode,bonus,zdrop", [("global", 0, 0),
                                              ("extend_right", 12, 0),
                                              ("extend_left", 0, 15)])
def test_plain_matches_pallas_interpret(jax_kernels, mode, bonus, zdrop):
    """A small sweep against the Pallas kernel itself (interpret mode),
    fused with its walk: every output array identical."""
    cfg = AlignConfig(end_bonus=bonus, zdrop=zdrop)
    rng = np.random.default_rng(7 + bonus + zdrop)
    problems = (_random_problems(rng, 5, mode, max_len=30)
                + _random_problems(rng, 2, mode, max_len=30, similar=False))
    probs, oriented, read_off, genome, got = _port(problems, cfg)
    ref = jax_kernels.solve_dp_fused(probs, oriented, read_off, genome,
                                     cfg, interpret=True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r[:, :g.shape[1]]
                                      if g.ndim == 2 else r)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("bonus,zdrop", [(0, 0), (12, 0), (0, 20),
                                         (12, 20)])
def test_plain_matches_numpy_oracle(mode, bonus, zdrop):
    cfg = AlignConfig(end_bonus=bonus, zdrop=zdrop)
    rng = np.random.default_rng(len(mode) * 31 + bonus + zdrop)
    problems = (_random_problems(rng, 30, mode, max_len=120)
                + _random_problems(rng, 10, mode, max_len=120,
                                   similar=False))
    *_, got = _port(problems, cfg)
    _assert_same(solve_dp_numpy(problems, cfg),
                 _as_results(problems, *got[:3]), f"{mode}-{bonus}-{zdrop}")


def test_full_envelope_matches_numpy_oracle():
    """2048 query rows x 2303 target bases, the largest device problem,
    in each mode."""
    rng = np.random.default_rng(11)
    t = rng.integers(0, 4, kernels.MAX_T_DEVICE).astype(np.uint8)
    q = t[:kernels.MAX_Q_DEVICE].copy()
    hit = rng.random(len(q)) < 0.1
    q[hit] = rng.integers(0, 4, int(hit.sum()))
    cfg = AlignConfig(end_bonus=12)
    problems = [DpProblem(q, t, mode) for mode in MODES]
    *_, got = _port(problems, cfg)
    assert not got[3].any()
    _assert_same(solve_dp_numpy(problems, cfg),
                 _as_results(problems, *got[:3]), "envelope")


def test_eligibility_matches_reference_rule():
    nq = np.array([0, 1, 2048, 2049, 5, 5, 5])
    nt = np.array([5, 5, 5, 5, 0, 2303, 2304])
    assert kernels.device_eligible(nq, nt).tolist() == [
        False, True, True, False, False, True, False]


def test_no_eligible_problem_returns_host_rows():
    rng = np.random.default_rng(3)
    q = rng.integers(0, 4, 2049).astype(np.uint8)
    problems = [DpProblem(q, q[:100].copy(), "extend_right")]
    *_, (meta, ks, buf, on_host) = _port(problems, AlignConfig())
    assert on_host.tolist() == [1]
    assert buf.shape == (1, 1) and not meta.any() and not ks.any()


def test_chunks_respect_budget(monkeypatch):
    """Problems split into chunks whose padded pointer matrices fit the
    budget; results do not depend on the chunking."""
    cfg = AlignConfig(end_bonus=12)
    rng = np.random.default_rng(5)
    problems = _random_problems(rng, 40, "extend_right", max_len=120)
    *_, whole = _port(problems, cfg)
    monkeypatch.setattr(kernels, "PTR_BUDGET", 64 * 1024)
    probs, oriented, read_off, genome = _descriptors(problems)
    chunks = list(kernels.dp_chunks(probs, read_off, torch.device("cpu")))
    assert len(chunks) > 1
    assert sorted(np.concatenate([c[0] for c in chunks]).tolist()) == \
        list(range(len(problems)))
    for idx, (_ql, _tl, nq, nt, _m), _steps in chunks:
        assert len(idx) == 1 or len(idx) * (int(nq.max()) + 1) * \
            (int(nt.max()) + 1) <= kernels.PTR_BUDGET
    *_, split = _port(problems, cfg)
    for a, b in zip(whole, split):
        np.testing.assert_array_equal(a, b)


def _cpu_args(n=3):
    t = torch.arange(40, dtype=torch.uint8) % 4
    return dict(genome=t, oriented=t.clone(),
                q_lo=torch.zeros(n, dtype=torch.int64),
                t_lo=torch.zeros(n, dtype=torch.int64),
                nq=torch.full((n,), 10, dtype=torch.int32),
                nt=torch.full((n,), 12, dtype=torch.int32),
                mode=torch.tensor([0, 1, 2][:n], dtype=torch.uint8))


def test_wrapper_checks_inputs():
    cfg = AlignConfig()
    a = _cpu_args()
    kernels.dp_fused(**a, cfg=cfg, steps=22)
    with pytest.raises(ValueError, match="steps"):
        kernels.dp_fused(**a, cfg=cfg, steps=21)
    with pytest.raises(ValueError, match="nq"):
        kernels.dp_fused(**{**a, "nq": a["nq"].long()}, cfg=cfg, steps=22)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.dp_fused(**{**a, "t_lo": torch.zeros(6, dtype=torch.int64)
                            [::2]}, cfg=cfg, steps=22)
    with pytest.raises(ValueError, match="outside"):
        kernels.dp_fused(**{**a, "q_lo": torch.full((3,), 35)}, cfg=cfg,
                         steps=22)
    with pytest.raises(ValueError, match="sizes"):
        kernels.dp_fused(**{**a, "nt": torch.full((3,), 2304,
                                                  dtype=torch.int32)},
                         cfg=cfg, steps=5000)
    meta = {k: v.to("meta") for k, v in a.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.dp_fused(**meta, cfg=cfg, steps=22)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bonus,zdrop", [(0, 0), (12, 30)])
def test_cuda_kernel_matches_plain(cuda_device, bonus, zdrop):
    cfg = AlignConfig(end_bonus=bonus, zdrop=zdrop)
    rng = np.random.default_rng(21)
    problems = []
    for mode in MODES:
        problems += _random_problems(rng, 40, mode, max_len=300)
        problems += _random_problems(rng, 10, mode, max_len=300,
                                     similar=False)
    probs, oriented, read_off, genome = _descriptors(problems)
    before = kernels.DP_LAUNCHES.count
    got = kernels.solve_dp_fused(probs, oriented, read_off,
                                 torch.from_numpy(genome).to(cuda_device),
                                 cfg)
    assert kernels.DP_LAUNCHES.count > before
    want = kernels.solve_dp_fused(probs, oriented, read_off,
                                  torch.from_numpy(genome), cfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_cuda_kernel_full_envelope(cuda_device):
    """2048 query rows x 2303 target bases in each mode, with the end
    bonus and zdrop."""
    rng = np.random.default_rng(23)
    t = rng.integers(0, 5, kernels.MAX_T_DEVICE).astype(np.uint8)
    q = t[:kernels.MAX_Q_DEVICE].copy()
    hit = rng.random(len(q)) < 0.15
    q[hit] = rng.integers(0, 4, int(hit.sum()))
    problems = [DpProblem(q, t, mode) for mode in MODES]
    problems += [DpProblem(rng.integers(0, 4, len(q)).astype(np.uint8), t,
                           mode) for mode in MODES]
    probs, oriented, read_off, genome = _descriptors(problems)
    for cfg in (AlignConfig(end_bonus=12), AlignConfig(zdrop=60)):
        got = kernels.solve_dp_fused(
            probs, oriented, read_off,
            torch.from_numpy(genome).to(cuda_device), cfg)
        want = kernels.solve_dp_fused(probs, oriented, read_off,
                                      torch.from_numpy(genome), cfg)
        assert not got[3].any()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
