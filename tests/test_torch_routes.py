"""The reference's mixed align routes in the port, and the DP problem list
entry they run on (`align.kernels.solve_dp_device`), against
mandalorion_tpu with the same (chain_backend, dp_backend) pair.

The port's dp 'device' is the reference's 'pallas'. On the CPU the port's
'device' and 'rowscan' both run the DP kernel's plain PyTorch version; the
reference's 'pallas' runs here through 'rowscan', as the JAX package's
own tests run it (tests/test_stage_native.py, tests/test_aligner.py),
which hold rowscan and the interpreted Pallas kernel to one numpy oracle
(tests/test_kernels.py). The problem list entry is held against all
three of the reference's entries: `solve_dp_pallas(interpret=True)`,
`solve_dp_rowscan` and `solve_dp_native`. Every comparison is exact.
"""

import os

import numpy as np
import pytest
import torch

from mandalorion_tpu.align.aligner import SpliceAligner as RefAligner
from mandalorion_tpu.align.extend import DpProblem, solve_dp_native
from mandalorion_tpu.config import AlignConfig as RefAlignConfig
from mandalorion_tpu.native import load_native
from mandalorion_tpu.pipeline import cli as ref_cli
from mandalorion_tpu_torch import _build
from mandalorion_tpu_torch.align import chain_kernel, kernels
from mandalorion_tpu_torch.align.aligner import TorchSpliceAligner
from mandalorion_tpu_torch.config import AlignConfig
from mandalorion_tpu_torch.io.fastx import fastx_to_dict, read_fastx
from mandalorion_tpu_torch.parallel import mesh as M
from mandalorion_tpu_torch.pipeline import cli
from mandalorion_tpu_torch.utils.simulate import make_dataset

from test_torch_dp import _random_problems

pytestmark = pytest.mark.skipif(load_native() is None,
                                reason="native library unavailable")

ARTIFACTS = ("Isoforms.filtered.fasta", "Isoforms.filtered.clean.psl",
             "Isoforms.filtered.clean.gtf", "Isoforms.filtered.clean.quant",
             "Isoforms.filtered.clean.tpm",
             os.path.join("tmp", "reads2isoforms.txt"))
# the port's mixed pairs and the reference's pair each is held against
MIXED = {("device", "numpy"): ("device", "numpy"),
         ("native", "device"): ("native", "rowscan"),
         ("device", "rowscan"): ("device", "rowscan"),
         ("native", "rowscan"): ("native", "rowscan")}


@pytest.fixture
def jax_kernels():
    from mandalorion_tpu.align import kernels as jk
    return jk


def _same_results(got, want, what):
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        assert (g.ops, g.q_len, g.t_len) == (w.ops, w.q_len, w.t_len), \
            f"{what}: problem {k}"


def _flank(rng, n_match, n_tail):
    """An extension whose query matches the target's first n_match bases
    and whose target then runs on into unrelated bases: read from the
    other end, the two share nothing."""
    t = rng.integers(0, 4, n_match + n_tail).astype(np.uint8)
    q = np.concatenate([t[:n_match], (t[n_match:n_match + 7] + 1) % 4])
    return q.astype(np.uint8), t


def _case(name, rng):
    """(problems, cfg) of one parametrised case."""
    cfg = AlignConfig()
    if name in ("global", "extend_right", "extend_left"):
        problems = _random_problems(rng, 8, name, max_len=50)
        for _ in range(3):
            q, t = _flank(rng, int(rng.integers(15, 40)),
                          int(rng.integers(10, 30)))
            problems.append(DpProblem(q, t, name))
    elif name == "over_size_and_empty":
        problems = _random_problems(rng, 6, "extend_right", max_len=40)
        big = rng.integers(0, 4, 2304).astype(np.uint8)
        e = np.zeros(0, np.uint8)
        problems += [DpProblem(big[:2049].copy(), big[:300].copy(),
                               "extend_right"),
                     DpProblem(big[:12].copy(), big, "global"),
                     DpProblem(e, big[:50].copy(), "global"),
                     DpProblem(big[:40].copy(), e, "global"),
                     DpProblem(e, big[:9].copy(), "extend_left"),
                     DpProblem(big[:7].copy(), e, "extend_right"),
                     DpProblem(e, e, "global")]
        problems += _random_problems(rng, 6, "extend_left", max_len=40)
    elif name == "dead_local":
        problems = (_random_problems(rng, 8, "extend_right", max_len=30,
                                     similar=False)
                    + _random_problems(rng, 8, "extend_left", max_len=30,
                                       similar=False))
        problems += [DpProblem(np.zeros(6, np.uint8), np.ones(9, np.uint8),
                               mode) for mode in ("extend_right",
                                                  "extend_left")]
    elif name == "zdrop":
        cfg = AlignConfig(zdrop=15)
        problems = [p for mode in ("global", "extend_right", "extend_left")
                    for p in _random_problems(rng, 5, mode, max_len=50)
                    + _random_problems(rng, 3, mode, max_len=50,
                                       similar=False)]
    elif name == "end_bonus":
        cfg = AlignConfig(end_bonus=12)
        problems = [p for mode in ("global", "extend_right", "extend_left")
                    for p in _random_problems(rng, 6, mode, max_len=50)]
    else:  # target lengths 1, 2303 and 2304 side by side in the buffer
        t = rng.integers(0, 4, 2304).astype(np.uint8)
        problems = []
        for mode in ("global", "extend_right", "extend_left"):
            problems += [DpProblem(t[:5].copy(), t[:1].copy(), mode),
                         DpProblem(t[:6].copy(), t[:2303].copy(), mode),
                         DpProblem(t[:7].copy(), t, mode),
                         DpProblem(t[-6:].copy(), t[:1].copy(), mode)]
    return problems, cfg


CASES = ("global", "extend_right", "extend_left", "over_size_and_empty",
         "dead_local", "zdrop", "end_bonus", "target_edges")


@pytest.mark.parametrize("name", CASES)
def test_solve_dp_device_matches_reference(jax_kernels, name):
    problems, cfg = _case(name, np.random.default_rng(CASES.index(name)))
    ref_cfg = RefAlignConfig(end_bonus=cfg.end_bonus, zdrop=cfg.zdrop)
    got = kernels.solve_dp_device(problems, cfg, "cpu")
    assert any(r.ops for r in got)
    _same_results(got, solve_dp_native(problems, ref_cfg), f"{name} native")
    _same_results(got, jax_kernels.solve_dp_rowscan(problems, ref_cfg),
                  f"{name} rowscan")
    _same_results(got, jax_kernels.solve_dp_pallas(problems, ref_cfg,
                                                   interpret=True),
                  f"{name} pallas")
    _same_results(kernels.solve_dp_device(problems, cfg, "cpu",
                                          rowscan=True), got,
                  f"{name} port rowscan")


def test_solve_dp_device_on_a_mesh_and_its_host_share(monkeypatch):
    """On two virtual CPU shards the results are the meshless call's; only
    the problems that are not device-eligible reach the host solver."""
    problems, cfg = _case("over_size_and_empty", np.random.default_rng(9))
    want = kernels.solve_dp_device(problems, cfg, "cpu")
    with M.use_mesh(M.make_mesh(2, device="cpu")):
        _same_results(kernels.solve_dp_device(problems, cfg, "cpu"), want,
                      "mesh")
    eligible = kernels.device_eligible(
        np.array([len(p.q) for p in problems]),
        np.array([len(p.t) for p in problems]))
    assert 0 < eligible.sum() < len(problems)
    seen = []
    real = kernels.solve_dp_native
    monkeypatch.setattr(kernels, "solve_dp_native", lambda ps, c: seen.append(
        len(ps)) or real(ps, c))
    kernels.solve_dp_device(problems, cfg, "cpu")
    assert seen == [int((~eligible).sum())]


def test_merge_steps_matches_reference(jax_kernels):
    rng = np.random.default_rng(4)
    for n in (0, 1, 2, 17, 300):
        codes = rng.choice([1, 1, 1, 2, 3], n).astype(np.int8)
        assert kernels.merge_steps(codes) == jax_kernels._merge_steps(codes)


# ------------------------------------------------------- the aligner

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("routes"))
    make_dataset(d, n_genes=3, n_reads_per_gene=10, genome_len=90_000,
                 seed=0)
    inputs = [os.path.join(d, f) for f in ("genome.fasta", "ann.gtf",
                                           "reads.fasta")]
    reads = [(nm, sq) for nm, sq, _q in read_fastx(inputs[2])]
    return d, inputs, fastx_to_dict(inputs[0]), reads


def _records(aligner, reads):
    name, seq = reads[0]
    return ([str(r) for r in aligner.map_batch(reads)],
            [(n, s, q.tolist(), r) for n, s, q, r in
             aligner.map_batch_runs(reads)],
            [str(r) for r in aligner.map_all_targets(name, seq)])


@pytest.mark.parametrize("pair", list(MIXED), ids="-".join)
def test_aligner_methods_match_reference(data, pair, monkeypatch):
    """map_batch, map_batch_runs and map_all_targets of the port aligner
    on a mixed pair equal the reference aligner's on the same pair, and
    the pair's device stages ran: the chain's plain version for chain
    'device', the DP's for dp 'device' or 'rowscan'."""
    _d, _inputs, genome, reads = data
    ref = RefAligner(genome, RefAlignConfig(chain_backend=MIXED[pair][0],
                                            dp_backend=MIXED[pair][1]))
    port = TorchSpliceAligner.from_aligner(ref, device="cpu", cfg=AlignConfig(
        chain_backend=pair[0], dp_backend=pair[1]))
    calls = []
    for mod, name in ((chain_kernel, "chain_rows_plain"),
                      (kernels, "dp_fused_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    got = _records(port, reads)
    assert ("chain_rows_plain" in calls) == (pair[0] == "device")
    assert ("dp_fused_plain" in calls) == (pair[1] != "numpy")
    want = _records(ref, reads)
    assert got == want
    assert len(got[0]) > len(reads) // 2 and got[1] and got[2]


def test_native_chain_with_sharded_index_matches_reference(data):
    """('native', 'device') with index_backend 'sharded' on two CPU
    shards: the lookups go through the hash-range shards and the host
    chain (the reference's `_chain_for`), against the reference on two
    of its virtual devices. One read of each gene: the reference looks
    each orientation up in its own call."""
    from mandalorion_tpu.parallel import mesh as jm
    _d, _inputs, genome, reads = data
    reads = reads[::10]
    with jm.use_mesh(jm.make_mesh(2)):
        ref = RefAligner(genome, RefAlignConfig(
            chain_backend="native", dp_backend="rowscan",
            index_backend="sharded"))
        want = _records(ref, reads)
    with M.use_mesh(M.make_mesh(2, device="cpu")):
        port = TorchSpliceAligner(genome, AlignConfig(
            chain_backend="native", dp_backend="device",
            index_backend="sharded"), device="cpu")
        assert port._sharded is not None
        assert _records(port, reads) == want


@pytest.mark.parametrize("pair", [p for p in MIXED if "device" in p],
                         ids="-".join)
def test_mixed_device_routes_never_fall_back(data, pair, monkeypatch):
    """A mixed route that launches a kernel raises when the kernel library
    cannot be built; it never carries on with the plain version or the
    host solver. The CPU has no kernel, so the plain version the route
    reaches here is swapped for the kernel's launch, whose build fails.
    Without a card, asking for CUDA raises before anything runs."""
    d, inputs, genome, reads = data
    cfg = AlignConfig(chain_backend=pair[0], dp_backend=pair[1])

    def no_build():
        raise RuntimeError("nvcc: not found")

    monkeypatch.setattr(_build, "load_kernels", no_build)
    if pair[0] == "device":
        monkeypatch.setattr(chain_kernel, "chain_rows_plain",
                            lambda *a, **k: chain_kernel._chain_rows_cuda(
                                *a, **k))
    if pair[1] == "device":
        monkeypatch.setattr(
            kernels, "dp_fused_plain",
            lambda *a: kernels.dp_launch(*a[:7], None, *a[7:]))
    port = TorchSpliceAligner(genome, cfg, device="cpu")
    for method in (port.map_batch, port.map_batch_runs):
        with pytest.raises(RuntimeError, match="nvcc"):
            method(reads)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TorchSpliceAligner(genome, cfg, device="cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["-p", os.path.join(d, "no-card"), "-G", inputs[0],
                      "-f", inputs[2], "--chain_backend", pair[0],
                      "--dp_backend", pair[1]])


# ---------------------------------------------------- the command line

RUNS: dict = {}


def _artifacts(out_dir):
    blobs = {}
    for name in ARTIFACTS:
        with open(os.path.join(out_dir, name), "rb") as fh:
            blobs[name] = fh.read()
        assert blobs[name], name
    return blobs


def _port_run(data, pair, *flags):
    d, (genome, ann, reads), _g, _r = data
    out = os.path.join(d, "port-" + "-".join(pair + flags))
    assert cli.main(["-p", out, "-G", genome, "-g", ann, "-f", reads,
                     "-t", "1", "--device", "cpu", "--chain_backend",
                     pair[0], "--dp_backend", pair[1], *flags]) == 0
    return _artifacts(out)


@pytest.mark.parametrize("pair", [("device", "numpy"), ("native", "device"),
                                  ("device", "rowscan")], ids="-".join)
def test_cli_matches_reference_cli(data, pair):
    """`mando-tpu-torch --device cpu` on a mixed pair: the six artifacts
    byte-identical to `mando-tpu` on the same pair."""
    d, (genome, ann, reads), _g, _r = data
    ref_pair = MIXED[pair]
    out = os.path.join(d, "ref-" + "-".join(ref_pair))
    assert ref_cli.main(["-p", out, "-G", genome, "-g", ann, "-f", reads,
                         "-t", "1", "--chain_backend", ref_pair[0],
                         "--dp_backend", ref_pair[1]]) == 0
    RUNS[pair] = _port_run(data, pair)
    assert RUNS[pair] == _artifacts(out)


def test_cli_native_chain_device_dp_on_two_shards(data):
    """('native', 'device') under --devices 2 (two virtual CPU shards):
    the artifacts of the run without a mesh."""
    pair = ("native", "device")
    want = RUNS.get(pair) or _port_run(data, pair)
    assert _port_run(data, pair, "--devices", "2") == want
    assert M.pipeline_mesh() is None


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_problem_list_and_mixed_routes(data, cuda_device):
    """On the card: `solve_dp_device` through csrc/dp.cu equals the plain
    version on the CPU on every case above, and the three mixed pairs'
    aligners on the card equal the host aligner, each through the kernels
    its pair names."""
    from mandalorion_tpu_torch.align.aligner import SpliceAligner
    for k, name in enumerate(CASES):
        problems, cfg = _case(name, np.random.default_rng(k))
        before = kernels.DP_LAUNCHES.count
        got = kernels.solve_dp_device(problems, cfg, cuda_device)
        assert kernels.DP_LAUNCHES.count > before
        _same_results(got, kernels.solve_dp_device(problems, cfg, "cpu"),
                      name)
    _d, _inputs, genome, reads = data
    host = SpliceAligner(genome, AlignConfig(chain_backend="native",
                                             dp_backend="numpy"))
    want = [str(r) for r in host.map_batch(reads)]
    for pair in [("device", "numpy"), ("native", "device"),
                 ("device", "rowscan")]:
        port = TorchSpliceAligner.from_aligner(
            host, cuda_device, AlignConfig(chain_backend=pair[0],
                                           dp_backend=pair[1]))
        counts = (chain_kernel.CHAIN_LAUNCHES.count,
                  kernels.DP_LAUNCHES.count)
        assert [str(r) for r in port.map_batch(reads)] == want
        assert (chain_kernel.CHAIN_LAUNCHES.count > counts[0]) == \
            (pair[0] == "device")
        assert (kernels.DP_LAUNCHES.count > counts[1]) == \
            (pair[1] == "device")
