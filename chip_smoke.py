"""Smoke test of mandalorion_tpu_torch on one CUDA card.

Run from the repository root, no install needed:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero, and the last
line is printed only when every phase passed:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions. No CUDA device: exit non-zero at once.
2. build: nvcc builds csrc/*.cu, g++ the reference's native library.
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, with exact equality. The DP runs random problems across the
   whole envelope (query rows 1..2048 x target bases 1..2303, modes
   global / extend_right / extend_left, with end_bonus=12 and with zdrop)
   and the real descriptors of the slice's first read batch; the chain DP
   runs random 512-segment candidates and the real seed-stage output of
   that batch. Times come from CUDA events at the first batch's shapes.
4. slice: make_dataset(n_genes=40, n_reads_per_gene=500,
   genome_len=20_000_000, seed=0) -- 20,000 reads on a 20 Mbp genome --
   through `mando-tpu-torch --device cuda` (APDFQ) and through
   mandalorion_tpu's host pipeline (`mando-tpu`, a separate process that
   never touches CUDA) on the same input. The six artifacts must be
   byte-identical and every kernel's launch counter must be > 0.
5. a JSON line per kernel, the nvidia-smi line, then the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

The dataset and the reference run are subprocesses. This process imports
only the port (mandalorion_tpu_torch), which in turn imports
mandalorion_tpu's JAX-free host layers (config, io, native, stage
functions); it checks at the end that jax was never imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mandalorion_tpu_torch import (AlignConfig, _build, fastx_to_dict,
                                   read_fastx)
from mandalorion_tpu_torch.align import chain_kernel, kernels
from mandalorion_tpu_torch.align.aligner import TorchSpliceAligner
from mandalorion_tpu_torch.pipeline import cli as port_cli
from mandalorion_tpu_torch.runtime import require_native, resolve_device

ROOT = os.path.dirname(os.path.abspath(__file__))
DATASET = dict(n_genes=40, n_reads_per_gene=500, genome_len=20_000_000,
               seed=0)
ARTIFACTS = ("Isoforms.filtered.fasta", "Isoforms.filtered.clean.psl",
             "Isoforms.filtered.clean.gtf", "Isoforms.filtered.clean.quant",
             "Isoforms.filtered.clean.tpm",
             os.path.join("tmp", "reads2isoforms.txt"))
ROW_CLASSES = ((1, 8), (9, 32), (33, 128), (129, 512), (513, 2048))
WIDTH_CLASSES = ((1, 127), (128, 255), (256, 511), (512, 1023), (1024, 2303))


def log(msg: str) -> None:
    print(msg, flush=True)


def run(cmd, **kw) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, **kw)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[:3]} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def cuda_ms(fn, reps: int) -> float:
    """Mean wall time of fn() on the current stream, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    """Largest |got - want| over paired integer tensors (0 = identical)."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


# ------------------------------------------------------------ kernels

def random_dp_problems(rng, device):
    """Problems over every (row class, width class, mode), plus the full
    2048 x 2303 envelope in each mode. Half the queries are noisy copies
    of their target (real alignments), half are random (dead extensions
    and zdrop cuts)."""
    genome = rng.choice(5, size=1 << 22, p=[0.2475] * 4 + [0.01]).astype(
        np.uint8)
    queries, specs = [], []
    for rows in ROW_CLASSES:
        for width in WIDTH_CLASSES:
            for mode in (0, 1, 2):
                for k in range(4):
                    specs.append((int(rng.integers(rows[0], rows[1] + 1)),
                                  int(rng.integers(width[0], width[1] + 1)),
                                  mode, k % 2 == 0))
    specs += [(2048, 2303, mode, True) for mode in (0, 1, 2)]
    q_lo, t_lo, off = [], [], 0
    for nq, nt, mode, similar in specs:
        t0 = int(rng.integers(0, len(genome) - nt))
        if similar:
            src = genome[t0:t0 + nq] if nq <= nt else np.concatenate(
                [genome[t0:t0 + nt], rng.integers(0, 4, nq - nt)])
            q = src.astype(np.uint8)
            hit = rng.random(nq) < 0.08
            q[hit] = rng.integers(0, 4, int(hit.sum()))
        else:
            q = rng.integers(0, 4, nq).astype(np.uint8)
        queries.append(q)
        q_lo.append(off)
        t_lo.append(t0)
        off += nq
    nq, nt, mode = (np.array([s[i] for s in specs]) for i in range(3))

    def put(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)

    return (put(genome, np.uint8), put(np.concatenate(queries), np.uint8),
            put(q_lo, np.int64), put(t_lo, np.int64), put(nq, np.int32),
            put(nt, np.int32), put(mode, np.uint8))


def check_dp_random(rng, device) -> int:
    genome, oriented, q_lo, t_lo, nq, nt, mode = random_dp_problems(
        rng, device)
    err = 0
    for cfg in (AlignConfig(), AlignConfig(end_bonus=12),
                AlignConfig(zdrop=40), AlignConfig(end_bonus=12, zdrop=40)):
        for lo, hi in ROW_CLASSES:
            sel = ((nq >= lo) & (nq <= hi)).nonzero()[:, 0]
            args = (genome, oriented, q_lo[sel], t_lo[sel], nq[sel],
                    nt[sel], mode[sel], cfg,
                    int((nq[sel] + nt[sel]).max()))
            got = kernels.dp_fused(*args)
            want = kernels.dp_fused_plain(*args)
            e = max_abs_err(got, want)
            if e:
                raise AssertionError(
                    f"dp kernel != plain (rows {lo}..{hi}, end_bonus="
                    f"{cfg.end_bonus}, zdrop={cfg.zdrop}): max err {e}")
            err = max(err, e)
            if cfg.end_bonus == cfg.zdrop == 0:
                ms = cuda_ms(lambda: kernels.dp_fused(*args), 3)
                plain = cuda_ms(lambda: kernels.dp_fused_plain(*args), 1)
                log(f"dp: rows {lo}..{hi}, {len(sel)} problems (target "
                    f"1..{int(nt[sel].max())}): {ms:.3f} ms vs plain "
                    f"{plain:.3f} ms")
    log(f"dp: {int(nq.numel())} random problems x 4 scorings, kernel == "
        f"plain (rows 1..{int(nq.max())}, target 1..{int(nt.max())})")
    return err


def check_chain_random(rng, device) -> int:
    """512-segment candidates: sorted collinear segments with indel and
    intron gaps, overlaps and off-diagonal noise, cov <= span."""
    n, msb = 64, 512
    qs, qe, ts, te, cov = (np.zeros((n, msb), np.int32) for _ in range(5))
    n_seg = np.full(n, msb, np.int32)
    n_seg[:8] = rng.integers(0, 64, 8)
    for b in range(n):
        q = t = 0
        for i in range(int(n_seg[b])):
            ln = int(rng.integers(15, 60))
            q += int(rng.integers(-10, 15))
            t += int(rng.choice([-10, 0, 3, 40, 300, 5000, 60000]))
            q, t = max(q, 0), max(t, 0)
            qs[b, i], qe[b, i], ts[b, i], te[b, i] = q, q + ln, t, t + ln
            cov[b, i] = int(rng.integers(15, ln + 1))
            q, t = q + ln, t + ln
    args = [torch.from_numpy(a).to(device) for a in (qs, qe, ts, te, cov,
                                                     n_seg)]
    kw = dict(min_intron=30, max_intron=400_000)
    got = chain_kernel.chain_rows(*args, **kw)
    want = chain_kernel.chain_rows_plain(*args, **kw)
    e = max_abs_err([got], [want])
    if e:
        raise AssertionError(f"chain kernel != plain on random segments: "
                             f"max err {e}")
    log(f"chain: {n} random candidates x {msb} lanes, kernel == plain")
    return e


def check_first_batch(aligner, reads, device):
    """Both kernels against their plain versions on the first read batch's
    real inputs (module A's batch: max(batch_reads, n_reads / 3) reads),
    timed by CUDA events. Returns per-kernel (max_err, ms, plain_ms)."""
    cfg = aligner.cfg
    t0 = time.time()
    codes_all, read_off, seeded = aligner.seed_batch(reads)
    seed_s = time.time() - t0
    n_cand, _r, _s, _c, _t, n_seg, segs = seeded
    msb = chain_kernel.segment_lanes(int(n_seg[:n_cand].max()))
    cargs = [torch.from_numpy(np.ascontiguousarray(a[:n_cand, :msb])).to(
        device) for a in segs]
    cargs.append(torch.from_numpy(n_seg[:n_cand].copy()).to(device))
    kw = dict(min_intron=cfg.min_intron, max_intron=cfg.max_intron)
    rows = chain_kernel.chain_rows(*cargs, **kw)
    c_err = max_abs_err([rows], [chain_kernel.chain_rows_plain(*cargs, **kw)])
    if c_err:
        raise AssertionError(f"chain kernel != plain on the first batch: "
                             f"max err {c_err}")
    c_ms = cuda_ms(lambda: chain_kernel.chain_rows(*cargs, **kw), 5)
    c_plain = cuda_ms(lambda: chain_kernel.chain_rows_plain(*cargs, **kw), 1)
    log(f"chain: first batch {n_cand} candidates x {msb} lanes, kernel == "
        f"plain; {c_ms:.3f} ms vs plain {c_plain:.3f} ms")

    t0 = time.time()
    _st, _ch, oriented, _ro, _runs, probs = aligner.fill_batch(
        codes_all, read_off, seeded, rows.cpu().numpy())
    fill_s = time.time() - t0
    oriented_t = torch.from_numpy(oriented).to(device)
    chunks = list(kernels.dp_chunks(probs, read_off, device))
    genome = aligner.genome_codes
    d_err = 0
    for _idx, desc, steps in chunks:
        got = kernels.dp_fused(genome, oriented_t, *desc, cfg, steps)
        want = kernels.dp_fused_plain(genome, oriented_t, *desc, cfg, steps)
        d_err = max(d_err, max_abs_err(got, want))
    if d_err:
        raise AssertionError(f"dp kernel != plain on the first batch: "
                             f"max err {d_err}")

    def solve(fn):
        for _idx, desc, steps in chunks:
            fn(genome, oriented_t, *desc, cfg, steps)

    d_ms = cuda_ms(lambda: solve(kernels.dp_fused), 3)
    d_plain = cuda_ms(lambda: solve(kernels.dp_fused_plain), 1)
    n_dev = sum(len(c[0]) for c in chunks)
    nq = np.asarray(probs[4])
    log(f"dp: first batch {n_dev} device problems of {len(nq)} in "
        f"{len(chunks)} chunks (max rows {int(nq[nq <= 2048].max())}), "
        f"kernel == plain; {d_ms:.3f} ms vs plain {d_plain:.3f} ms")
    torch.cuda.synchronize()
    t0 = time.time()
    aligner.map_batch(reads)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    log(f"module A first batch ({len(reads)} reads), host clock: map_batch "
        f"{total_s * 1e3:.1f} ms = C seed {seed_s * 1e3:.1f} + chain kernel "
        f"{c_ms:.1f} + C fill {fill_s * 1e3:.1f} + dp kernel {d_ms:.1f} + "
        f"C emit, uploads, checks and records "
        f"{(total_s - seed_s - fill_s) * 1e3 - c_ms - d_ms:.1f}")
    return {"dp": (d_err, d_ms, d_plain), "chain": (c_err, c_ms, c_plain)}


# -------------------------------------------------------------- slice

def artifact_bytes(out_dir: str) -> dict:
    blobs = {}
    for name in ARTIFACTS:
        path = os.path.join(out_dir, name)
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            raise AssertionError(f"{path} missing or empty")
        with open(path, "rb") as fh:
            blobs[name] = fh.read()
    return blobs


def stage_seconds(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "tmp", "timing.tsv")) as fh:
        return {k: float(v) for k, v in
                (line.rstrip("\n").split("\t")[:2] for line in fh
                 if line.strip() and not line.startswith("stage"))}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    device = resolve_device("cuda")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {kind} x{torch.cuda.device_count()} | os.cpu_count() "
        f"{os.cpu_count()}")

    t0 = time.time()
    _build.load_kernels()
    log(f"build: nvcc kernels {time.time() - t0:.1f}s")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  {line.strip()}")
    t0 = time.time()
    require_native()
    log(f"build: native library {time.time() - t0:.1f}s")

    rng = np.random.default_rng(0)
    errs = {"dp": check_dp_random(rng, device),
            "chain": check_chain_random(rng, device)}

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        n_reads = int(run([
            sys.executable, "-c",
            "import sys; from mandalorion_tpu.utils.simulate import "
            f"make_dataset; print(make_dataset(sys.argv[1], **{DATASET!r}))",
            tmp]).split()[-1])
        log(f"dataset: {n_reads} reads, {DATASET['genome_len']} bp genome, "
            f"{DATASET['n_genes']} genes ({time.time() - t0:.1f}s)")
        inputs = ["-G", os.path.join(tmp, "genome.fasta"),
                  "-g", os.path.join(tmp, "ann.gtf"),
                  "-f", os.path.join(tmp, "reads.fasta")]

        ref_dir = os.path.join(tmp, "host")
        t0 = time.time()
        run([sys.executable, "-m", "mandalorion_tpu.pipeline.cli",
             "-p", ref_dir, *inputs])
        host_s = time.time() - t0

        reads = [(nm, sq) for nm, sq, _q in
                 read_fastx(os.path.join(tmp, "reads.fasta"))]
        aligner = TorchSpliceAligner(
            fastx_to_dict(os.path.join(tmp, "genome.fasta")),
            device=device)
        batch = max(aligner.cfg.batch_reads, -(-len(reads) // 3))
        first = check_first_batch(aligner, reads[:batch], device)
        for k in errs:
            errs[k] = max(errs[k], first[k][0])
        del aligner, reads

        port_dir = os.path.join(tmp, "port")
        counters = (kernels.DP_LAUNCHES, chain_kernel.CHAIN_LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.count = 0
        t0 = time.time()
        port_cli.main(["-p", port_dir, *inputs, "--device", "cuda"])
        torch.cuda.synchronize()
        port_s = time.time() - t0
        launches = {c.name: c.count for c in counters}
        peak = torch.cuda.max_memory_allocated()

        ref, got = artifact_bytes(ref_dir), artifact_bytes(port_dir)
        for name in ARTIFACTS:
            if got[name] != ref[name]:
                raise AssertionError(f"{name} differs from the host run")
        for name, count in launches.items():
            if count <= 0:
                raise AssertionError(f"kernel {name} was never launched on "
                                     f"the main path")
        ref_t, port_t = stage_seconds(ref_dir), stage_seconds(port_dir)
        log(f"slice: {len(ARTIFACTS)} artifacts byte-identical; launches "
            f"{launches}; peak device memory {peak} bytes")
        log(f"slice: APDFQ stages (index build included) "
            f"{n_reads / sum(port_t.values()):.1f} reads/s with module A on "
            f"the card vs {n_reads / sum(ref_t.values()):.1f} host; module A"
            f" {n_reads / port_t['A_alignment']:.1f} vs "
            f"{n_reads / ref_t['A_alignment']:.1f} reads/s; wall "
            f"{port_s:.1f}s vs {host_s:.1f}s (host: a fresh interpreter)")
        log("slice: stage seconds, card | host: " + ", ".join(
            f"{k} {port_t[k]:.2f} | {ref_t[k]:.2f}" for k in ref_t))

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    names = {"dp": ("dp_fused", "mandalorion_tpu_torch/csrc/dp.cu",
                    "mandalorion_tpu/align/kernels.py:186"),
             "chain": ("chain_rows", "mandalorion_tpu_torch/csrc/chain.cu",
                       "mandalorion_tpu/align/chain_kernel.py:30")}
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[k],
         "ms": first[k][1], "plain_ms": first[k][2]}
        for k, (name, src, rep) in names.items()]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
