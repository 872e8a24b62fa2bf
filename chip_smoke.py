"""Smoke test of mandalorion_tpu_torch on one CUDA card.

Run from the repository root, no install needed:

    python3 chip_smoke.py [--chain-only]

--chain-only runs phases 1 and 2 and the chain's part of phase 3 (its
sets, and the first read batch of phase 4's dataset) and prints no result
line: a copy of this script run inside another tree of the port times
that tree's chain route with the same code and inputs.

Phases, in order; any failure raises and exits non-zero, and the last
line is printed only when every phase passed. Each phase, and each part
of phases 3 and 9, prints its seconds on a line `seconds: <what> <s>`;
each run of a slice prints its wall seconds.

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions. No CUDA device: exit non-zero at once.
2. build: nvcc builds csrc/*.cu (one process per source), g++ the port's
   native library.
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, with exact equality.
   - dp: random problems across the whole envelope (query rows 1..2048 x
     target bases 1..2303, modes global / extend_right / extend_left,
     with end_bonus=12 and with zdrop), timed by row class; every layout
     class of the kernel in one launch (strip edges at 32, 33, 64, 65
     rows, pointers and boundary rows in shared memory and in scratch,
     blocks of warps on one problem) with zdrop cuts inside a strip; and
     the real descriptors of the slice's first read batch, whose pointers
     must all stay in shared memory;
   - chain: random 512-segment candidates, a mixed batch of 3,000 short
     candidates and six of 300..512 segments, tie-heavy candidates
     (duplicated segments, equal-cost predecessors), and the real
     seed-stage output of that batch; each timed as the route's call from
     numpy arrays to fetched rows (host clock), the chain_rows call and
     the launch alone (CUDA events), with its bound from the bytes the
     work needs beside the padded count;
   - poa_fwd, poa_walk, poa_sweep: (a) real chunks of a consensus run of 16
     isoforms x 20 reads x about 2 kb at the first round, adaptive band;
     (b) the middle and the last round's chunks under the static band (W
     1024 and 2048); (c) a graph with a predecessor more than 256 rows back
     (one read carries a 320-base insertion), and a second graph at W = 256
     with predecessors both the row before and 101 rows back (inside and
     beyond the forward's shared-memory ring, and beyond the step walk's
     staged tile) whose last query also carries a deletion and an insertion
     run, its fourth round; (d) one isoform whose queries are longer than
     32,768 bases, with a 40-base insertion behind column 32,768: the
     consensus must equal the native C++ engine's, and its graphs are over
     the record walk's rank limit, so asked for records it must take the
     step walk, by the launch counters; (e) a graph under that limit whose
     query carries 30-base insertions, the last of them behind column
     32,768; (f) the isoforms of (a) under four bands in turns in one call:
     one chunk a round, consensi against the native engine at each band,
     and each problem's matrices against a launch that holds its band
     alone; and, after the slice, the largest chunk module D dispatched in
     it. On every chunk the record walk's records, expanded, must be the
     step walk's steps; the two walks are timed in turns on (c)'s last
     round, on (e) and on the largest chunk. Ladders of hand-made cells
     hold the record walk's cuts (max_rec inside a tile, 3 x rows
     transitions) against the plain version.
   Times come from CUDA events at the main path's own shapes: the first
   read batch for dp and chain, module D's largest chunk (a whole round:
   every isoform still growing, whatever its band) for the POA kernels;
   the forward and the step walk are also timed on that chunk's five
   tallest problems alone. Each kernel's bound is the larger of its
   bytes over the card's memory rate and its operations over the card's
   ALU rate.
4. slice: make_dataset(n_genes=40, n_reads_per_gene=500,
   genome_len=20_000_000, seed=0)'s files (written by
   tools/run_configs_torch.py's make_dataset_files, the same bytes),
   20,000 reads on a 20 Mbp genome,
   through `mando-tpu-torch --device cuda --consensus_backend device`
   (APDFQ: module A on its device route, module D's graph POA through the
   POA kernels) and through the port's host route (`--chain_backend
   native --dp_backend numpy`, native consensus) in a separate process
   that never touches CUDA. The device route runs twice, in turns: step
   walk, then record walk (MANDO_POA_SWEEP=1).
   The seven files (the six artifacts and `.clean.genes`) must be
   byte-identical every time; the launch counters, set to 0 before each
   run, must show dp, chain, forward and step walk in the step runs, and
   in the record runs one poa_sweep launch for every chunk under the rank
   limit and a step walk for the rest; the forward once a chunk, a chunk
   being a round of one width class with more than six problems in the
   fullest.
   Then the smaller slice that phases 5-8 drive: SMALL_DATASET (12
   genes x 250 reads, 3,000 reads on 6 Mbp) through the host route in a
   process of its own and once through the device route by steps,
   byte-identical; its host artifacts and device turn are what those
   phases compare with ("turn 0" there).
5. mesh (parallel/ on torch.distributed), after the two turns: (a) a
   one-rank NCCL group (`multihost_init` on a free localhost port) and
   `make_mesh(1)`: `mesh_count_matrix` against np.bincount, the sharded
   index lookup (slice-20k's index in four hash-range shards, the first
   reads' minimizers, each orientation refined) against
   `GenomeIndex.lookup`, `sharded_batch_score` against its plain version on
   the CPU; (b) on two shards of the one card (`Mesh.from_devices`, the
   same group) `chain_batch_rows`, `solve_dp_fused` and `dispatch_chunk`
   (both walks) on batches of 1, 3 and 2k + 1 problems (the second shard
   all or partly padding) against the meshless call on the card and the
   plain versions; (c) the smaller slice through the device route twice
   more, in this process: under the one-rank mesh, and under the two-shard
   mesh with `--index_backend sharded`; the seven files must equal the
   host route's and the chain, dp, forward and step walk counters must be
   positive in each; wall time, stage seconds beside turn 0's, peak device
   memory, and the collectives' count and host ms are printed; (d)
   `make_mesh(2)` on the one card must raise. The group is destroyed at the
   phase's end.
6. mixed routes (the reference's other (chain_backend, dp_backend)
   pairs), after the mesh: (a) the DP problem list entry
   `solve_dp_device` on the card against its plain version on the card
   (`rowscan=True`) and the host solver `solve_dp_native`, exactly, on
   the first read batch's problems as the Python staging makes them
   (`_native_picks` + `_fill_picks`: global, extend_right and
   extend_left gap fills) with hand-made ones (over-size nq 2049 and nt
   2304, empty sides, dead extensions, targets of 1, 2303 and 2304 bases
   side by side; the 2048 x 2303 envelope once), under the default
   scoring, end_bonus 12, zdrop 40 and both; the dp_fused counter must
   move for the entry and not for its plain version; timed on the first
   batch: the entry's call (host clock), its launches alone and the
   plain version (CUDA events), beside the staged entry `solve_dp_fused`
   on the C fill stage's descriptors of the same reads (host clock) and
   its launches alone, with the bound from 23 operations a cell; (b)
   the smaller slice in this process, with `--consensus_backend
   device`, under chain device / dp numpy, chain native / dp device and
   chain device / dp rowscan: the seven files must equal the host
   route's, and the counters, set to 0 before each run, must show the
   chain kernel exactly when the chain is 'device', the DP kernel exactly
   when the DP is 'device', and the POA kernels always; stage seconds
   beside turn 0's and peak device memory are printed; (c) an index
   without its bucket table: bench.py's device_path dataset (4 genes x 75
   reads on 120 kb) through the default device route with
   `--consensus_backend device`, first with `--index_cache <dir>` (which
   writes the cache), then on a copy of that cache without
   bucket_lo.npy: the seven files must be byte-identical, the bucket-less
   run must seed in numpy (no C seed stage call) and launch the chain and
   DP kernels, and its cache must stay without the table; the two runs'
   stage seconds are printed.
7. trace (the stage profiler hook, MANDO_TPU_PROFILE), after the mixed
   routes: the smaller slice in this process, by steps and by records, each
   with MANDO_TPU_PROFILE set to a directory of its own, so that every
   stage runs under torch.profiler with the card's activity. The seven
   files must equal the host route's; every stage must have its trace,
   read by tools/trace_breakdown.py; each stage's trace must name each hand
   kernel (dp_fused_kernel, chain_rows_kernel, poa_fwd_kernel,
   poa_walk_kernel, poa_sweep_kernel) as often as its launch counter moved
   in that stage, and a stage that launched one must show a measured busy
   time; dp, chain, forward and step walk must appear in the step run, the
   record walk in the record run; the traced ms of the forward and of the
   walk must lie within 10% of the CUDA-event sums of the same run.
   Printed: the kernel names kineto recorded, and for each stage its
   timing.tsv seconds beside turn 0's, the traced window, the card's busy
   ms and idle share, the five device operations that take the most time,
   the three longest idle gaps with the host operation under each, and the
   trace's bytes; for each run the idle share over its stages.
8. no native (MANDO_TPU_NO_NATIVE), after the mixed routes and before the
   trace phase: (a) the segment-list chain entry `chain_batch_segments`
   (the reference's `chain_batch_jax`) on hand-made candidates of 400 to
   700 segments (the entry keeps the longest 512) and on the first read
   batch's candidates from the numpy seeding's segment lists
   (`segment_candidates`): the packed rows through the kernel and the route
   against the plain version, exactly, timed as in phase 3, and the entry's
   chains and float32 scores on the card against the entry on the CPU; (b)
   `align_graph_batch` on case (a)'s Python-held graphs, two rounds, the
   card's paths against the CPU's; (c) the smaller slice's default device
   route (`--consensus_backend auto`) through `run_pipeline` in a child
   process with MANDO_TPU_NO_NATIVE=1 (the switch is read once a process):
   the seven files must equal the host route's, the child must never map
   a native library, and its counters must show chain and dp, the forward
   and the step walk once a chunk of module D's `PoaGraph` rounds, and no
   record walk; stage seconds beside turn 0's and the host route's.
9. users' inputs and sizes, after the trace phase, with the dataset makers
   and the small cases' dataset writers of tools/run_configs_torch.py;
   every comparison is with the port's host route in a process of its own
   that never touches CUDA, over the seven files, byte for byte: (a)
   config-3 in full: make_dataset's files for 100 genes x 1,000 reads on
   50 Mbp, the reads as two samples in a fofn (genes 0-49 FASTA, 50-99
   gzipped FASTQ), once through the device route by steps;
   printed: stage seconds and reads/s of both routes, module A's batches,
   the first batch's chain candidates, longest candidate and DP problems,
   module D's rounds, chunks and (n_cap, W) classes, the largest chunk's
   (B, n_cap, W) and its forward and walk alone, the summed kernel ms,
   launches, peak device memory; (b) tests/test_scale.py's 300 Mbp dataset
   (4 x 75 Mbp, 2 genes a chromosome, 40 reads a gene) in three runs, each
   in a process of its own (`run_configs_torch.py route`): the device route
   writing `--index_cache <dir>`, the host route loading it memory-mapped,
   the device route loading it; every planted gene one isoform on its own
   chromosome; printed: each run's stage seconds (`index_build` built and
   loaded), peak RSS, peak device memory and launches, and the genome's
   upload to the card from the mapped cache against a built index's array
   (host clock); (c) the small cases of tests/test_torch_e2e.py through the
   device route in this process: two-sample fofn (then resumed with `-M FQ`
   after .quant and .tpm are removed), three samples of FASTA and gzipped
   FASTQ, gzipped FASTQ with no flag, `-w 2 -j gtag` and `-m`, PacBio BAM
   with `-P` (.quant and .tpm compared with the output directory
   substituted), two chromosomes with junk reads, all junk (no isoform file
   on either route), config-2's dataset with its gates, and
   `--external_sam` from the card's SAM through both routes.
10. bench, after the users' phase: `python3 bench_torch.py --smoke` in a
   process of its own (one timed attempt a route in each section:
   bench.py's two small datasets, its POA workload and poa_batch at 64
   isoforms; not config-3, which phase 9 (a) runs): its last line must
   parse as JSON with every section; each pipeline section (value,
   star_engine, device_path) compared a card and a host run (the bench
   raises when their seven files differ, and when the host route's warm
   child did not fork its pools) and reports the seven files' sha256,
   device_path after a cold run on each route; the launch counts must be what each section reaches: dp and
   chain and no POA kernel in value and star_engine, dp, chain, forward
   and step walk in device_path, the forward once a round and the step
   walk in poa and poa_batch, no record walk anywhere.
11. one JSON line with every kernel, the nvidia-smi line, then the result
   line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Processes: the script adopts every process it starts, directly or not
(it is their child subreaper on Linux), and before it prints its last
lines, or when a phase fails, it stops what is still running below it:
the multiprocessing resource tracker that the pipeline's shared-memory
segments start in this process, and anything else, by SIGTERM and then
SIGKILL. Nothing it started outlives it.

This script imports only the port; byte identity against the JAX package
is held by the CPU tests (tests/test_torch_*.py).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import importlib.util
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from mandalorion_tpu_torch import (AlignConfig, _build, fastx_to_dict,
                                   read_fastx)
from mandalorion_tpu_torch.align import chain_kernel, kernels
from mandalorion_tpu_torch.align.aligner import (
    TorchSpliceAligner, sharded_seed_hits)
from mandalorion_tpu_torch.align.chain import Segment
from mandalorion_tpu_torch.align.encode import (
    encode, minimizers, revcomp_codes)
from mandalorion_tpu_torch.align.extend import DpProblem, solve_dp_native
from mandalorion_tpu_torch.native import native_poa_consensus
from mandalorion_tpu_torch.parallel import dist as pdist
from mandalorion_tpu_torch.parallel import mesh as pmesh
from mandalorion_tpu_torch.pipeline import cli as port_cli
from mandalorion_tpu_torch.pipeline import observe
from mandalorion_tpu_torch.poa import kernels as poa
from mandalorion_tpu_torch.poa.graph import PoaGraph, PoaParams
from mandalorion_tpu_torch.runtime import require_native, resolve_device

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_config_tool():
    """tools/run_configs_torch.py: the dataset makers, the small cases'
    writers, the artifact list and its readers, and the run of a route in
    a process of its own."""
    path = os.path.join(ROOT, "tools", "run_configs_torch.py")
    spec = importlib.util.spec_from_file_location("run_configs_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOL = load_config_tool()
ARTIFACTS = TOOL.ARTIFACTS          # the six artifacts and .clean.genes
artifact_bytes, stage_seconds = TOOL.artifact_bytes, TOOL.stage_seconds
DATASET = dict(n_genes=40, n_reads_per_gene=500, genome_len=20_000_000,
               seed=0)
# the smaller slice that phases 5-8 drive, with its own host run and
# device turn: 3,000 reads on 6 Mbp
SMALL_DATASET = dict(n_genes=12, n_reads_per_gene=250, genome_len=6_000_000,
                     seed=0)
ROW_CLASSES = ((1, 8), (9, 32), (33, 128), (129, 512), (513, 2048))
WIDTH_CLASSES = ((1, 127), (128, 255), (256, 511), (512, 1023), (1024, 2303))
# the chain's sets beside the main path (chain_random_sets) and their
# scoring window
CHAIN_SEED = 6
CHAIN_KW = dict(min_intron=30, max_intron=400_000)
# the POA cases (a)/(b), (c) and (d) of the module docstring
POA_SETS = dict(n_iso=16, n_reads=20, length=2000, err=0.03)
POA_LONG_EDGE = dict(length=2000, insert=320, band=340)
# W stays 256 under this band, where the forward keeps RING_ROWS rows in
# shared memory and the step walk stages TILE_ROWS rows: the insertion puts a
# predecessor beyond both
POA_RING = dict(length=2000, insert=100, band=120, deleted=5, inserted=7)
RING_ROWS, TILE_ROWS = 16, 64
# case (f): the bands of POA_SETS' isoforms, in turns: one narrower and one
# wider than both its neighbours
POA_MIXED_BANDS = (30, 16, 24, 40)
# `at` - 100 >= 32768: the insertion's origin column needs 16 bits
POA_LONG_QUERY = dict(length=33_000, insert=40, at=32_900, band=340)
# a graph of `length` nodes stays under the record walk's rank limit; the
# query's insertions push its last columns past 32768
POA_LONG_RUNS = dict(length=31_500, insert=30, every=500, band=64,
                     behind=1 << 15)

# The card's peaks (NVIDIA's H100 SXM data sheet): 3.35 TB/s of device
# memory; 67 TFLOP/s of float32 outside the tensor cores, which counts a
# fused multiply-add as two operations on 128 lanes an SM. The chain
# kernel's float32 operations are rounded one by one (no FMA): half of
# that. int32 adds, compares and selects issue on 64 lanes an SM: a
# quarter.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12 / 2
PEAK_I32_OPS_S = 67e12 / 4
# Operations per unit of work, counted from each function's formulas (its
# plain version, with every scan taken as a sequential prefix: one max a
# cell), not from the kernel's parallel implementation. One operation =
# one add, subtract, multiply, compare, max, select, shift or bitwise op
# on loop-varying values; constants are folded, bounds checks that a
# sequential loop turns into loop ranges are not counted.
# Gotoh cell of dp_fused_plain: E (2 sub, max, ext > open) 4; substitution
# (compare, select) 2; diagonal add 1; b = max(diag, E) 1; F from its left
# neighbour (2 sub, max, ext > open) 4; H (E > diag, F > b, max) 3; pointer
# byte (code select, 2 shifts, 2 ors) 5; best cell (compare, 2 selects) 3.
DP_OPS_PER_CELL = 23
# chain_rows_plain, one (i, j < i) pair: dq, dt 2; overlap (min, negate,
# clamp, to float) 4; validity (5 compares, 4 ands) 9; gap (2 clamps, sub)
# 3; |gap| to float 2; the cheaper cost branch (compare, multiply, add) 3;
# candidate score (add, sub, multiply, sub) 4; validity select 1; first
# max (compare, 2 selects) 3.
CHAIN_OPS_PER_PAIR = 31
# poa_forward_plain, one stored cell, predecessors aside: absolute column
# 1; band mask (2 compares, or) 3; substitution 2; D1, D2 mask selects 2;
# diagonal add 1; H pick (compare, 2 selects, twice) 6; H mask select 1;
# two insertion tiers at 11 each (e * j, add, prefix max, is-new compare,
# origin select, 2 sub, compare, 3 selects) 22; final mask select 1;
# hpack (2 shifts, add, 2 ors) 5; opack (shift, or) 2; the row's first
# max (compare, 2 selects) 3.
POA_OPS_PER_CELL = 49
# one predecessor's contribution to a cell: diagonal first max (compare,
# 2 selects) 3; D1 and D2 at 8 each (2 sub, max, ext > open, pointer or,
# compare, 2 selects) 16.
POA_OPS_PER_PRED = 19
# poa_walk_plain, the cheapest (diagonal) step: still-active test 5; one
# windowed cell read (sub, 2 compares, and, select) 5; op decode 1;
# node0 (shift, sub) 2; op compare 1; emit (j - 1, r - 1) 2; k + 1 1.
WALK_OPS_PER_STEP = 17
# poa_sweep_plain, the cheapest (diagonal) transition: not-done test 5; one
# windowed cell read 5; op decode 1; node0 2; op compare 1; rec0 (j - 1, the
# type's shift is constant) 1; rec1 (r + 1, shift) 2; k + 1 1. A transition
# that writes no record (entering a deletion) is not counted.
SWEEP_OPS_PER_RECORD = 18
# bytes a record needs read: its row's window offset and one cell (hpack for
# a diagonal, d1p or d2p for a deletion), and opack too for an insertion run
SWEEP_READ_BYTES = {poa.REC_DIAG: 8, poa.REC_DEL: 8, poa.REC_INS: 12}


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def timed(what: str):
    """Logs `seconds: <what> <s>` when the block ends, passed or not."""
    t0 = time.time()
    try:
        yield
    finally:
        log(f"seconds: {what} {time.time() - t0:.1f}")


PR_SET_CHILD_SUBREAPER = 36


def adopt_descendants() -> None:
    """Make this process the reaper of every process below it, so that a
    grandchild whose parent has exited (a worker's resource tracker, say)
    is still found by stop_descendants. Linux only; elsewhere a no-op."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_CHILD_SUBREAPER, 1,
                                                0, 0, 0)
    except (OSError, AttributeError):
        pass


def descendants() -> list:
    """Pids of the processes below this one that have not exited (zombies
    left out), read from /proc."""
    parent, state = {}, {}
    for entry in os.listdir("/proc") if os.path.isdir("/proc") else ():
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        parent[int(entry)], state[int(entry)] = int(fields[1]), fields[0]
    found, frontier = [], [os.getpid()]
    while frontier:
        pid = frontier.pop()
        kids = [p for p, pp in parent.items() if pp == pid]
        found += kids
        frontier += kids
    return [p for p in found if state[p] != "Z"]


def reap() -> None:
    """Collect every child that has exited."""
    while True:
        try:
            pid, _status = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_descendants() -> list:
    """Stop every process still running below this one and reap it: the
    resource tracker by closing its pipe (it ignores SIGTERM and unlinks
    what it still tracks), the rest by SIGTERM, then SIGKILL after 5 s.
    Returns the command lines of the processes other than the tracker
    that had to be stopped."""
    from multiprocessing import resource_tracker
    stop_tracker = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop_tracker is not None:
        stop_tracker()
    left = descendants()
    names = []
    for pid in left:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                names.append(fh.read().replace(b"\0", b" ").decode().strip())
        except OSError:
            pass
    for sig, grace in ((signal.SIGTERM, 5.0), (signal.SIGKILL, 5.0)):
        for pid in left:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        t_end = time.time() + grace
        while left and time.time() < t_end:
            reap()
            time.sleep(0.05)
            left = descendants()
    reap()
    return names


def run(cmd, env=None, **kw) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, **kw)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[:3]} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def cuda_call(fn):
    """(fn(), its wall time in ms on the current stream by CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def bound(n_bytes: float, n_ops: float, peak_ops_s: float):
    """(bound_ms, bound_by): the least time the card could take to move
    n_bytes and to do n_ops."""
    by_bytes = n_bytes / PEAK_BYTES_S * 1e3
    by_ops = n_ops / peak_ops_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


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
                for k in range(2):
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
            want, plain = cuda_call(lambda: kernels.dp_fused_plain(*args))
            e = max_abs_err(got, want)
            if e:
                raise AssertionError(
                    f"dp kernel != plain (rows {lo}..{hi}, end_bonus="
                    f"{cfg.end_bonus}, zdrop={cfg.zdrop}): max err {e}")
            err = max(err, e)
            if cfg.end_bonus == cfg.zdrop == 0:
                ms = cuda_ms(lambda: kernels.dp_fused(*args), 3)
                log(f"dp: rows {lo}..{hi}, {len(sel)} problems (target "
                    f"1..{int(nt[sel].max())}): {ms:.3f} ms vs plain "
                    f"{plain:.3f} ms")
    log(f"dp: {int(nq.numel())} random problems x 4 scorings, kernel == "
        f"plain (rows 1..{int(nq.max())}, target 1..{int(nt.max())})")
    return err


# csrc/dp.cu's layout classes, as (query rows, target bases): strip edges
# (32, 33, 64, 65 rows), pointers in shared memory and in scratch, boundary
# rows in scratch, teams with fewer and with more strips than warps, tall and
# narrow on one warp
DP_LAYOUT_SHAPES = ((32, 300), (32, 2303), (33, 150), (40, 400), (64, 1500),
                    (65, 2303), (100, 2100), (300, 1000), (2048, 700),
                    (2048, 60), (5, 7), (20, 30))
# queries that follow their target for this many rows, then turn random:
# the zdrop latch trips inside a strip (at 1000 rows, inside a team's)
DP_ZDROP_CUTS = (45, 100, 1000)


def check_dp_layouts(device) -> int:
    """Every layout class of csrc/dp.cu in one launch, in each mode, under
    four scorings, against the plain version; zdrop cuts inside a strip.
    Uses a generator of its own, so the phases after it see the parent's
    random numbers."""
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 1 << 20).astype(np.uint8)
    queries, specs = [], []
    for k, (nq, nt) in enumerate(DP_LAYOUT_SHAPES):
        for mode in (0, 1, 2):
            t0 = int(rng.integers(0, len(genome) - nt))
            q = np.concatenate([genome[t0:t0 + nt],
                                rng.integers(0, 4, max(nq - nt, 0))])[:nq]
            q = np.where(rng.random(nq) < (0.08 if k % 2 == 0 else 0.75),
                         rng.integers(0, 4, nq), q)
            queries.append(q.astype(np.uint8))
            specs.append((nq, nt, mode, t0))
    for cut in DP_ZDROP_CUTS:
        for mode in (1, 2):
            # extend_left reads both slices from their ends
            t0 = int(rng.integers(0, len(genome) - 1200))
            follow = genome[t0:t0 + cut] if mode == 1 else \
                genome[t0 + 1200 - cut:t0 + 1200]
            tail = rng.integers(0, 4, 1200 - cut)
            queries.append(np.concatenate(
                [follow, tail] if mode == 1 else [tail, follow]
            ).astype(np.uint8))
            specs.append((1200, 1200, mode, t0))
    nq, nt, mode, t_lo = (np.array([s_[i] for s_ in specs])
                          for i in range(4))
    lay = kernels.dp_layout(nq, nt)
    kinds = dict(shared=int((lay.ptr_off < 0).sum()),
                 scratch=int((lay.ptr_off >= 0).sum()) - (len(nq)
                                                          - lay.n_small),
                 boundary_scratch=int((lay.bnd_off >= 0).sum()),
                 team=len(nq) - lay.n_small)
    if min(kinds.values()) <= 0:
        raise AssertionError(f"dp layout check covers {kinds}")
    q_lo = np.cumsum([0] + [len(q) for q in queries[:-1]])

    def put(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)

    args = (put(genome, np.uint8), put(np.concatenate(queries), np.uint8),
            put(q_lo, np.int64), put(t_lo, np.int64), put(nq, np.int32),
            put(nt, np.int32), put(mode, np.uint8))
    steps = int((nq + nt).max())
    err, cut_rows = 0, []
    for cfg in (AlignConfig(), AlignConfig(end_bonus=12),
                AlignConfig(zdrop=40), AlignConfig(end_bonus=12, zdrop=40)):
        got = kernels.dp_fused(*args, cfg, steps)
        want = kernels.dp_fused_plain(*args, cfg, steps)
        e = max_abs_err(got, want)
        if e:
            raise AssertionError(f"dp kernel != plain on the layout classes "
                                 f"(end_bonus={cfg.end_bonus}, zdrop="
                                 f"{cfg.zdrop}): max err {e}")
        err = max(err, e)
        if cfg.zdrop and not cfg.end_bonus:
            cut_rows = want[0][-2 * len(DP_ZDROP_CUTS):, 0].tolist()
    for k, cut in enumerate(DP_ZDROP_CUTS):
        rows = cut_rows[2 * k:2 * k + 2]
        if not all(cut - 2 <= r <= cut + 5 for r in rows):
            raise AssertionError(f"zdrop after row {cut}: best rows {rows}")
    log(f"dp: layout classes {kinds} (warp share {lay.warp_share} B) in one "
        f"launch, shapes {list(DP_LAYOUT_SHAPES)} x 3 modes and zdrop cuts "
        f"after rows {DP_ZDROP_CUTS} (best rows {cut_rows}), 4 scorings: "
        f"kernel == plain")
    return err


def collinear_rows(n_seg, draw, msb: int = 512):
    """(qs, qe, ts, te, cov) as (n, msb) int32 rows, zero padding: per
    candidate n_seg[b] collinear segments, each placed after the one
    before by draw(k)'s steps, so with indel and intron gaps, overlaps
    and repeats; draw(k) gives k segments' (length, q step, t step, cov
    fraction)."""
    n = len(n_seg)
    qs, qe, ts, te, cov = (np.zeros((n, msb), np.int32) for _ in range(5))
    for b in range(n):
        k = int(n_seg[b])
        ln, dq, dt, frac = draw(k)
        q = np.maximum(np.cumsum(dq + np.concatenate([[0], ln[:-1]])), 0)
        t = np.maximum(np.cumsum(dt + np.concatenate([[0], ln[:-1]])), 0)
        qs[b, :k], qe[b, :k], ts[b, :k], te[b, :k] = q, q + ln, t, t + ln
        cov[b, :k] = np.maximum(15, (ln * frac).astype(np.int32))
    return qs, qe, ts, te, cov


def chain_512_set(rng):
    """64 candidates, 56 of 512 segments and 8 of under 64, as (segs,
    n_seg): sorted collinear segments with indel and intron gaps, overlaps
    and off-diagonal noise, cov <= span."""
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
    return (qs, qe, ts, te, cov), n_seg


def chain_random_sets(rng):
    """The chain kernel's other sets beside the main path, as (segs,
    n_seg): "mixed": 3,000 candidates of 1..40 segments and six of
    300..512, in one launch of 512 lanes (does the longest candidate set
    the time?); "tie-heavy": 600 candidates of duplicated segments and
    equal-cost predecessors (equal lengths and cov, introns inside one
    power of two), up to 64 segments and a few of 300."""
    def random_draw(k):
        return (rng.integers(15, 60, k), rng.integers(-10, 15, k),
                rng.choice([-10, 0, 3, 40, 300, 5000, 60000], k),
                rng.uniform(0.3, 1.0, k))

    def tied_draw(k):
        # each step repeats the segment before it (0), or moves on by an
        # intron of 4,096..8,191 bases (one cost) or by 3 (an indel)
        dup = rng.random(k) < 0.5
        ln = np.full(k, 30)
        step_t = np.where(dup, -30, rng.choice([4100, 5000, 8000, 3], k))
        step_q = np.where(dup, -30, np.where(step_t == 3, 3, 0))
        step_q[:1] = step_t[:1] = 0
        return ln, step_q, step_t, np.ones(k)

    mixed = np.concatenate([rng.integers(1, 41, 3000),
                            [300, 350, 400, 450, 500, 512]]).astype(np.int32)
    rng.shuffle(mixed)
    tied = np.concatenate([rng.integers(0, 65, 596),
                           [300, 300, 1, 0]]).astype(np.int32)
    return {"mixed": (collinear_rows(mixed, random_draw), mixed),
            "tie-heavy": (collinear_rows(tied, tied_draw), tied)}


def chain_bounds(n_seg: np.ndarray, msb: int):
    """The chain's bounds, ((ms, by) from the bytes the work needs: 20 B a
    real segment, n_seg, the rows; (ms, by) from the padded count: every
    lane of the five (n, msb) planes), the same operations for both."""
    s = np.asarray(n_seg, np.int64)
    out = 4 * len(s) + len(s) * (msb + 3) * 2
    ops = float((s * (s - 1) // 2).sum()) * CHAIN_OPS_PER_PAIR
    return (bound(int(s.sum()) * 20 + out, ops, PEAK_F32_OPS_S),
            bound(5 * len(s) * msb * 4 + out, ops, PEAK_F32_OPS_S))


def host_ms(fn, reps: int) -> float:
    """Mean wall time of fn() on the host clock; fn synchronizes."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def time_chain(what, segs, n_seg, kw, device, reps):
    """The chain on one set: the kernel (chain_rows on the card's tensors,
    in the route's order) and the route (chain_batch_rows from the numpy
    arrays) against chain_rows_plain, exactly; then three figures: the
    route's call from the numpy arrays to the fetched rows (host clock),
    the chain_rows call and the launch alone (_chain_rows_cuda), by CUDA
    events; the plain version's time; both bounds. A chain module without
    `chain_order` (an older tree of the port, under --chain-only) is
    called without the order. Returns a dict with the route's rows under
    "rows"."""
    n = len(n_seg)
    msb = chain_kernel.segment_lanes(int(n_seg.max()))
    args = [torch.from_numpy(np.ascontiguousarray(a[:n, :msb])).to(device)
            for a in segs]
    args.append(torch.from_numpy(np.ascontiguousarray(n_seg, np.int32)).to(
        device))
    ordered = {} if not hasattr(chain_kernel, "chain_order") else dict(
        order=args[-1].new_tensor(chain_kernel.chain_order(n_seg)))
    rows = chain_kernel.chain_rows(*args, **kw, **ordered)
    plain = chain_kernel.chain_rows_plain(*args, **kw)
    route = chain_kernel.chain_batch_rows(*segs, n_seg, n, device=device,
                                          **kw)
    err = max(max_abs_err([rows], [plain]),
              max_abs_err([torch.from_numpy(route)], [plain.cpu()]))
    if err:
        raise AssertionError(f"chain kernel != plain on {what}: max err "
                             f"{err}")
    plain_ms = cuda_ms(lambda: chain_kernel.chain_rows_plain(*args, **kw), 1)
    route_ms = host_ms(lambda: chain_kernel.chain_batch_rows(
        *segs, n_seg, n, device=device, **kw), reps)
    call_ms = cuda_ms(lambda: chain_kernel.chain_rows(*args, **kw, **ordered),
                      reps)
    launch_ms = cuda_ms(lambda: chain_kernel._chain_rows_cuda(
        *args, **kw, **ordered), reps)
    need, padded = chain_bounds(n_seg, msb)
    log(f"chain: {what}, {n} candidates x {msb} lanes ({int(n_seg.sum())} "
        f"segments, longest {int(n_seg.max())}), kernel == plain, route == "
        f"plain; route call {route_ms:.3f} ms (host clock), chain_rows "
        f"{call_ms:.3f} ms, launch alone {launch_ms:.3f} ms (CUDA events), "
        f"plain {plain_ms:.3f} ms; bound {need[0]:.6f} ms by {need[1]}, "
        f"20 B a real segment (share of it: launch alone "
        f"{100 * need[0] / launch_ms:.3f}%, the call "
        f"{100 * need[0] / call_ms:.3f}%); padded count, 20 B every lane: "
        f"{padded[0]:.6f} ms by {padded[1]} (the call "
        f"{100 * padded[0] / call_ms:.3f}%)")
    return dict(max_abs_err=err, ms=call_ms, plain_ms=plain_ms,
                bound_ms=need[0], bound_by=need[1], route_ms=route_ms,
                launch_ms=launch_ms, rows=route)


def check_chain_sets(rng, device, reps: int = 5) -> int:
    """The chain kernel exact and timed on chain_512_set (drawn from
    `rng`) and chain_random_sets."""
    err = 0
    sets = {"512-segment": chain_512_set(rng),
            **chain_random_sets(np.random.default_rng(CHAIN_SEED))}
    for what, (segs, n_seg) in sets.items():
        err = max(err, time_chain(f"the {what} set", segs, n_seg, CHAIN_KW,
                                  device, reps)["max_abs_err"])
    return err


def dp_bound(chunks):
    """(bound_ms, bound_by, cells, bytes) of the DP over dp_chunks'
    chunks: every input read once, every output written once."""
    d_bytes = d_cells = 0
    for _idx, desc, steps in chunks:
        c_nq, c_nt = desc[2].long(), desc[3].long()
        # query and target bytes, 25 B of descriptors, meta + ks, buf
        d_bytes += int((c_nq + c_nt).sum()) + len(c_nq) * (25 + 20 + steps)
        d_cells += int((c_nq * (c_nt + 1)).sum())
    return (*bound(d_bytes, d_cells * DP_OPS_PER_CELL, PEAK_I32_OPS_S),
            d_cells, d_bytes)


def check_first_batch(aligner, reads, device):
    """Both kernels against their plain versions on the first read batch's
    real inputs (module A's batch: max(batch_reads, n_reads / 3) reads),
    timed by CUDA events. Returns per-kernel dicts of max_abs_err, ms,
    plain_ms, bound_ms, bound_by."""
    cfg = aligner.cfg
    t0 = time.time()
    codes_all, read_off, seeded = aligner.seed_batch(reads)
    seed_s = time.time() - t0
    n_cand, _r, _s, _c, _t, n_seg, segs = seeded
    kw = dict(min_intron=cfg.min_intron, max_intron=cfg.max_intron)
    chain = time_chain("the first batch", segs, n_seg[:n_cand], kw, device,
                       5)

    t0 = time.time()
    _st, _ch, oriented, _ro, _runs, probs = aligner.fill_batch(
        codes_all, read_off, seeded, chain.pop("rows"))
    fill_s = time.time() - t0
    oriented_t = torch.from_numpy(oriented).to(device)
    chunks = list(kernels.dp_chunks(probs, read_off, device))
    genome = aligner.genome_codes
    d_err = 0
    for _idx, desc, steps in chunks:
        lay = kernels.dp_layout(desc[2].cpu().numpy(), desc[3].cpu().numpy())
        if (lay.ptr_off >= 0).any() or lay.n_small != len(lay.order):
            raise AssertionError("dp: a problem of the first batch keeps its "
                                 "pointers in scratch")
        log(f"dp: first batch chunk of {len(lay.order)} problems: pointers "
            f"of all in shared memory, {lay.warp_share} B a warp, "
            f"{int((lay.bnd_off >= 0).sum())} boundary rows in scratch")
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
    d_bound = dp_bound(chunks)
    log(f"bounds: dp {d_bound[0]:.6f} ms by {d_bound[1]} ({d_bound[2]} "
        f"cells, {d_bound[3]} bytes)")
    torch.cuda.synchronize()
    t0 = time.time()
    aligner.map_batch(reads)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    log(f"module A first batch ({len(reads)} reads), host clock: map_batch "
        f"{total_s * 1e3:.1f} ms = C seed {seed_s * 1e3:.1f} + chain route "
        f"{chain['route_ms']:.1f} (launch alone {chain['launch_ms']:.3f}) + "
        f"C fill {fill_s * 1e3:.1f} + dp kernel {d_ms:.1f} + C emit, "
        f"uploads, checks and records "
        f"{(total_s - seed_s - fill_s) * 1e3 - chain['route_ms'] - d_ms:.1f}")
    return {"dp_fused": dict(max_abs_err=d_err, ms=d_ms, plain_ms=d_plain,
                             bound_ms=d_bound[0], bound_by=d_bound[1]),
            "chain_rows": {k: chain[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}}


# ---------------------------------------------------------------- POA

def noisy_copy(rng, base: np.ndarray, err: float) -> np.ndarray:
    """`base` with substitutions, 1-base insertions and deletions, each at
    a rate of err / 3."""
    u = rng.random(len(base))
    sub = (u >= 2 * err / 3) & (u < err)
    out = np.where(sub, rng.integers(0, 4, len(base)), base).astype(np.uint8)
    ins = (u >= err / 3) & (u < 2 * err / 3)
    pairs = np.stack([out, rng.integers(0, 4, len(base)).astype(np.uint8)],
                     axis=1)
    keep = np.stack([u >= err / 3, ins], axis=1)
    return pairs[keep]


def poa_problem_tensors(arrays, params, W, device):
    """A chunk's numpy arrays as (the arguments of poa_forward and
    poa_forward_plain, (nn, ends, ql) for the walks)."""
    base, preds, nn, ends, qq, ql, band = poa.problems_from_numpy(*arrays,
                                                                  device)
    return (base, preds, nn, qq, ql, params, W, band), (nn, ends, ql)


def check_poa_chunk(what, arrays, params, W, l_cap, device,
                    sweep_only=False, plain_ms=None):
    """Forward, step walk and record walk kernels against their plain
    versions on one chunk: the matrices' rows 0..nn[b] (the kernel leaves
    the rows past nn[b] unwritten, `clear_rows_past`), buf[:ks] and ks,
    recs[:counts] and counts; and the records, expanded on the host,
    against the step kernel's steps.
    With sweep_only the plain record walk reads the kernel's matrices and
    neither the forward nor the step walk is compared with its plain
    version (a plain walk costs a millisecond a step). Returns the
    measured largest differences (forward, walk, sweep); raises unless
    all are 0. A dict given as plain_ms receives each plain version's
    time of its one call here, by CUDA events."""
    fwd_in, (nn, ends, ql) = poa_problem_tensors(arrays, params, W, device)
    mats = poa.poa_forward(*fwd_in)
    buf, ks = poa.poa_walk(nn, ends, ql, mats, l_cap)
    recs, counts = poa.poa_sweep(nn, ends, ql, mats)
    torch.cuda.synchronize()

    def live(rows, n):
        return rows * (torch.arange(rows.shape[1], device=device)
                       [None, :, None] < n[:, None, None])

    times = {} if plain_ms is None else plain_ms
    e_fwd = e_walk = 0
    want = mats
    if not sweep_only:
        want, times["poa_fwd"] = cuda_call(
            lambda: poa.poa_forward_plain(*fwd_in))
        e_fwd = max_abs_err(poa.clear_rows_past(mats, nn), want)
        (want_buf, want_ks), times["poa_walk"] = cuda_call(
            lambda: poa.poa_walk_plain(nn, ends, ql, want, l_cap))
        e_walk = max_abs_err([ks, live(buf, want_ks)],
                             [want_ks, live(want_buf, want_ks)])
    (want_recs, want_counts), times["poa_sweep"] = cuda_call(
        lambda: poa.poa_sweep_plain(nn, ends, ql, want))
    e_sweep = max_abs_err([counts, live(recs, want_counts)],
                          [want_counts, live(want_recs, want_counts)])
    if e_fwd or e_walk or e_sweep:
        raise AssertionError(f"poa kernels != plain on {what}: forward max "
                             f"err {e_fwd}, walk max err {e_walk}, sweep "
                             f"max err {e_sweep}")
    buf_h, ks_h = buf.cpu().numpy(), ks.cpu().numpy()
    recs_h, counts_h = recs.cpu().numpy(), counts.cpu().numpy()
    for b in range(len(ks_h)):
        steps = poa.expand_walk_records(recs_h[b], int(counts_h[b]))
        if not np.array_equal(steps, buf_h[b, :ks_h[b]]):
            raise AssertionError(f"{what}: problem {b}'s records do not "
                                 f"expand to the step walk's steps")
    log(f"poa: {what}: {len(nn)} problems, rows <= {int(nn.max())}, W {W}, "
        f"steps <= {int(ks.max())}, records <= {int(counts.max())}: "
        + ("sweep kernel" if sweep_only else "forward, walk and sweep kernels")
        + " == plain, records expand to the step kernel's steps")
    return e_fwd, e_walk, e_sweep


def capture_consensus(sets, params, device, rounds, bands=None):
    """poa_consensus_batch on the card, keeping the chunks of `rounds`:
    (consensi, [(round, W, l_cap, arrays)])."""
    poa.OBSERVER = obs = poa.RunObserver(keep_rounds=rounds)
    try:
        consensi = poa.poa_consensus_batch(sets, params, device, bands=bands)
    finally:
        poa.OBSERVER = None
    return consensi, obs.kept


def check_ring_and_tile(rng, device):
    """Case (c), second graph: predecessors inside and beyond the forward's
    shared-memory ring in one problem at W = 256, its last (fourth) round
    against the plain versions (the first has only predecessors one row
    back, as in (a)); the last round's path must
    leave the step walk's tile every way there is: deletions, an
    insertion run, a branch to a predecessor beyond the tile."""
    cfg = POA_RING
    true = rng.integers(0, 4, cfg["length"]).astype(np.uint8)
    half = cfg["length"] // 2
    with_ins = np.concatenate([true[:half],
                               rng.integers(0, 4, cfg["insert"]).astype(
                                   np.uint8), true[half:]])
    last = noisy_copy(rng, true, 0.02)
    last = np.concatenate([last[:300], last[300 + cfg["deleted"]:900],
                           rng.integers(0, 4, cfg["inserted"]).astype(
                               np.uint8), last[900:]])
    reads = [true, with_ins, noisy_copy(rng, true, 0.02),
             noisy_copy(rng, with_ins, 0.02), last]
    params = PoaParams(band=cfg["band"], adaptive=True)
    consensi, kept = capture_consensus([reads], params, device,
                                       range(1, len(reads)))
    if consensi[0].tolist() != native_poa_consensus(reads, params).tolist():
        raise AssertionError("(c) ring graph: consensus on the card != "
                             "native engine")
    errs = []
    for k, W, l_cap, arrays in kept[-1:]:
        preds, n = arrays[1][0], int(arrays[2][0])
        back = np.where(preds[:n] >= 1,
                        np.arange(1, n + 1)[:, None] - preds[:n], 0)
        if not (W == 256 and (back == 1).any()
                and back.max() > max(RING_ROWS, TILE_ROWS)):
            raise AssertionError(f"(c) ring graph, round {k}: W {W}, "
                                 f"back-distances to {back.max()}")
        errs.append(check_poa_chunk(
            f"(c) ring graph, round {k}, predecessors 1..{back.max()} rows "
            f"back", arrays, params, W, l_cap, device))
    fwd_in, (nn, ends, ql) = poa_problem_tensors(arrays, params, W, device)
    buf, ks = poa.poa_walk(nn, ends, ql, poa.poa_forward(*fwd_in), l_cap)
    steps = buf[0, :int(ks[0])].cpu().numpy()
    diag = steps[(steps[:, 0] >= 0) & (steps[:, 1] >= 0), 1]
    n_del, n_ins = int((steps[:, 0] < 0).sum()), int((steps[:, 1] < 0).sum())
    branch = int((diag[:-1] - diag[1:]).max())
    if n_del < cfg["deleted"] or n_ins < cfg["inserted"] \
            or branch <= TILE_ROWS:
        raise AssertionError(f"(c) ring graph: the last path has {n_del} "
                             f"deletions, {n_ins} inserted bases and a "
                             f"branch of {branch} rows")
    turns = time_walks(arrays, params, W, l_cap, device)
    log(f"poa: (c) ring graph: the last round's path of {len(steps)} steps "
        f"has {n_del} deleted nodes, {n_ins} inserted bases and a diagonal "
        f"step {branch} rows back; walks on its chunk, turns of 3 launches, "
        f"steps records records steps: "
        + " ".join(f"{ms:.3f}" for ms in turns) + " ms")
    return errs


def check_mixed_bands(sets, device):
    """Case (f): POA_SETS' isoforms under POA_MIXED_BANDS in one call.
    Consensi against the native engine at each isoform's band; on a middle
    round's chunk the kernels against their plain versions, and every
    problem's matrices against a launch that holds its band alone."""
    bands = [POA_MIXED_BANDS[i % len(POA_MIXED_BANDS)]
             for i in range(len(sets))]
    params = PoaParams(adaptive=True)
    mid = (len(sets[0]) - 1) // 2
    consensi, kept = capture_consensus(sets, params, device, {mid}, bands)
    for reads, band, got in zip(sets, bands, consensi):
        want = native_poa_consensus(reads, PoaParams(band=band,
                                                     adaptive=True))
        if got.tolist() != want.tolist():
            raise AssertionError(f"(f) consensus under band {band} on the "
                                 f"card != native engine")
    if len(kept) != 1 or len(kept[0][3][2]) != len(sets):
        raise AssertionError(f"(f) round {mid} was {len(kept)} chunks")
    _k, W, l_cap, arrays = kept[0]
    errs = check_poa_chunk(f"(f) round {mid}, bands "
                           f"{sorted(set(bands))} in one chunk", arrays,
                           params, W, l_cap, device)
    fwd_in, (nn, _ends, _ql) = poa_problem_tensors(arrays, params, W, device)
    mixed = poa.clear_rows_past(poa.poa_forward(*fwd_in), nn)
    for band in sorted(set(bands)):
        idx = np.flatnonzero(arrays[6] == band)
        alone_in, (nn_b, _e, _q) = poa_problem_tensors(
            tuple(a[idx] for a in arrays), PoaParams(band=band,
                                                     adaptive=True),
            W, device)
        # the band from the params, the tensor left out
        alone = poa.clear_rows_past(poa.poa_forward(*alone_in[:-1]), nn_b)
        at = torch.from_numpy(idx).to(device)
        e = max_abs_err([m[at] for m in mixed], alone)
        if e:
            raise AssertionError(f"(f) band {band}: matrices in the mixed "
                                 f"chunk differ from the band's own launch "
                                 f"by {e}")
    log(f"poa: (f) {len(sets)} isoforms under bands {bands[:4]} in turns: "
        f"consensi == native engine; round {mid} is one chunk, and each "
        f"band's matrices == that band launched alone")
    return errs


def time_walks(arrays, params, W, l_cap, device):
    """The step walk and the record walk on one chunk's matrices, by CUDA
    events, in turns (steps, records, records, steps) of 3 launches each
    after one untimed launch of each: the four times in ms."""
    fwd_in, (nn, ends, ql) = poa_problem_tensors(arrays, params, W, device)
    mats = poa.poa_forward(*fwd_in)

    def by_steps():
        poa.poa_walk(nn, ends, ql, mats, l_cap)

    def by_records():
        poa.poa_sweep(nn, ends, ql, mats)

    # the untimed launches: a plain version before this leaves the card
    # cold, and the first timed turn would pay for it
    by_steps()
    by_records()
    return [cuda_ms(fn, 3) for fn in (by_steps, by_records, by_records,
                                      by_steps)]


def ladder_problem(n_cap: int, device):
    """One problem whose rows n_cap .. 1 are a ladder of diagonal steps (row
    r into row r - 1) and whose row 1 leads back up to row n_cap, over query
    columns 145..400: the walk climbs the ladder, 32 diagonal steps a tile,
    until a bound cuts it (the forward never writes such a loop)."""
    W, qlen, off = 256, 400, 145
    rows = n_cap + 1
    node = np.arange(rows) + 1
    node[1] = n_cap + 2
    hpack = np.zeros((1, rows, W), np.int32)
    hpack[0, 1:] = (node[1:] << 6)[:, None]
    zeros = np.zeros_like(hpack)
    endcol = np.full((1, rows), -10 ** 9, np.int32)
    endcol[0, n_cap] = 5
    ends = np.zeros((1, n_cap), np.uint8)
    ends[0, n_cap - 1] = 1
    mats = tuple(torch.from_numpy(m).to(device) for m in
                 (hpack, zeros, zeros, zeros,
                  np.full((1, rows), off, np.int32), endcol))
    return (torch.tensor([n_cap], dtype=torch.int32, device=device),
            torch.from_numpy(ends).to(device),
            torch.tensor([qlen], dtype=torch.int32, device=device), mats)


def check_sweep_cuts(device) -> int:
    """The record walk's two bounds on a ladder: max_rec cuts a tile's
    diagonal records (n_cap 64), the 3 x rows transitions cut first (n_cap
    4); kernel == plain, record for record."""
    err = 0
    for n_cap, cut in ((64, poa.sweep_record_cap(64)), (4, 3 * 5)):
        nn, ends, ql, mats = ladder_problem(n_cap, device)
        recs, counts = poa.poa_sweep(nn, ends, ql, mats)
        want, want_counts = poa.poa_sweep_plain(nn, ends, ql, mats)
        err = max(err, max_abs_err([counts, recs[:, :cut]],
                                   [want_counts, want[:, :cut]]))
        if err or int(counts[0]) != cut:
            raise AssertionError(f"record walk on a ladder of {n_cap} rows: "
                                 f"{int(counts[0])} records (cut at {cut}), "
                                 f"max err {err}")
    log("poa: record walk on ladders: cut at max_rec inside a tile and at 3 "
        "x rows transitions, kernel == plain")
    return err


def check_poa_cases(rng, device):
    """Cases (a) to (f) of the module docstring. Returns the measured
    largest differences (forward, walk, sweep) over every chunk compared,
    and case (a)'s (sets, adaptive params)."""
    errs = []
    t_case = time.time()
    cfg = POA_SETS
    sets = []
    for _ in range(cfg["n_iso"]):
        true = rng.integers(0, 4, cfg["length"] + int(rng.integers(-200, 200))
                            ).astype(np.uint8)
        sets.append([noisy_copy(rng, true, cfg["err"])
                     for _ in range(cfg["n_reads"])])
    band = max(16, 10 + cfg["length"] // 100)
    adaptive = PoaParams(band=band, adaptive=True)
    last = cfg["n_reads"] - 1
    consensi, kept = capture_consensus(sets, adaptive, device,
                                       {1, last // 2, last})
    for reads, got in zip(sets, consensi):
        if got.tolist() != native_poa_consensus(reads, adaptive).tolist():
            raise AssertionError("poa consensus on the card != native engine")
    log(f"poa: {cfg['n_iso']} isoforms x {cfg['n_reads']} reads x about "
        f"{cfg['length']} bases: consensi on the card == native engine")
    static = PoaParams(band=band, adaptive=False)
    for k, W, l_cap, arrays in kept:
        # the adaptive band at the first round; the static band where its
        # width is over 256 (the middle and last rounds)
        if k == 1:
            errs.append(check_poa_chunk(f"(a) round {k}, adaptive band",
                                        arrays, adaptive, W, l_cap, device))
        nn, ql = arrays[2], arrays[5]
        w_static = max(poa._item_width(int(n), int(q), band, l_cap, False)
                       for n, q in zip(nn, ql))
        if k != 1:
            errs.append(check_poa_chunk(f"(b) round {k}, static band",
                                        arrays, static, w_static, l_cap,
                                        device))
    log(f"seconds: phase 3 poa (a)-(b) {time.time() - t_case:.1f}")
    t_case = time.time()

    cfg = POA_LONG_EDGE
    true = rng.integers(0, 4, cfg["length"]).astype(np.uint8)
    half = cfg["length"] // 2
    with_ins = np.concatenate([true[:half],
                               rng.integers(0, 4, cfg["insert"]).astype(
                                   np.uint8), true[half:]])
    reads = [true, with_ins, noisy_copy(rng, true, 0.02),
             noisy_copy(rng, with_ins, 0.02), noisy_copy(rng, true, 0.02)]
    params = PoaParams(band=cfg["band"], adaptive=True)
    consensi, kept = capture_consensus([reads], params, device,
                                       range(1, len(reads)))
    if consensi[0].tolist() != native_poa_consensus(reads, params).tolist():
        raise AssertionError("(c) consensus on the card != native engine")
    far = [(poa.max_back_distance(a[1][0], int(a[2][0])), k, W, l_cap, a)
           for k, W, l_cap, a in kept]
    back, k, W, l_cap, arrays = max(far, key=lambda f: f[0])
    if back <= 256:
        raise AssertionError(f"(c) back-distance {back} <= 256")
    errs.append(check_poa_chunk(f"(c) round {k}, predecessor {back} rows "
                                f"back", arrays, params, W, l_cap, device))
    errs += check_ring_and_tile(rng, device)
    log(f"seconds: phase 3 poa (c) {time.time() - t_case:.1f}")
    t_case = time.time()
    errs.append(check_mixed_bands(sets, device))
    log(f"seconds: phase 3 poa (f) {time.time() - t_case:.1f}")
    t_case = time.time()

    cfg = POA_LONG_QUERY
    true = rng.integers(0, 4, cfg["length"]).astype(np.uint8)
    with_ins = np.concatenate([true[:cfg["at"]],
                               rng.integers(0, 4, cfg["insert"]).astype(
                                   np.uint8), true[cfg["at"]:]])
    third = with_ins.copy()
    hit = rng.random(len(third)) < 0.005
    third[hit] = rng.integers(0, 4, int(hit.sum()))
    reads = [true, with_ins, third]
    params = PoaParams(band=cfg["band"], adaptive=True)
    t0 = time.time()
    consensi, kept = capture_consensus([reads], params, device, {1})
    card_s = time.time() - t0
    if consensi[0].tolist() != native_poa_consensus(reads, params).tolist():
        raise AssertionError("(d) consensus on the card != native engine")
    # round 1's walk must cross a tier-2 insertion whose origin column is
    # >= 32768: a run of `insert` inserted bases ending behind that column
    _k, W, l_cap, arrays = kept[0]
    fwd_in, (nn, ends, ql) = poa_problem_tensors(arrays, params, W, device)
    buf, ks = poa.poa_walk(nn, ends, ql, poa.poa_forward(*fwd_in), l_cap)
    steps = buf[0, :int(ks[0])].cpu().numpy()
    inserted = steps[steps[:, 1] < 0, 0]
    if len(inserted) < cfg["insert"] or inserted.min() < cfg["at"] - 100:
        raise AssertionError(f"(d) the walk found no {cfg['insert']}-base "
                             f"insertion near column {cfg['at']}: "
                             f"{inserted[:50]}")
    log(f"poa: (d) queries of {len(with_ins)} bases, {len(inserted)} bases "
        f"inserted from column {int(inserted.min())} on (a tier-2 origin), "
        f"W {W}: consensus on the card == native engine ({card_s:.1f}s)")
    # its graphs hold more nodes than a record's rank field: asked for
    # records, every chunk must take the step walk
    swept, n_sweep, n_walk, caps, _kept = consensus_by_records(
        [reads], params, device)
    if swept[0].tolist() != consensi[0].tolist() or n_sweep != 0 \
            or n_walk != len(caps) or min(caps) + 2 < poa.SWEEP_RANK_LIMIT:
        raise AssertionError(f"(d) row caps {caps} asked for records: "
                             f"{n_sweep} sweep and {n_walk} walk launches")
    log(f"poa: (d) asked for records, row caps {caps} are over the rank "
        f"limit: {n_walk} step walk launches, {n_sweep} sweep launches, "
        f"same consensus")
    log(f"seconds: phase 3 poa (d) {time.time() - t_case:.1f}")
    t_case = time.time()

    cfg = POA_LONG_RUNS
    true = rng.integers(0, 4, cfg["length"]).astype(np.uint8)
    pieces = []
    for lo in range(0, cfg["length"], cfg["every"]):
        pieces += [true[lo:lo + cfg["every"]],
                   rng.integers(0, 4, cfg["insert"]).astype(np.uint8)]
    with_runs = np.concatenate(pieces[:-1])
    reads = [true, with_runs, true.copy()]
    params = PoaParams(band=cfg["band"], adaptive=True)
    swept, n_sweep, n_walk, caps, kept = consensus_by_records(
        [reads], params, device, {1})
    if swept[0].tolist() != native_poa_consensus(reads, params).tolist():
        raise AssertionError("(e) consensus by records != native engine")
    # round 1 is under the rank limit, round 2's graph has grown over it
    if (n_sweep, n_walk) != (1, 1):
        raise AssertionError(f"(e) row caps {caps}: {n_sweep} sweep and "
                             f"{n_walk} walk launches, expected 1 and 1")
    _k, W, l_cap, arrays = kept[0]
    errs.append(check_poa_chunk(f"(e) round 1, an insertion run behind "
                                f"column {cfg['behind']}", arrays, params, W,
                                l_cap, device, sweep_only=True))
    fwd_in, (nn, ends, ql) = poa_problem_tensors(arrays, params, W, device)
    recs, counts = poa.poa_sweep(nn, ends, ql, poa.poa_forward(*fwd_in))
    live = recs[0, :int(counts[0])].cpu().numpy()
    runs = live[live[:, 0] >> 16 == poa.REC_INS]
    origins = runs[:, 1] & 0xFFFF
    long_runs = (runs[:, 0] & 0xFFFF) - origins + 1 >= cfg["insert"]
    if not (long_runs & (origins >= cfg["behind"])).any():
        raise AssertionError(f"(e) no run of {cfg['insert']} inserted bases "
                             f"with its origin behind column "
                             f"{cfg['behind']}: origins "
                             f"{origins[long_runs][:8]}")
    log(f"poa: (e) graph of {cfg['length']} nodes, query of "
        f"{len(with_runs)} bases, {int(long_runs.sum())} runs of >= "
        f"{cfg['insert']} inserted bases, origins up to "
        f"{int(origins[long_runs].max())}, {len(live)} records; by records "
        f"== native engine, row caps {caps}: {n_sweep} sweep + {n_walk} "
        f"step walk launches")
    turns = time_walks(arrays, params, W, l_cap, device)
    log("poa: (e) round 1's chunk, walks in turns of 3 launches, steps "
        "records records steps: " + " ".join(f"{ms:.3f}" for ms in turns)
        + " ms")
    errs.append((0, 0, check_sweep_cuts(device)))
    log(f"seconds: phase 3 poa (e) and ladders {time.time() - t_case:.1f}")
    return tuple(max(e[i] for e in errs) for i in range(3)), (sets,
                                                              adaptive)


def consensus_by_records(sets, params, device, rounds=()):
    """poa_consensus_batch(walk="sweep") on the card, keeping the chunks
    of `rounds`: (consensi, poa_sweep launches, poa_walk launches, the
    chunks' row caps, [(round, W, l_cap, arrays)])."""
    before = (poa.POA_SWEEP_LAUNCHES.count, poa.POA_WALK_LAUNCHES.count)
    poa.OBSERVER = obs = poa.RunObserver(keep_rounds=rounds)
    try:
        consensi = poa.poa_consensus_batch(sets, params, device, "sweep")
    finally:
        poa.OBSERVER = None
    return (consensi, poa.POA_SWEEP_LAUNCHES.count - before[0],
            poa.POA_WALK_LAUNCHES.count - before[1],
            [c[1] for c in obs.chunks], obs.kept)


def tallest_problems(arrays, count: int):
    """The `count` problems of most graph rows of a chunk, as a chunk of
    their own, its row cap cut to what they need."""
    base, preds, nn, ends, qq, ql, band = arrays
    idx = np.sort(np.argsort(nn, kind="stable")[-count:])
    n_cap = poa._rank_cap(int(nn[idx].max()))
    return (base[idx, :n_cap], preds[idx, :n_cap], nn[idx],
            ends[idx, :n_cap], qq[idx], ql[idx], band[idx])


def time_poa_kernels(arrays, params, W, l_cap, device):
    """(forward ms, step walk ms, walk steps) of one chunk by CUDA events,
    the forward's mean of 3 launches, the walk's of 6 after one untimed."""
    fwd_in, (nn, ends, ql) = poa_problem_tensors(arrays, params, W, device)
    mats = poa.poa_forward(*fwd_in)
    _buf, ks = poa.poa_walk(nn, ends, ql, mats, l_cap)
    f_ms = cuda_ms(lambda: poa.poa_forward(*fwd_in), 3)
    w_ms = cuda_ms(lambda: poa.poa_walk(nn, ends, ql, mats, l_cap), 6)
    return f_ms, w_ms, int(ks.sum())


def check_poa_main_path(largest, device) -> dict:
    """The largest chunk module D dispatched in the slice run: kernels
    against plain, timed by CUDA events, with their bounds; and the
    forward and the step walk timed on its five tallest problems alone,
    the shape of the largest chunk while a round was split by band."""
    arrays, W, l_cap, params = largest
    plain_ms = {}
    e_fwd, e_walk, e_sweep = check_poa_chunk(
        "module D's largest chunk", arrays, params, W, l_cap, device,
        plain_ms=plain_ms)
    five = tallest_problems(arrays, 5)
    f5_ms, w5_ms, steps5 = time_poa_kernels(five, params, W, l_cap, device)
    log(f"poa: the largest chunk's five tallest problems alone (n_cap "
        f"{five[0].shape[1]}, rows {five[2].tolist()}, W {W}, {steps5} walk "
        f"steps): forward {f5_ms:.3f} ms, walk {w5_ms:.3f} ms")
    fwd_in, (nn, ends, ql) = poa_problem_tensors(arrays, params, W, device)
    mats = poa.poa_forward(*fwd_in)
    _buf, ks = poa.poa_walk(nn, ends, ql, mats, l_cap)
    recs, counts = poa.poa_sweep(nn, ends, ql, mats)
    f_ms = cuda_ms(lambda: poa.poa_forward(*fwd_in), 3)
    turn_ms = time_walks(arrays, params, W, l_cap, device)
    w_ms = (turn_ms[0] + turn_ms[3]) / 2
    s_ms = (turn_ms[1] + turn_ms[2]) / 2
    f_plain, w_plain, s_plain = (plain_ms[k] for k in (
        "poa_fwd", "poa_walk", "poa_sweep"))
    base, preds, nn_a, _ends, qq, _ql, band = arrays
    rows = nn_a.astype(np.int64)
    cells = int(((rows + 1) * W).sum())
    n_preds = int(sum((preds[b, :n] >= 0).sum() for b, n in enumerate(rows)))
    # inputs read once (the rows of base and preds up to nn, the queries,
    # the bands); outputs written once: four matrices, offs and endcol,
    # rows 0..nn
    f_bytes = int((rows * (1 + preds.shape[2]) * 4).sum()) + qq.size * 4 \
        + band.size * 4 + cells * 16 + int(((rows + 1) * 8).sum())
    f_bound = bound(f_bytes, cells * POA_OPS_PER_CELL
                    + n_preds * W * POA_OPS_PER_PRED, PEAK_I32_OPS_S)
    n_steps = int(ks.sum())
    # per step at most two 4-byte cells and a window offset read, 8 bytes
    # written; the end-rank scan reads endcol and the end flags up to nn
    w_bound = bound(n_steps * 20 + int((rows * 5).sum()),
                    n_steps * WALK_OPS_PER_STEP, PEAK_I32_OPS_S)
    # per record what its type reads (SWEEP_READ_BYTES) and 8 bytes
    # written; the same end-rank scan
    recs_h, counts_h = recs.cpu().numpy(), counts.cpu().numpy()
    types = np.concatenate([recs_h[b, :k, 0] >> 16 & 3
                            for b, k in enumerate(counts_h)])
    by_type = {t: int((types == t).sum()) for t in SWEEP_READ_BYTES}
    n_recs = len(types)
    s_bound = bound(sum(n * SWEEP_READ_BYTES[t] for t, n in by_type.items())
                    + n_recs * 8 + int((rows * 5).sum()),
                    n_recs * SWEEP_OPS_PER_RECORD, PEAK_I32_OPS_S)
    log(f"poa: module D's largest chunk: {len(rows)} problems, n_cap "
        f"{base.shape[1]}, W {W}, {cells} cells, {n_preds} predecessors, "
        f"{n_steps} walk steps; forward {f_ms:.3f} ms vs plain "
        f"{f_plain:.3f} ms, bound {f_bound[0]:.6f} ms by {f_bound[1]}; walk "
        f"{w_ms:.3f} ms vs plain {w_plain:.3f} ms, bound {w_bound[0]:.6f} ms "
        f"by {w_bound[1]}")
    log(f"poa: module D's largest chunk: {n_recs} records "
        f"({by_type[poa.REC_DIAG]} diagonal, {by_type[poa.REC_DEL]} deletion, "
        f"{by_type[poa.REC_INS]} insertion runs) for the {n_steps} steps; "
        f"sweep {s_ms:.3f} ms vs plain {s_plain:.3f} ms, bound "
        f"{s_bound[0]:.6f} ms by {s_bound[1]}; turns of 3 launches, walk "
        f"sweep sweep walk: " + " ".join(f"{ms:.3f}" for ms in turn_ms)
        + " ms")
    return {"poa_fwd": dict(max_abs_err=e_fwd, ms=f_ms, plain_ms=f_plain,
                            bound_ms=f_bound[0], bound_by=f_bound[1]),
            "poa_walk": dict(max_abs_err=e_walk, ms=w_ms, plain_ms=w_plain,
                             bound_ms=w_bound[0], bound_by=w_bound[1]),
            "poa_sweep": dict(max_abs_err=e_sweep, ms=s_ms, plain_ms=s_plain,
                              bound_ms=s_bound[0], bound_by=s_bound[1])}


# -------------------------------------------------------------- slice

KERNELS = (
    ("dp_fused", "mandalorion_tpu_torch/csrc/dp.cu",
     "mandalorion_tpu/align/kernels.py:186", kernels.DP_LAUNCHES),
    ("chain_rows", "mandalorion_tpu_torch/csrc/chain.cu",
     "mandalorion_tpu/align/chain_kernel.py:30",
     chain_kernel.CHAIN_LAUNCHES),
    ("poa_fwd", "mandalorion_tpu_torch/csrc/poa_fwd.cu",
     "mandalorion_tpu/poa/pallas_kernel.py:104", poa.POA_FWD_LAUNCHES),
    ("poa_walk", "mandalorion_tpu_torch/csrc/poa_walk.cu",
     "mandalorion_tpu/poa/kernels.py:308", poa.POA_WALK_LAUNCHES),
    ("poa_sweep", "mandalorion_tpu_torch/csrc/poa_sweep.cu",
     "mandalorion_tpu/poa/pallas_kernel.py:469", poa.POA_SWEEP_LAUNCHES),
)
# the device route's runs, in turns; they give the launch counts that are
# reported
ROUTE_TURNS = ("steps", "sweep")


def run_device_route(out_dir, inputs, walk, keep_largest) -> dict:
    """The slice through `mando-tpu-torch --device cuda --consensus_backend
    device`, module D's tracebacks by `walk`, with every launch counter
    set to 0 just before and read just after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    poa.OBSERVER = stats = poa.RunObserver(time_kernels=True,
                                           keep_largest=keep_largest)
    if walk == "sweep":
        os.environ["MANDO_POA_SWEEP"] = "1"
    for *_names, counter in KERNELS:
        counter.count = 0
    t0 = time.time()
    try:
        port_cli.main(["-p", out_dir, *inputs, "--device", "cuda",
                       "--consensus_backend", "device"])
        torch.cuda.synchronize()
    finally:
        poa.OBSERVER = None
        os.environ.pop("MANDO_POA_SWEEP", None)
    seconds = time.time() - t0
    launches = {name: counter.count for name, *_r, counter in KERNELS}
    return dict(walk=walk, seconds=seconds, launches=launches, stats=stats,
                peak=torch.cuda.max_memory_allocated(),
                stages=stage_seconds(out_dir), kernel_ms=stats.kernel_ms())


def check_route_launches(run: dict) -> None:
    """The counters must show the walk that was asked for: in a step run
    no sweep; in a record run a sweep for every chunk under the rank
    limit and a step walk for the rest. dp, chain and forward always: the
    forward once a chunk, and a chunk is a whole round of one width class
    (isoforms of every band together), so more than six problems in the
    fullest."""
    launches, chunks = run["launches"], run["stats"].chunks
    if len(chunks) != len({(c[4], c[2]) for c in chunks}) \
            or max(c[0] for c in chunks) <= 6:
        raise AssertionError(f"{run['walk']} run: {len(chunks)} chunks for "
                             f"{len({(c[4], c[2]) for c in chunks})} (round, "
                             f"width class) pairs, at most "
                             f"{max(c[0] for c in chunks)} problems a chunk")
    swept = sum(poa.chunk_walk(run["walk"], c[1]) == "sweep" for c in chunks)
    want = dict(poa_fwd=len(chunks), poa_sweep=swept,
                poa_walk=len(chunks) - swept)
    got = {name: launches[name] for name in want}
    if got != want or min(launches["dp_fused"], launches["chain_rows"],
                          launches["poa_fwd"]) <= 0 \
            or (run["walk"] == "sweep") != (swept > 0):
        raise AssertionError(f"{run['walk']} run: launches {launches}, "
                             f"expected {want} for {len(chunks)} chunks")


def small_slice(tmp):
    """SMALL_DATASET through the host route (a process of its own) and
    once through the device route by steps, byte-identical: the inputs,
    host artifacts and stage seconds, the device turn and the read count
    that phases 5-8 compare with."""
    d = os.path.join(tmp, "small")
    n_reads = TOOL.make_dataset_files(d, **SMALL_DATASET)
    inputs = ["-G", os.path.join(d, "genome.fasta"),
              "-g", os.path.join(d, "ann.gtf"),
              "-f", os.path.join(d, "reads.fasta")]
    host_dir = os.path.join(d, "host")
    host_s = host_runs([(host_dir, inputs)])
    turn = run_device_route(os.path.join(d, "port"), inputs, "steps",
                            keep_largest=False)
    ref = artifact_bytes(host_dir)
    if artifact_bytes(os.path.join(d, "port")) != ref:
        raise AssertionError("the smaller slice: the device route's "
                             "artifacts differ from the host run")
    if min(turn["launches"][k] for k in ("dp_fused", "chain_rows",
                                         "poa_fwd", "poa_walk")) <= 0:
        raise AssertionError(f"the smaller slice: launches "
                             f"{turn['launches']}")
    log(f"the smaller slice: {n_reads} reads, {SMALL_DATASET['genome_len']} "
        f"bp, {SMALL_DATASET['n_genes']} genes; host route {host_s:.1f}s; "
        f"the device route by steps {len(ARTIFACTS)} artifacts "
        f"byte-identical; launches {turn['launches']}; peak device memory "
        f"{turn['peak']} bytes; wall {turn['seconds']:.1f}s")
    return inputs, ref, stage_seconds(host_dir), turn, n_reads


# ---------------------------------------------------------------- mesh

MESH_SCORE = dict(batch=4097, qlen=64)   # sharded_batch_score's batch
MESH_COUNT = dict(ids=1_000_003, segments=20_001)
MESH_LOOKUP_READS = 400                  # reads whose minimizers (a)
MESH_INDEX_SHARDS = 4                    # hash ranges of (a)'s index


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_mesh_collectives(mesh, index, reads, max_occ, rng) -> None:
    """(a): the count matrix, the sharded lookup and the sharded score on
    `mesh` against their plain versions."""
    before = pmesh.COLLECTIVES.count
    ids = rng.integers(0, MESH_COUNT["segments"], MESH_COUNT["ids"])
    got = pdist.mesh_count_matrix(mesh, ids, MESH_COUNT["segments"])
    if not np.array_equal(got, np.bincount(
            ids, minlength=MESH_COUNT["segments"])):
        raise AssertionError("mesh_count_matrix != np.bincount")
    shards = pdist.place_index_shards(
        mesh, *pdist.shard_index_arrays(index, MESH_INDEX_SHARDS))
    hashes, q_off = [], [0]
    for _name, seq in reads[:MESH_LOOKUP_READS]:
        codes = encode(seq)
        for qc in (codes, revcomp_codes(codes)):
            hashes.append(minimizers(qc, index.kmer, index.window)[1])
            q_off.append(q_off[-1] + len(hashes[-1]))
    qidx, gpos = sharded_seed_hits(shards, np.concatenate(hashes),
                                   np.array(q_off), max_occ)
    n_hits = 0
    for o, h in enumerate(hashes):
        sel = (qidx >= q_off[o]) & (qidx < q_off[o + 1])
        want_q, want_g = index.lookup(h, max_occ)
        if not (np.array_equal(qidx[sel] - q_off[o], want_q)
                and np.array_equal(gpos[sel], want_g)):
            raise AssertionError(f"sharded lookup != GenomeIndex.lookup, "
                                 f"orientation {o}")
        n_hits += len(want_q)
    q = rng.integers(0, 4, (MESH_SCORE["batch"], MESH_SCORE["qlen"]))
    t = rng.integers(0, 4, (MESH_SCORE["batch"], 128))
    got = pdist.sharded_batch_score(mesh, q, t)
    want = pdist._score_batch(torch.from_numpy(q), torch.from_numpy(t))
    if not np.array_equal(got, want.numpy()):
        raise AssertionError("sharded_batch_score != its plain version")
    log(f"mesh (a) on {mesh.size} shard(s), group "
        f"{dist.get_backend(mesh.group) if mesh.group else None}: "
        f"count matrix of {MESH_COUNT['ids']} ids == np.bincount; sharded "
        f"lookup ({MESH_INDEX_SHARDS} hash ranges, {len(hashes)} "
        f"orientations, {q_off[-1]} minimizers, {n_hits} hits) == "
        f"GenomeIndex.lookup; sharded score of {MESH_SCORE['batch']} reads "
        f"== plain; {pmesh.COLLECTIVES.count - before} collectives")


def padding_batches(n: int) -> tuple:
    """1, 3 and the largest odd count 2k + 1 <= n (the second of two
    shards all, partly or one row padding)."""
    return tuple(sorted({1, min(3, n), n - (n + 1) % 2}))


def same(got, want, what) -> None:
    for g, w in zip(got, want):
        if not np.array_equal(np.asarray(g), np.asarray(w)):
            raise AssertionError(f"mesh (b): {what} differs")


def check_mesh_padding(mesh, aligner, reads, largest, device, rng) -> None:
    """(b): the three dispatches on `mesh` (two shards of one card)
    against the meshless call on the card and the plain versions, on
    batches whose second shard is all, partly or one row padding."""
    cpu = torch.device("cpu")
    cfg = aligner.cfg
    codes_all, read_off, seeded = aligner.seed_batch(reads[:300])
    n_cand, _r, _s, _c, _t, n_seg, segs = seeded
    kw = dict(min_intron=cfg.min_intron, max_intron=cfg.max_intron)
    for b in padding_batches(n_cand):
        want = chain_kernel.chain_batch_rows(*segs, n_seg, b, device=device,
                                             **kw)
        same([want], [chain_kernel.chain_batch_rows(
            *segs, n_seg, b, device=cpu, **kw)], f"chain plain, {b}")
        with pmesh.use_mesh(mesh):
            got = chain_kernel.chain_batch_rows(*segs, n_seg, b,
                                                device=device, **kw)
        same([got], [want], f"chain rows, {b} candidates")
    rows = chain_kernel.chain_batch_rows(*segs, n_seg, n_cand,
                                         device=device, **kw)
    _st, _ch, oriented, _ro, _runs, probs = aligner.fill_batch(
        codes_all, read_off, seeded, rows)
    genome_cpu = torch.from_numpy(aligner.index.seq_codes)
    for b in padding_batches(len(probs[0])):
        part = tuple(np.asarray(a)[:b] for a in probs)
        want = kernels.solve_dp_fused(part, oriented, read_off,
                                      aligner.genome_codes, cfg)
        same(want, kernels.solve_dp_fused(part, oriented, read_off,
                                          genome_cpu, cfg), f"dp plain, {b}")
        with pmesh.use_mesh(mesh):
            got = kernels.solve_dp_fused(part, oriented, read_off,
                                         aligner.genome_codes, cfg)
        same(got, want, f"dp results, {b} problems")
    # POA: small sets against the plain versions too; the slice's largest
    # chunk against the meshless launch (its plain forward takes 25 s)
    sets = [[noisy_copy(rng, base, 0.03) for _ in range(4)]
            for base in (rng.integers(0, 4, 300).astype(np.uint8)
                         for _ in range(9))]
    params = PoaParams(band=20, adaptive=True)
    _cons, kept = capture_consensus(sets, params, device, {2})
    _k, W, l_cap, arrays = kept[0]
    cases = [(arrays, W, l_cap, params, True)]
    l_arrays, l_W, l_l_cap, l_params = largest
    cases.append((l_arrays, l_W, l_l_cap, l_params, False))
    for arrays, W, l_cap, params, plain in cases:
        for b in padding_batches(len(arrays[2])):
            part = [a[:b] for a in arrays]
            for walk in poa.WALKS:
                args = (*part, W, l_cap, params)

                def steps(out):
                    rows, counts = out
                    return [counts] + [rows[k, :c]
                                       for k, c in enumerate(counts)]

                want = steps(poa.dispatch_chunk(*args, device, walk=walk))
                if plain:
                    same(want, steps(poa.dispatch_chunk(*args, cpu,
                                                        walk=walk)),
                         f"poa plain, {walk}, {b}")
                with pmesh.use_mesh(mesh):
                    got = steps(poa.dispatch_chunk(*args, device, walk=walk))
                same(got, want, f"poa {walk} walk, {b} problems")
    log(f"mesh (b) on two shards of {device}: chain rows (batches "
        f"{padding_batches(n_cand)} of {n_cand} candidates), dp results "
        f"(batches {padding_batches(len(probs[0]))}), poa steps and records "
        f"(9 problems of 300 bases: batches {padding_batches(9)}, also == "
        f"plain; the slice's largest chunk: batches "
        f"{padding_batches(len(l_arrays[2]))}) == the meshless calls")


def run_in_process(out_dir, inputs, mesh=None, flags=()) -> dict:
    """The slice through `mando-tpu-torch --device cuda
    --consensus_backend device [flags]` in this process, under `mesh`
    when one is given, every launch counter and the collectives'
    statistics set to 0 just before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for *_names, counter in KERNELS:
        counter.count = 0
    pmesh.COLLECTIVES.count, pmesh.COLLECTIVES.seconds = 0, 0.0
    t0 = time.time()
    with pmesh.use_mesh(mesh) if mesh is not None else \
            contextlib.nullcontext():
        port_cli.main(["-p", out_dir, *inputs, "--device", "cuda",
                       "--consensus_backend", "device", *flags])
        torch.cuda.synchronize()
    return dict(seconds=time.time() - t0,
                launches={name: counter.count
                          for name, *_r, counter in KERNELS},
                peak=torch.cuda.max_memory_allocated(),
                stages=stage_seconds(out_dir),
                collectives=(pmesh.COLLECTIVES.count,
                             pmesh.COLLECTIVES.seconds * 1e3))


def mesh_phase(tmp, inputs, ref, turn0, aligner, reads, largest,
               device) -> None:
    """Phase 5, (a) to (d)."""
    t_phase = time.time()
    rng = np.random.default_rng(5)
    pmesh.multihost_init(f"127.0.0.1:{free_port()}", 1, 0, timeout_s=120,
                         device="cuda")
    try:
        one = pmesh.make_mesh(1)
        if (one.world, one.devices, dist.get_backend(one.group)) != (
                1, (device,), "nccl"):
            raise AssertionError(f"make_mesh(1) under the NCCL group: {one}")
        two = pmesh.Mesh.from_devices([device, device], group=one.group)
        check_mesh_collectives(one, aligner.index, reads, aligner.max_occ,
                               rng)
        check_mesh_collectives(two, aligner.index, reads, aligner.max_occ,
                               rng)
        check_mesh_padding(two, aligner, reads, largest, device, rng)
        for what, mesh, flags in (
                ("the one-rank NCCL mesh", one, ()),
                ("two shards of one card, sharded index", two,
                 ("--index_backend", "sharded"))):
            out_dir = os.path.join(tmp, f"mesh{mesh.size}")
            run_ = run_in_process(out_dir, inputs, mesh, flags)
            got = artifact_bytes(out_dir)
            for name in ARTIFACTS:
                if got[name] != ref[name]:
                    raise AssertionError(f"{name} under {what} differs from "
                                         f"the host run")
            launches = run_["launches"]
            if min(launches[k] for k in ("chain_rows", "dp_fused", "poa_fwd",
                                         "poa_walk")) <= 0:
                raise AssertionError(f"under {what}: launches {launches}")
            n_coll, coll_ms = run_["collectives"]
            if n_coll <= 0:
                raise AssertionError(f"under {what}: no collective ran")
            t0s = turn0["stages"]
            log(f"mesh (c) slice under {what}: {len(ARTIFACTS)} artifacts "
                f"byte-identical to the host run; launches {launches}; "
                f"{n_coll} collectives, {coll_ms:.1f} ms host clock; peak "
                f"device memory {run_['peak']} bytes (turn 0: "
                f"{turn0['peak']}); wall {run_['seconds']:.1f}s (turn 0: "
                f"{turn0['seconds']:.1f}s)")
            log(f"mesh (c) stage seconds under {what} | turn 0: " + ", ".join(
                f"{k} {run_['stages'][k]:.2f} | {t0s[k]:.2f}" for k in t0s))
        if torch.cuda.device_count() == 1:
            try:
                pmesh.make_mesh(2)
            except ValueError as e:
                log(f"mesh (d) make_mesh(2) on one card under the group "
                    f"raised: {e}")
            else:
                raise AssertionError("make_mesh(2) on one card did not raise")
    finally:
        dist.destroy_process_group()
    if torch.cuda.device_count() == 1:
        try:
            pmesh.make_mesh(2)
        except ValueError:
            pass
        else:
            raise AssertionError("make_mesh(2) on one card did not raise")
    log(f"mesh: phase (a)-(d) passed, group destroyed, "
        f"{time.time() - t_phase:.1f}s")


# ------------------------------------------------------------ mixed routes

# the slice under the reference's mixed pairs, and what each must launch:
# chain on the card for a device chain; the DP kernel for dp 'device' only
# ('rowscan' runs its plain version on the card, 'numpy' the host solver)
MIXED_PAIRS = (("device", "numpy"), ("native", "device"),
               ("device", "rowscan"))
MIXED_CFGS = (dict(), dict(end_bonus=12), dict(zdrop=40),
              dict(end_bonus=12, zdrop=40))


def hand_problems(rng) -> list:
    """DpProblems beside the slice's: over-size (nq 2049, nt 2304), empty
    sides, dead extensions, targets of 1, 2303 and 2304 bases side by
    side, in each mode; and the 2048 x 2303 envelope."""
    t = rng.integers(0, 4, 2304).astype(np.uint8)
    q = t[:2049].copy()
    hit = rng.random(len(q)) < 0.08
    q[hit] = rng.integers(0, 4, int(hit.sum()))
    empty = np.zeros(0, np.uint8)
    out = []
    for mode in ("global", "extend_right", "extend_left"):
        out += [DpProblem(q, t[:300].copy(), mode),
                DpProblem(q[:10].copy(), t, mode),
                DpProblem(empty, t[:50].copy(), mode),
                DpProblem(q[:40].copy(), empty, mode),
                DpProblem(empty, empty, mode),
                DpProblem(rng.integers(0, 4, 30).astype(np.uint8),
                          rng.integers(0, 4, 45).astype(np.uint8), mode),
                DpProblem(np.zeros(6, np.uint8), np.ones(9, np.uint8), mode),
                DpProblem(q[:5].copy(), t[:1].copy(), mode),
                DpProblem(q[:6].copy(), t[:2303].copy(), mode),
                DpProblem(q[:7].copy(), t, mode)]
    # the envelope once (phase 3 holds it in every mode): a team's layout
    return out + [DpProblem(q[:2048].copy(), t[:2303].copy(),
                            "extend_left")]


def same_results(got, want, what) -> None:
    bad = [k for k, (g, w) in enumerate(zip(got, want))
           if (g.ops, g.q_len, g.t_len) != (w.ops, w.q_len, w.t_len)]
    if bad or len(got) != len(want):
        raise AssertionError(f"mixed (a): {what}: {len(bad)} of "
                             f"{len(want)} results differ (first {bad[:5]})")


def launches_alone_ms(genome, oriented, read_off, probs, cfg, device):
    """csrc/dp.cu's launches alone on solve_dp_fused's descriptors `probs`
    (`dp_chunks`, buffers made beforehand), by CUDA events over 5 runs
    after one untimed."""
    oriented_t = torch.from_numpy(oriented).to(device)
    chunks = list(kernels.dp_chunks(probs, read_off, device))
    preps = [kernels.dp_prepare(kernels._launch_layout(
        desc[2], desc[3], int(desc[2].max()), int(desc[3].max())), steps,
        device) for _i, desc, steps in chunks]

    def launches():
        for (_i, desc, steps), prep in zip(chunks, preps):
            kernels.dp_launch(genome, oriented_t, *desc, prep, cfg, steps)

    launches()
    return cuda_ms(launches, 5)


def check_problem_lists(aligner, reads, device) -> None:
    """(a): the DP problem list entry `solve_dp_device` on the card against
    its plain version on the card (rowscan=True) and the host solver, on
    the first read batch's problems from the Python staging (`_native_picks`
    + `_fill_picks`) with the hand-made ones, under four scorings; the
    launch counter must move for the entry and stay for its plain
    version. Timed on the first batch's problems alone: the route's call
    (host clock), its launches alone and the plain version on the same
    descriptors (CUDA events), and the staged entry `solve_dp_fused` on the
    C fill stage's descriptors of the same batch (host clock) with its
    launches alone (CUDA events)."""
    t0 = time.time()
    staged = TorchSpliceAligner.from_aligner(
        aligner, device, dataclasses.replace(aligner.cfg,
                                             chain_backend="native"))
    _pend, real = staged._fill_picks(reads, staged._native_picks(reads),
                                     float(aligner.cfg.min_chain_score))
    stage_s = time.time() - t0
    hand = hand_problems(np.random.default_rng(8))
    counter = kernels.DP_LAUNCHES
    for extra in MIXED_CFGS:
        cfg = dataclasses.replace(aligner.cfg, **extra)
        problems = (real if not extra else real[:2000]) + hand
        before = counter.count
        got = kernels.solve_dp_device(problems, cfg, device)
        launched = counter.count - before
        plain = kernels.solve_dp_device(problems, cfg, device, rowscan=True)
        if launched <= 0 or counter.count != before + launched:
            raise AssertionError(f"mixed (a): launches {launched} for the "
                                 f"entry, {counter.count - before - launched}"
                                 f" for its plain version")
        same_results(got, plain, f"{extra or 'default'}: kernel vs plain")
        same_results(got, solve_dp_native(problems, cfg),
                     f"{extra or 'default'}: kernel vs host solver")
        log(f"mixed (a) {extra or 'default scoring'}: {len(problems)} "
            f"problems ({len(hand)} hand-made), solve_dp_device on the card "
            f"== its plain version on the card == solve_dp_native; "
            f"{launched} dp_fused launches, 0 for the plain version")

    cfg = aligner.cfg
    idx, probs, oriented, read_off, targets = kernels.problem_batch(real)
    genome = torch.from_numpy(targets).to(device)
    chunks = list(kernels.dp_chunks(probs, read_off, device))
    oriented_t = torch.from_numpy(oriented).to(device)

    def plain():
        for _i, desc, steps in chunks:
            kernels.dp_fused_plain(genome, oriented_t, *desc, cfg, steps)

    route_ms = host_ms(lambda: kernels.solve_dp_device(real, cfg, device), 3)
    launch_ms = launches_alone_ms(genome, oriented, read_off, probs, cfg,
                                  device)
    plain_ms = cuda_ms(plain, 1)
    codes_all, c_off, seeded = aligner.seed_batch(reads)
    _st, _ch, c_oriented, _ro, _runs, c_probs = aligner.fill_batch(
        codes_all, c_off, seeded, aligner.chain_batch(seeded))
    fused_ms = host_ms(lambda: kernels.solve_dp_fused(
        c_probs, c_oriented, c_off, aligner.genome_codes, cfg), 3)
    c_launch_ms = launches_alone_ms(aligner.genome_codes, c_oriented, c_off,
                                    c_probs, cfg, device)
    b_ms, b_by, cells, n_bytes = dp_bound(chunks)
    log(f"mixed (a) first batch ({len(reads)} reads, Python staging "
        f"{stage_s:.1f}s): {len(real)} problems, {len(idx)} on the card in "
        f"{len(chunks)} chunks ({cells} cells); solve_dp_device "
        f"{route_ms:.3f} ms (host clock), its launches alone "
        f"{launch_ms:.3f} ms, plain {plain_ms:.3f} ms (CUDA events); the "
        f"staged solve_dp_fused on the C fill's {len(c_probs[0])} "
        f"descriptors {fused_ms:.3f} ms (host clock), its launches alone "
        f"{c_launch_ms:.3f} ms (CUDA events); bound {b_ms:.6f} ms by {b_by} "
        f"({n_bytes} bytes)")


def mixed_phase(tmp, inputs, ref, turn0, aligner, reads, n_reads,
                device) -> None:
    """Phase 6, (a) on `reads` (the first read batch) and (b) on the
    slice's n_reads."""
    t_phase = time.time()
    check_problem_lists(aligner, reads, device)
    t0s = turn0["stages"]
    for pair in MIXED_PAIRS:
        out_dir = os.path.join(tmp, "mixed-" + "-".join(pair))
        run_ = run_in_process(out_dir, inputs, flags=(
            "--chain_backend", pair[0], "--dp_backend", pair[1]))
        got = artifact_bytes(out_dir)
        for name in ARTIFACTS:
            if got[name] != ref[name]:
                raise AssertionError(f"{name} under chain {pair[0]}, dp "
                                     f"{pair[1]} differs from the host run")
        launches = run_["launches"]
        if (launches["chain_rows"] > 0) != (pair[0] == "device") or \
                (launches["dp_fused"] > 0) != (pair[1] == "device") or \
                min(launches["poa_fwd"], launches["poa_walk"]) <= 0:
            raise AssertionError(f"chain {pair[0]}, dp {pair[1]}: launches "
                                 f"{launches}")
        stages = run_["stages"]
        log(f"mixed (b) slice, chain {pair[0]}, dp {pair[1]}: "
            f"{len(ARTIFACTS)} artifacts byte-identical to the host run; "
            f"launches {launches}; APDFQ stages "
            f"{n_reads / sum(stages.values()):.1f} reads/s (turn 0: "
            f"{n_reads / sum(t0s.values()):.1f}), module "
            f"A {n_reads / stages['A_alignment']:.1f} (turn 0: "
            f"{n_reads / t0s['A_alignment']:.1f}); peak device memory "
            f"{run_['peak']} bytes (turn 0: {turn0['peak']}); wall "
            f"{run_['seconds']:.1f}s (turn 0: {turn0['seconds']:.1f}s)")
        log(f"mixed (b) stage seconds, chain {pair[0]}, dp {pair[1]} | turn "
            f"0: " + ", ".join(f"{k} {run_['stages'][k]:.2f} | {t0s[k]:.2f}"
                               for k in t0s))
    log(f"mixed: phase (a)-(b) passed, {time.time() - t_phase:.1f}s")


# phase 6 (c): bench.py's device_path dataset
BUCKETLESS_DATASET = dict(n_genes=4, n_reads_per_gene=75, genome_len=120_000)


def bucketless_phase(tmp) -> None:
    """Phase 6 (c): the device route on a directory index cache, then on
    a copy of it without bucket_lo.npy, byte-identical."""
    d = os.path.join(tmp, "bucketless")
    n_reads = TOOL.make_dataset_files(d, **BUCKETLESS_DATASET)
    inputs = ["-G", os.path.join(d, "genome.fasta"),
              "-g", os.path.join(d, "ann.gtf"),
              "-f", os.path.join(d, "reads.fasta")]
    seeded = collections.Counter()
    plain_seed_batch = TorchSpliceAligner.seed_batch

    def seed_batch(self, reads):
        seeded[self.index.bucket_lo is None] += 1
        return plain_seed_batch(self, reads)

    cache = os.path.join(d, "genome.idx")
    bare = os.path.join(d, "bare.idx")
    TorchSpliceAligner.seed_batch = seed_batch
    try:
        with_table = run_in_process(os.path.join(d, "table"), inputs,
                                    flags=("--index_cache", cache))
        shutil.copytree(cache, bare)
        os.remove(os.path.join(bare, "bucket_lo.npy"))
        without = run_in_process(os.path.join(d, "bare"), inputs,
                                 flags=("--index_cache", bare))
    finally:
        TorchSpliceAligner.seed_batch = plain_seed_batch
    got = artifact_bytes(os.path.join(d, "bare"))
    want = artifact_bytes(os.path.join(d, "table"))
    for name in ARTIFACTS:
        if got[name] != want[name]:
            raise AssertionError(f"bucket-less: {name} differs from the "
                                 f"bucketed run's")
    launches = without["launches"]
    if min(launches["chain_rows"], launches["dp_fused"]) <= 0 \
            or seeded[True] or not seeded[False] \
            or os.path.exists(os.path.join(bare, "bucket_lo.npy")):
        raise AssertionError(f"bucket-less: launches {launches}, C seed "
                             f"stage calls {dict(seeded)} (True: without "
                             f"the table)")
    log(f"mixed (c) bucket-less index, {n_reads} reads: {len(ARTIFACTS)} "
        f"artifacts byte-identical to the bucketed run; launches "
        f"{launches} (bucketed: {with_table['launches']}); C seed stage "
        f"calls 0 (bucketed: {seeded[False]}); wall "
        f"{without['seconds']:.1f}s (bucketed: "
        f"{with_table['seconds']:.1f}s)")
    log("mixed (c) stage seconds, bucket-less | bucketed: " + ", ".join(
        f"{k} {v:.2f} | {with_table['stages'][k]:.2f}"
        for k, v in without["stages"].items()))


# ------------------------------------------------------------ no native

# phase 8's child: the slice's default device route through run_pipeline,
# in a process of its own with MANDO_TPU_NO_NATIVE=1 (the switch is read
# once a process, and this one has loaded the library). It prints one
# JSON line: the launch counters, set to 0 just before the run; module
# D's rounds and chunks; the native libraries mapped into it; the stage
# seconds; wall seconds, kernel ms by CUDA events and peak device memory.
NO_NATIVE_CHILD = r"""
import json, os, sys, time
import torch
from mandalorion_tpu_torch.align import chain_kernel, kernels
from mandalorion_tpu_torch.pipeline import cli
from mandalorion_tpu_torch.pipeline.stages import run_pipeline
from mandalorion_tpu_torch.poa import kernels as poa
args = cli.build_parser().parse_args(sys.argv[1:])
counters = dict(dp_fused=kernels.DP_LAUNCHES,
                chain_rows=chain_kernel.CHAIN_LAUNCHES,
                poa_fwd=poa.POA_FWD_LAUNCHES, poa_walk=poa.POA_WALK_LAUNCHES,
                poa_sweep=poa.POA_SWEEP_LAUNCHES)
poa.OBSERVER = obs = poa.RunObserver(time_kernels=True)
for counter in counters.values():
    counter.count = 0
t0 = time.time()
run_pipeline(args.path, args.genome_sequence, args.genome_annotation,
             args.Consensus_reads, cli.config_from_args(args),
             device=args.device)
torch.cuda.synchronize()
seconds = time.time() - t0
with open(os.path.join(args.path, "tmp", "timing.tsv")) as fh:
    stages = {k: float(v) for k, v in (
        line.rstrip("\n").split("\t")[:2] for line in fh
        if line.strip() and not line.startswith("stage"))}
with open("/proc/self/maps") as fh:
    mapped = sorted({line.split()[-1] for line in fh
                     if "libmando_native" in line})
print(json.dumps(dict(
    launches={name: c.count for name, c in counters.items()},
    rounds=obs.rounds, chunks=len(obs.chunks),
    problems=max((c[0] for c in obs.chunks), default=0), mapped=mapped,
    stages=stages, seconds=seconds, kernel_ms=obs.kernel_ms(),
    fill_s=obs.fill_s, apply_s=obs.apply_s,
    peak=torch.cuda.max_memory_allocated())))
"""
NO_NATIVE_TIMEOUT_S = 900
# the hand-made long candidates of phase 8 (a): segments a candidate
LONG_SEGMENT_COUNTS = (400, 450, 480, 500, 510, 511, 512, 512, 530, 700)


def long_segment_lists(rng) -> list:
    """Segment lists of LONG_SEGMENT_COUNTS collinear multi-anchor
    segments (indel and intron gaps, overlaps; cov below the span), each
    with up to 20 single-anchor segments off the diagonal, unsorted: the
    entry prepares them (the two over 512 keep their longest 512)."""
    lists = []
    for n in LONG_SEGMENT_COUNTS:
        segs, q, t = [], 0, 0
        for _ in range(n):
            ln = int(rng.integers(15, 60))
            q = max(q + int(rng.integers(-10, 15)), 0)
            t = max(t + int(rng.choice([-10, 0, 3, 40, 300, 5000, 60000])),
                    0)
            segs.append(Segment(q, q + ln, t, t + ln, n_anchors=3,
                                cov=int(rng.integers(15, ln + 1))))
            q, t = q + ln, t + ln
        for _ in range(int(rng.integers(0, 21))):
            nq = int(rng.integers(0, q))
            tt = nq + int(rng.choice([0, 10_000, 900_000]))
            segs.append(Segment(nq, nq + 15, tt, tt + 15))
        rng.shuffle(segs)
        lists.append(segs)
    return lists


def same_chains(got, want, what) -> None:
    if [([vars(s) for s in c], score) for c, score in got] != \
            [([vars(s) for s in c], score) for c, score in want]:
        raise AssertionError(f"chain_batch_segments on the card != on the "
                             f"CPU: {what}")


def check_segment_entry(aligner, reads, device) -> None:
    """Phase 8 (a): the segment-list entry on hand-made long candidates
    and on the first batch's candidates from the numpy seeding's segment
    lists (`segment_candidates`): its packed rows through the kernel and
    the route against the plain version on the card, exactly
    (`time_chain`, with its three figures and bounds), and its chains and
    float32 scores on the card against the whole entry on the CPU; then
    the entry's call from the segment lists to the chains, host clock."""
    kw = dict(min_intron=aligner.cfg.min_intron,
              max_intron=aligner.cfg.max_intron)
    t0 = time.time()
    _cands, first = aligner.segment_candidates(
        [encode(seq) for _name, seq in reads])
    seed_s = time.time() - t0
    sets = {"hand-made long candidates":
            long_segment_lists(np.random.default_rng(CHAIN_SEED + 1)),
            f"the first batch's candidates ({len(reads)} reads, seeded "
            f"an orientation at a time in {seed_s:.1f} s)": first}
    for what, lists in sets.items():
        _prepped, planes, n_seg = chain_kernel.pack_segment_lists(
            lists, max_intron=kw["max_intron"])
        time_chain(f"segment lists, {what}", planes, n_seg, kw, device, 5)
        got = chain_kernel.chain_batch_segments(lists, **kw, device=device)
        same_chains(got, chain_kernel.chain_batch_segments(
            lists, **kw, device=torch.device("cpu")), what)
        entry_ms = host_ms(lambda: chain_kernel.chain_batch_segments(
            lists, **kw, device=device), 3)
        log(f"no native (a): chain_batch_segments, {what}: {len(lists)} "
            f"lists, {int(n_seg.sum())} segments after prepare_segments "
            f"(longest {int(n_seg.max())}), {sum(len(c) > 0 for c, _s in got)}"
            f" chains; card == CPU (chains and float32 scores); the entry's "
            f"call {entry_ms:.3f} ms (host clock, lists to chains)")


def check_graph_batch(sets, params, device, rounds: int = 2) -> None:
    """Phase 8 (b): `align_graph_batch` on the card against the same call
    on the CPU on case (a)'s Python-held graphs, round by round (the
    graphs grown by the card's paths): paths identical."""
    graphs = [PoaGraph(s[0]) for s in sets]
    for k in range(1, rounds + 1):
        queries = [s[k] for s in sets]
        t0 = time.time()
        got = poa.align_graph_batch(graphs, queries, params, device)
        card_s = time.time() - t0
        t0 = time.time()
        want = poa.align_graph_batch(graphs, queries, params, "cpu")
        if got != want:
            raise AssertionError(f"align_graph_batch round {k}: the card's "
                                 f"paths differ from the CPU's")
        log(f"no native (b): align_graph_batch, case (a) round {k}: "
            f"{len(graphs)} graphs of {min(len(g.base) for g in graphs)}.."
            f"{max(len(g.base) for g in graphs)} nodes, paths on the card "
            f"== CPU ({card_s:.2f} s on the card, {time.time() - t0:.2f} s "
            f"on the CPU, host clock)")
        for g, q, path in zip(graphs, queries, got):
            g.apply_path(q, path)


def no_native_phase(tmp, inputs, ref, ref_t, turn0, aligner, reads,
                    n_reads, case_a, device) -> None:
    """Phase 8, (a) to (c): the segment-list entry, the Python-held
    graphs' entry, then the slice's default device route under
    MANDO_TPU_NO_NATIVE=1 in a child process."""
    t_phase = time.time()
    check_segment_entry(aligner, reads, device)
    check_graph_batch(*case_a, device)
    out_dir = os.path.join(tmp, "no-native")
    t0 = time.time()
    out = run([sys.executable, "-c", NO_NATIVE_CHILD, "-p", out_dir, *inputs,
               "--device", "cuda"], env=dict(MANDO_TPU_NO_NATIVE="1"),
              timeout=NO_NATIVE_TIMEOUT_S)
    wall = time.time() - t0
    res = json.loads(out.strip().splitlines()[-1])
    got = artifact_bytes(out_dir)
    for name in ARTIFACTS:
        if got[name] != ref[name]:
            raise AssertionError(f"{name} under MANDO_TPU_NO_NATIVE differs "
                                 f"from the host run")
    launches, chunks = res["launches"], res["chunks"]
    if min(launches["chain_rows"], launches["dp_fused"], chunks) <= 0 or \
            launches["poa_fwd"] != chunks or launches["poa_walk"] != chunks \
            or launches["poa_sweep"] != 0:
        raise AssertionError(f"no native: launches {launches} for {chunks} "
                             f"chunks")
    if res["mapped"]:
        raise AssertionError(f"no native: the child mapped {res['mapped']}")
    stages, t0s = res["stages"], turn0["stages"]
    log(f"no native (c) slice, default device route under "
        f"MANDO_TPU_NO_NATIVE=1 in a child process: {len(ARTIFACTS)} "
        f"artifacts byte-identical to the host run; no native library "
        f"mapped; launches {launches}; module D {res['rounds']} rounds, "
        f"{chunks} chunks (at most {res['problems']} problems), forward "
        f"{res['kernel_ms']['poa_fwd']:.1f} ms, step walk "
        f"{res['kernel_ms']['poa_walk']:.1f} ms (CUDA events), graph_arrays "
        f"{res['fill_s']:.2f} s, apply_path {res['apply_s']:.2f} s (host "
        f"clock); APDFQ stages {n_reads / sum(stages.values()):.1f} reads/s "
        f"(turn 0: {n_reads / sum(t0s.values()):.1f}, host route: "
        f"{n_reads / sum(ref_t.values()):.1f}), module A "
        f"{n_reads / stages['A_alignment']:.1f} reads/s (turn 0: "
        f"{n_reads / t0s['A_alignment']:.1f}); peak device memory "
        f"{res['peak']} bytes (turn 0: {turn0['peak']}); run "
        f"{res['seconds']:.1f} s, child {wall:.1f} s (turn 0: "
        f"{turn0['seconds']:.1f} s)")
    log("no native (c) stage seconds, switched | turn 0 | host route: "
        + ", ".join(f"{k} {stages[k]:.2f} | {t0s[k]:.2f} | {ref_t[k]:.2f}"
                    for k in ref_t))
    log(f"no native: phase (a)-(c) passed, {time.time() - t_phase:.1f}s")


# ---------------------------------------------------------------- trace

# phase 7's runs: the walk, the MANDO_TPU_PROFILE root under the scratch
# directory, and the kernels the run's traces must show
TRACE_RUNS = (("steps", "trace_steps",
               ("dp_fused", "chain_rows", "poa_fwd", "poa_walk")),
              ("sweep", "trace_records", ("poa_sweep",)))
# the traced kernel ms of the forward and the walk against RunObserver's
# CUDA-event sums of the same run
TRACE_MS_TOLERANCE = 0.10


def load_trace_reader():
    """tools/trace_breakdown.py, the reader of a MANDO_TPU_PROFILE
    directory."""
    path = os.path.join(ROOT, "tools", "trace_breakdown.py")
    spec = importlib.util.spec_from_file_location("trace_breakdown", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def launches_by_stage(out: dict):
    """While entered, every StageTimer stage also records its launches by
    kernel into out[stage], so that each stage's trace can be held to its
    own counts."""
    plain_stage = observe.StageTimer.stage

    @contextlib.contextmanager
    def stage(self, name):
        before = {n: counter.count for n, *_r, counter in KERNELS}
        try:
            with plain_stage(self, name):
                yield
        finally:
            out[name] = {n: counter.count - before[n]
                         for n, *_r, counter in KERNELS}

    observe.StageTimer.stage = stage
    try:
        yield out
    finally:
        observe.StageTimer.stage = plain_stage


def trace_phase(tmp, inputs, ref, turn0) -> None:
    """Phase 7: the slice by steps and by records with MANDO_TPU_PROFILE
    set, each stage's trace read by tools/trace_breakdown.py."""
    t_phase = time.time()
    tb = load_trace_reader()
    t0s = turn0["stages"]
    for walk, label, want in TRACE_RUNS:
        root = os.path.join(tmp, label)
        by_stage: dict = {}
        os.environ["MANDO_TPU_PROFILE"] = root
        try:
            with launches_by_stage(by_stage):
                run_ = run_device_route(os.path.join(tmp, f"{label}_out"),
                                        inputs, walk, keep_largest=False)
        finally:
            os.environ.pop("MANDO_TPU_PROFILE", None)
        got = artifact_bytes(os.path.join(tmp, f"{label}_out"))
        for name in ARTIFACTS:
            if got[name] != ref[name]:
                raise AssertionError(f"{name} of the traced {walk} run "
                                     f"differs from the host run")
        check_route_launches(run_)
        launched = sorted(s for s, counts in by_stage.items()
                          if any(counts.values()))
        stages = tb.run_breakdown(root, expect_device=launched)
        if set(stages) != set(run_["stages"]):
            raise AssertionError(f"{label}: traces of {sorted(stages)}, "
                                 f"stages {sorted(run_['stages'])}")
        kineto = collections.Counter(
            e["name"] for stage in stages
            for e in tb.load_events(tb.stage_trace(os.path.join(root, stage)))
            if e.get("cat") == "kernel")
        log(f"trace ({label}): kernels kineto recorded: " + "; ".join(
            f"{name[:90]} x{n}" for name, n in kineto.most_common()))
        for stage, b in stages.items():
            counts = {n: c for n, c in by_stage.get(stage, {}).items() if c}
            traced = {n: c for n, (_ms, c) in tb.kernel_totals(
                {stage: b}, [f"{n}_kernel" for n, *_r in KERNELS]).items()
                if c}
            if traced != {f"{n}_kernel": c for n, c in counts.items()}:
                raise AssertionError(f"{label} {stage}: the trace shows "
                                     f"{traced}, the counters {counts}")
            log(f"trace ({label}) {stage}: timing.tsv "
                f"{run_['stages'][stage]:.2f} s (turn 0: {t0s[stage]:.2f}); "
                f"launches {counts}; {tb.format_stage(stage, b)}")
        totals = tb.kernel_totals(stages, [f"{n}_kernel" for n in want])
        for n in want:
            if totals[f"{n}_kernel"][1] != run_["launches"][n] \
                    or run_["launches"][n] <= 0:
                raise AssertionError(f"{label}: {n}_kernel traced "
                                     f"{totals[f'{n}_kernel'][1]} times, "
                                     f"launched {run_['launches'][n]}")
        walk_key = "poa_sweep" if walk == "sweep" else "poa_walk"
        for n in ("poa_fwd", walk_key):
            traced_ms = tb.kernel_totals(stages, [f"{n}_kernel"])[
                f"{n}_kernel"][0]
            event_ms = run_["kernel_ms"][n]
            log(f"trace ({label}): {n}_kernel {traced_ms:.3f} ms in the "
                f"trace, {event_ms:.3f} ms by CUDA events")
            if abs(traced_ms - event_ms) > TRACE_MS_TOLERANCE * event_ms:
                raise AssertionError(f"{label}: {n}_kernel {traced_ms:.3f} "
                                     f"ms traced against {event_ms:.3f} ms "
                                     f"by CUDA events")
        if tb.run_idle_share(stages) is None:
            raise AssertionError(f"{label}: no device event in any trace")
        busy = sum(b["busy_ms"] or 0.0 for b in stages.values())
        window = sum(b["window_ms"] for b in stages.values())
        log(f"trace ({label}): idle share over the run's stages "
            f"{100 * tb.run_idle_share(stages):.2f}% (busy {busy:.3f} ms of "
            f"{window:.3f} ms traced); "
            f"{sum(b['bytes'] for b in stages.values())} trace bytes; "
            f"launches {run_['launches']}; wall {run_['seconds']:.1f}s "
            f"(turn 0: {turn0['seconds']:.1f}s)")
    log(f"trace: phase passed, {time.time() - t_phase:.1f}s")


# ------------------------------------------------------- users' inputs

# phase 9 (a): config-3 in full, make_dataset's files, the reads as two
# samples in a fofn: genes 0-49 as FASTA, genes 50-99 as gzipped FASTQ
CONFIG3 = dict(n_genes=100, n_reads_per_gene=1000, genome_len=50_000_000,
               seed=0)
CONFIG3_FIRST_SAMPLE = 50_000
# (b): tests/test_scale.py's 300 Mbp dataset
SCALE = dict(n_chroms=4, chrom_len=75_000_000, genes_per_chrom=2,
             per_gene=40)
USERS_TIMEOUT_S = 900
# (c): the small cases of tests/test_torch_e2e.py, by the function of
# tools/run_configs_torch.py that writes each dataset, and their flags
SMALL_CASES = (("two-sample fofn", "two_sample", ("-R", "3")),
               ("three-sample FASTA and gzipped FASTQ", "three_sample_mixed",
                ("-R", "3")),
               ("gzipped FASTQ", "spliced_and_mono", ()),
               ("gzipped FASTQ -w 2 -j gtag", "spliced_and_mono",
                ("-w", "2", "-j", "gtag")),
               ("gzipped FASTQ -m", "spliced_and_mono", ("-m",)),
               ("PacBio BAM -P", "pacbio_bam", ()),
               ("two chromosomes with junk", "two_chromosomes_junk", ()),
               ("all junk", "all_junk", ()))
# the host route's runs, in turn, in one process that never touches CUDA
HOST_CHILD = r"""
import json, sys
from mandalorion_tpu_torch.pipeline import cli
for argv in json.loads(sys.argv[1]):
    if cli.main(argv) != 0:
        raise SystemExit(f"the host route failed: {argv}")
"""


def host_runs(runs) -> float:
    """The port's host route (`TOOL.HOST_ROUTE`) on each (out_dir, inputs)
    of `runs`, in turn, in one child process; returns its seconds."""
    t0 = time.time()
    run([sys.executable, "-c", HOST_CHILD, json.dumps(
        [["-p", out, *inputs, *TOOL.HOST_ROUTE] for out, inputs in runs])],
        timeout=USERS_TIMEOUT_S)
    return time.time() - t0


def same_outputs(got_dir, want_dir, what, pacbio=False) -> None:
    """The seven files byte-identical, or absent from both; with `pacbio`
    the .quant and .tpm headers, which name the converted FASTA under the
    output directory, compare with that directory substituted."""
    for name in ARTIFACTS:
        paths = [os.path.join(d, name) for d in (got_dir, want_dir)]
        present = [os.path.exists(p) for p in paths]
        if present[0] != present[1]:
            raise AssertionError(f"{what}: {name} present {present[0]} on "
                                 f"the card's route, {present[1]} on the "
                                 f"host route")
        if not present[0]:
            continue
        blobs = []
        for path, out in zip(paths, (got_dir, want_dir)):
            with open(path, "rb") as fh:
                blob = fh.read()
            if pacbio and name.endswith((".quant", ".tpm")):
                blob = blob.replace(out.encode(), b"<out>")
            blobs.append(blob)
        if blobs[0] != blobs[1]:
            raise AssertionError(f"{what}: {name} differs from the host "
                                 f"route's")


@contextlib.contextmanager
def module_a_batches(out: list):
    """While entered, each batch of the device route appends a dict: its
    reads, chain candidates, the longest candidate's segments and its DP
    problems. Observation only: the calls go on to the route's own."""
    cls = TorchSpliceAligner
    saved = cls.map_batch, cls.chain_batch, cls.dp_batch

    def map_batch(self, reads):
        out.append(dict(reads=len(reads)))
        return saved[0](self, reads)

    def chain_batch(self, seeded):
        n_cand, n_seg = int(seeded[0]), seeded[5]
        out[-1].update(candidates=n_cand, longest=int(n_seg[:n_cand].max())
                       if n_cand else 0)
        return saved[1](self, seeded)

    def dp_batch(self, probs, oriented, read_off):
        out[-1].update(problems=len(probs[1]),
                       max_rows=int(np.max(probs[4], initial=0)))
        return saved[2](self, probs, oriented, read_off)

    cls.map_batch, cls.chain_batch, cls.dp_batch = (map_batch, chain_batch,
                                                    dp_batch)
    try:
        yield out
    finally:
        cls.map_batch, cls.chain_batch, cls.dp_batch = saved


def config3_phase(tmp, device) -> None:
    """Phase 9 (a): config-3 in full, card against the host route."""
    d = os.path.join(tmp, "config3")
    t0 = time.time()
    n_reads = TOOL.make_dataset_files(d, **CONFIG3)
    fofn = TOOL.split_samples(d, CONFIG3_FIRST_SAMPLE)
    os.remove(os.path.join(d, "reads.fasta"))
    log(f"users (a) config-3: {n_reads} reads on "
        f"{CONFIG3['genome_len']} bp, {CONFIG3['n_genes']} genes, two "
        f"samples (FASTA, gzipped FASTQ) ({time.time() - t0:.1f}s)")
    inputs = ["-G", os.path.join(d, "genome.fasta"),
              "-g", os.path.join(d, "ann.gtf"), "-f", fofn]
    host_dir, card_dir = os.path.join(d, "host"), os.path.join(d, "card")
    host_s = host_runs([(host_dir, inputs)])
    log(f"users (a) host route: wall {host_s:.1f}s")
    batches = []
    with module_a_batches(batches):
        run_ = run_device_route(card_dir, inputs, "steps", keep_largest=True)
    same_outputs(card_dir, host_dir, "config-3")
    check_route_launches(run_)
    stats, port_t, ref_t = run_["stats"], run_["stages"], \
        stage_seconds(host_dir)
    first = batches[0]
    log(f"users (a) config-3 through the card's route (step walk): "
        f"{len(ARTIFACTS)} files byte-identical to the host route; "
        f"launches {run_['launches']}; peak device memory {run_['peak']} "
        f"bytes; wall {run_['seconds']:.1f}s")
    log("users (a) stage seconds, card | host: " + ", ".join(
        f"{k} {port_t[k]:.2f} | {ref_t[k]:.2f}" for k in ref_t))
    log(f"users (a) module A {n_reads / port_t['A_alignment']:.1f} vs "
        f"{n_reads / ref_t['A_alignment']:.1f} reads/s, APDFQ (index build "
        f"included) {n_reads / sum(port_t.values()):.1f} vs "
        f"{n_reads / sum(ref_t.values()):.1f} reads/s, card vs host")
    log(f"users (a) module A: {len(batches)} batches of "
        f"{[b['reads'] for b in batches]} reads; the first: "
        f"{first.get('candidates', 0)} chain candidates, the longest "
        f"{first.get('longest', 0)} segments; {first.get('problems', 0)} "
        f"DP problems, at most {first.get('max_rows', 0)} query rows")
    sizes = [c[0] for c in stats.chunks]
    classes = collections.Counter((c[1], c[2]) for c in stats.chunks)
    big = max(stats.chunks, key=lambda c: c[0] * c[1] * c[2])
    ms = run_["kernel_ms"]
    log(f"users (a) module D: {stats.rounds} rounds, {len(stats.chunks)} "
        f"chunks, problems a chunk {min(sizes)}..{max(sizes)} (mean "
        f"{sum(sizes) / len(sizes):.1f}), chunks over 40 problems "
        f"{sum(b > 40 for b in sizes)}, W over 256 "
        f"{sum(c[2] > 256 for c in stats.chunks)}; (n_cap, W): chunks "
        f"{dict(sorted(classes.items()))}; the largest (B, n_cap, W) "
        f"{big[:3]}; forward {ms['poa_fwd']:.1f} ms, step walk "
        f"{ms['poa_walk']:.1f} ms by CUDA events summed over the run; host "
        f"stage_graphs {stats.fill_s:.2f} s, apply_graphs "
        f"{stats.apply_s:.2f} s")
    arrays, W, l_cap, params = stats.largest
    f_ms, w_ms, steps = time_poa_kernels(arrays, params, W, l_cap, device)
    log(f"users (a) module D's largest chunk alone ({arrays[0].shape[0]} "
        f"problems, n_cap {arrays[0].shape[1]}, W {W}, {steps} walk steps): "
        f"forward {f_ms:.3f} ms, step walk {w_ms:.3f} ms (CUDA events)")


def scale_phase(tmp, device) -> None:
    """Phase 9 (b): the 300 Mbp dataset, the index cache in turns."""
    d = os.path.join(tmp, "scale")
    t0 = time.time()
    truth = TOOL.scale_files(d, **SCALE)
    n_reads = len(truth) * SCALE["per_gene"]
    log(f"users (b) 300 Mbp: {n_reads} reads on {SCALE['n_chroms']} x "
        f"{SCALE['chrom_len']} bp ({time.time() - t0:.1f}s)")
    inputs = ["-G", os.path.join(d, "genome.fasta"),
              "-g", os.path.join(d, "ann.gtf"),
              "-f", os.path.join(d, "reads.fasta")]
    res = TOOL.cache_turns(d, device.type, inputs, n_reads, truth,
                           timeout=USERS_TIMEOUT_S)
    if not res["ok"]:
        raise AssertionError(f"300 Mbp: isoforms by chromosome "
                             f"{res['isoform_chroms']}, planted "
                             f"{res['planted']}")
    for label, r in res["runs"].items():
        launches = r["launches"]
        if label.startswith("device") and min(
                launches[k] for k in ("chain_rows", "dp_fused", "poa_fwd",
                                      "poa_walk")) <= 0:
            raise AssertionError(f"300 Mbp, {label}: launches {launches}")
    log(f"users (b) 300 Mbp: three turns byte-identical, every planted gene "
        f"one isoform on its own chromosome; index_build "
        + ", ".join(f"{label} {r['stages']['index_build']:.2f} s"
                    for label, r in res["runs"].items()))
    from mandalorion_tpu_torch.align.aligner import genome_tensor
    from mandalorion_tpu_torch.align.index import load_index
    mapped = load_index(os.path.join(d, "genome.idx")).seq_codes
    built = np.array(mapped)
    times = {"mapped": [], "built": []}
    for _turn in range(2):
        for what, codes in (("mapped", mapped), ("built", built)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            on_card = genome_tensor(codes, device)
            torch.cuda.synchronize()
            times[what].append((time.perf_counter() - t0) * 1e3)
            if what == "mapped" and not torch.equal(
                    on_card.cpu(), torch.from_numpy(built)):
                raise AssertionError("300 Mbp: the mapped genome's upload "
                                     "differs from the codes")
            del on_card
    log(f"users (b) the genome's upload ({len(built)} bytes, host clock, two "
        f"turns): from the mapped cache (read-only, copied first) "
        + ", ".join(f"{t:.1f}" for t in times["mapped"])
        + " ms; from a freshly built index's array (pageable) "
        + ", ".join(f"{t:.1f}" for t in times["built"]) + " ms")


def small_cases_phase(tmp, device) -> None:
    """Phase 9 (c): the small cases of tests/test_torch_e2e.py and
    config-2's gates through the card's route."""
    from mandalorion_tpu_torch.config import (AlignConfig as PortAlign,
                                              PipelineConfig, PoaConfig)
    from mandalorion_tpu_torch.pipeline.stages import run_pipeline
    from mandalorion_tpu_torch.utils.simulate import (
        evaluate_adversarial, make_adversarial_dataset)
    cases = []
    for k, (label, writer, flags) in enumerate(SMALL_CASES):
        d = os.path.join(tmp, f"small{k}")
        os.makedirs(d)
        cases.append((label, d, [*getattr(TOOL, writer)(d), *flags]))
    d2 = os.path.join(tmp, "config2")
    truth = make_adversarial_dataset(d2, reads_per_isoform=12)
    cases.append(("config-2", d2, [
        "-G", os.path.join(d2, "genome.fasta"), "-g",
        os.path.join(d2, "ann.gtf"), "-f", os.path.join(d2, "reads.fasta")]))
    host_s = host_runs([(os.path.join(d, "host"), inputs)
                        for _label, d, inputs in cases])
    log(f"users (c) host route: {len(cases)} runs in one process, "
        f"{host_s:.1f}s")
    for label, d, inputs in cases:
        card = os.path.join(d, "card")
        run_ = run_in_process(card, inputs)
        same_outputs(card, os.path.join(d, "host"), label,
                     pacbio="-P" in inputs)
        launches = run_["launches"]
        if os.path.exists(os.path.join(card, ARTIFACTS[0])) and min(
                launches["chain_rows"], launches["poa_fwd"]) <= 0:
            raise AssertionError(f"{label}: launches {launches}")
        log(f"users (c) {label}: byte-identical to the host route; "
            f"launches {launches}; wall {run_['seconds']:.1f}s")
    label, d, inputs = cases[0]
    card = os.path.join(d, "card")
    for name in ARTIFACTS[3:5]:
        os.remove(os.path.join(card, name))
    run_ = run_in_process(card, [*inputs, "-M", "FQ"])
    same_outputs(card, os.path.join(d, "host"), f"{label} -M FQ")
    log(f"users (c) {label}, resumed with -M FQ (.quant and .tpm removed): "
        f"byte-identical to the host route; launches {run_['launches']}")
    gates = evaluate_adversarial(os.path.join(d2, "card"), truth)
    if not (gates["isoform_recall"] == gates["junction_recall"] == 1.0
            and not gates["pseudogene_false_calls"]
            and gates["read_purity"] >= 0.95
            and gates["n_out_isoforms"] == len(truth["isoforms"])):
        raise AssertionError(f"config-2's gates on the card: {gates}")
    log(f"users (c) config-2's gates on the card: isoform recall "
        f"{gates['isoform_recall']}, junction recall "
        f"{gates['junction_recall']}, pseudogene calls "
        f"{gates['pseudogene_false_calls']}, read purity "
        f"{gates['read_purity']}, {gates['n_out_isoforms']} isoforms of "
        f"{len(truth['isoforms'])}")
    # --external_sam: the card's route writes a SAM of the two-sample
    # dataset; the host route and the card's route run from it
    first = os.path.join(d, "sam")
    genome, ann, fofn = inputs[1], inputs[3], inputs[5]
    run_pipeline(first, genome, ann, fofn, PipelineConfig(
        align=PortAlign(emit_sam=True), poa=PoaConfig(backend="device")),
        device=device)
    sam = os.path.join(first, "tmp", "mm2Alignments.sam")
    ext = [*inputs, "--external_sam", sam]
    host_runs([(os.path.join(d, "ext_host"), ext)])
    run_ = run_in_process(os.path.join(d, "ext_card"), ext)
    same_outputs(os.path.join(d, "ext_card"), os.path.join(d, "ext_host"),
                 "--external_sam")
    same_outputs(os.path.join(d, "ext_card"), os.path.join(d, "host"),
                 "--external_sam against the aligned run")
    log(f"users (c) --external_sam (the card's SAM of the {label}): the "
        f"card's and the host route's runs from it byte-identical, and to "
        f"the aligned run; launches {run_['launches']}")


def users_phase(tmp, device) -> None:
    """Phase 9, (a) to (c)."""
    with timed("phase 9 (a) config-3"):
        config3_phase(tmp, device)
    with timed("phase 9 (b) 300 Mbp"):
        scale_phase(tmp, device)
    with timed("phase 9 (c) small cases"):
        small_cases_phase(tmp, device)


# phase 10: the kernels each section of bench_torch.py --smoke must launch
# (positive) and must not (zero)
BENCH_LAUNCHES = {
    "value": (("dp_fused", "chain_rows"), ("poa_fwd", "poa_walk")),
    "star_engine": (("dp_fused", "chain_rows"), ("poa_fwd", "poa_walk")),
    "device_path": (("dp_fused", "chain_rows", "poa_fwd", "poa_walk"), ()),
    "poa": (("poa_fwd", "poa_walk"), ("dp_fused", "chain_rows")),
    "poa_batch": (("poa_fwd", "poa_walk"), ("dp_fused", "chain_rows")),
}
BENCH_TIMEOUT_S = 600


def bench_phase() -> None:
    """Phase 10: bench_torch.py --smoke in a process of its own, its JSON
    line held to what each section must show."""
    out = run([sys.executable, os.path.join(ROOT, "bench_torch.py"),
               "--smoke"], timeout=BENCH_TIMEOUT_S)
    res = json.loads(out.strip().splitlines()[-1])
    sections = {"value": res, "star_engine": res["star_engine"],
                "device_path": res["device_path"], "poa": res["poa"],
                "poa_batch": res["poa_batch"]["64"]}
    for name, sec in sections.items():
        positive, zero = BENCH_LAUNCHES[name]
        got = sec["launches"]
        if min(got[k] for k in positive) <= 0 or any(
                got[k] for k in (*zero, "poa_sweep")):
            raise AssertionError(f"bench {name}: launches {got}")
        if name in ("value", "star_engine", "device_path"):
            labels = {a["label"] for a in res["attempts"][name]}
            runs = {"card 0", "host 0"} | ({"warmup 0", "host warmup 0"}
                                           if name == "device_path" else set())
            if set(sec["artifacts_sha256"]) != set(ARTIFACTS) \
                    or not runs <= labels:
                raise AssertionError(f"bench {name}: files "
                                     f"{sorted(sec['artifacts_sha256'])}, "
                                     f"runs {sorted(labels)}")
    batch = sections["poa_batch"]
    if batch["launches"]["poa_fwd"] != batch["chunks"] \
            or batch["problems_per_chunk"] != [64, 64]:
        raise AssertionError(f"bench poa_batch: {batch['chunks']} chunks of "
                             f"{batch['problems_per_chunk']} problems, "
                             f"launches {batch['launches']}")
    log(f"bench: value {res['value']:.1f} reads/s on the card, host route "
        f"{res['host_same_workload']['reads_per_s']:.1f}; star_engine "
        f"{res['star_engine']['reads_per_s']:.1f} | "
        f"{res['star_engine']['host_same_workload']['reads_per_s']:.1f}; "
        f"device_path {res['device_path']['reads_per_s']:.1f} | "
        f"{res['device_path']['host_same_workload']['reads_per_s']:.1f}; "
        f"poa {res['poa']['bases_per_s_device']:.0f} bases/s on the card, "
        f"{res['poa']['bases_per_s_host']:.0f} native; poa_batch (64) "
        f"{batch['bases_per_s_device']['median']:.0f} | "
        f"{batch['bases_per_s_native']['median']:.0f}; the card's files "
        f"byte-identical to the host route's in each pipeline section; "
        f"cold_kind {res['cold_kind']}; the bench's own "
        f"{res['total_s']:.1f} s")


def chain_only(device) -> None:
    """--chain-only: the chain's sets and the first read batch's chain
    figures, nothing else; the 512-segment set comes from CHAIN_SEED, so
    two trees' runs time the same inputs. Run from a copy of this script
    inside another tree of the port, it times that tree's chain route."""
    check_chain_sets(np.random.default_rng(CHAIN_SEED), device, reps=20)
    with tempfile.TemporaryDirectory() as tmp:
        TOOL.make_dataset_files(tmp, **DATASET)
        reads = [(nm, sq) for nm, sq, _q in
                 read_fastx(os.path.join(tmp, "reads.fasta"))]
        aligner = TorchSpliceAligner(
            fastx_to_dict(os.path.join(tmp, "genome.fasta")), device=device)
    batch = max(aligner.cfg.batch_reads, -(-len(reads) // 3))
    _codes, _off, seeded = aligner.seed_batch(reads[:batch])
    n_cand, _r, _s, _c, _t, n_seg, segs = seeded
    time_chain(f"the first batch ({batch} reads)", segs, n_seg[:n_cand],
               dict(min_intron=aligner.cfg.min_intron,
                    max_intron=aligner.cfg.max_intron), device, 20)


def main(argv) -> None:
    if argv not in ([], ["--chain-only"]):
        raise SystemExit("usage: python3 chip_smoke.py [--chain-only]")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    t_start = time.time()
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
    if argv:
        chain_only(device)
        log(f"chip_smoke: the chain phase passed, {time.time() - t_start:.0f}"
            f" s")
        return

    rng = np.random.default_rng(0)
    errs = {}
    with timed("phase 3 dp random"):
        errs["dp_fused"] = check_dp_random(rng, device)
    with timed("phase 3 dp layouts"):
        errs["dp_fused"] = max(errs["dp_fused"], check_dp_layouts(device))
    with timed("phase 3 chain sets"):
        errs["chain_rows"] = check_chain_sets(rng, device)
    with timed("phase 3 poa cases (a)-(f)"):
        (errs["poa_fwd"], errs["poa_walk"], errs["poa_sweep"]), case_a = \
            check_poa_cases(rng, device)

    log(f"seconds: phases 1-3 {time.time() - t_start:.1f}")
    with tempfile.TemporaryDirectory() as tmp:
        t_phase4 = t0 = time.time()
        n_reads = TOOL.make_dataset_files(tmp, **DATASET)
        log(f"dataset: {n_reads} reads, {DATASET['genome_len']} bp genome, "
            f"{DATASET['n_genes']} genes ({time.time() - t0:.1f}s)")
        inputs = ["-G", os.path.join(tmp, "genome.fasta"),
                  "-g", os.path.join(tmp, "ann.gtf"),
                  "-f", os.path.join(tmp, "reads.fasta")]

        # the comparison run: the port's host route, in a process of its
        # own that never initialises CUDA
        ref_dir = os.path.join(tmp, "host")
        host_s = host_runs([(ref_dir, inputs)])
        log(f"seconds: phase 4 host route {host_s:.1f}")

        reads = [(nm, sq) for nm, sq, _q in
                 read_fastx(os.path.join(tmp, "reads.fasta"))]
        aligner = TorchSpliceAligner(
            fastx_to_dict(os.path.join(tmp, "genome.fasta")),
            device=device)
        batch = max(aligner.cfg.batch_reads, -(-len(reads) // 3))
        with timed("phase 4 first batch"):
            measured = check_first_batch(aligner, reads[:batch], device)

        ref = artifact_bytes(ref_dir)
        ref_t = stage_seconds(ref_dir)
        runs = []
        for turn, walk in enumerate(ROUTE_TURNS):
            out_dir = os.path.join(tmp, f"port{turn}")
            run_ = run_device_route(out_dir, inputs, walk,
                                    keep_largest=turn == 0)
            got = artifact_bytes(out_dir)
            for name in ARTIFACTS:
                if got[name] != ref[name]:
                    raise AssertionError(f"{name} of the {walk} run differs "
                                         f"from the host run")
            check_route_launches(run_)
            runs.append(run_)
            stats, port_t = run_["stats"], run_["stages"]
            ms = run_["kernel_ms"]
            log(f"slice, turn {turn}, walk by {walk}: {len(ARTIFACTS)} "
                f"artifacts byte-identical; launches {run_['launches']}; "
                f"D_define {port_t['D_define']:.2f} s; forward kernel "
                f"{ms['poa_fwd']:.1f} ms, {walk} walk kernel "
                f"{ms['poa_sweep' if walk == 'sweep' else 'poa_walk']:.1f} "
                f"ms by CUDA events summed over the run; host stage_graphs "
                f"{stats.fill_s * 1e3:.1f} ms, apply_graphs "
                f"{stats.apply_s * 1e3:.1f} ms; wall {run_['seconds']:.1f}s")
        by_steps, by_records = runs[0], runs[1]
        launches = dict(by_steps["launches"],
                        poa_sweep=by_records["launches"]["poa_sweep"])
        for name, count in launches.items():
            if count <= 0:
                raise AssertionError(f"kernel {name} was never launched on "
                                     f"its path")
        port_t, stats = by_steps["stages"], by_steps["stats"]
        log(f"slice: peak device memory {by_steps['peak']} bytes by "
            f"steps, {by_records['peak']} by records")
        log(f"slice: APDFQ stages (index build included) "
            f"{n_reads / sum(port_t.values()):.1f} reads/s with modules A "
            f"and D on the card vs {n_reads / sum(ref_t.values()):.1f} on "
            f"the host route; module A "
            f"{n_reads / port_t['A_alignment']:.1f} vs "
            f"{n_reads / ref_t['A_alignment']:.1f} reads/s; wall "
            f"{by_steps['seconds']:.1f}s vs {host_s:.1f}s (host: a "
            f"fresh interpreter)")
        log("slice: stage seconds, card | host: " + ", ".join(
            f"{k} {port_t[k]:.2f} | {ref_t[k]:.2f}" for k in ref_t))

        classes = sorted({(c[1], c[2]) for c in stats.chunks})
        sizes = [c[0] for c in stats.chunks]
        log(f"module D: {stats.rounds} rounds x "
            f"{len({c[2] for c in stats.chunks})} width classes = "
            f"{len(stats.chunks)} chunks = forward launches, problems a "
            f"chunk {min(sizes)}..{max(sizes)} (mean "
            f"{sum(sizes) / len(sizes):.1f}), (n_cap, W) classes {classes}; "
            f"host route D_define {ref_t['D_define']:.2f} s")
        with timed("phase 4 largest chunk"):
            measured.update(check_poa_main_path(stats.largest, device))
        log(f"seconds: phase 4 {time.time() - t_phase4:.1f}")
        with timed("the smaller slice"):
            s_inputs, s_ref, s_ref_t, s_turn, s_reads = small_slice(tmp)
        with timed("phase 5 mesh"):
            mesh_phase(tmp, s_inputs, s_ref, s_turn, aligner, reads,
                       stats.largest, device)
        with timed("phase 6 mixed"):
            mixed_phase(tmp, s_inputs, s_ref, s_turn, aligner,
                        reads[:batch], s_reads, device)
        with timed("phase 6 (c) bucket-less"):
            bucketless_phase(tmp)
        with timed("phase 8 no native"):
            no_native_phase(tmp, s_inputs, s_ref, s_ref_t, s_turn, aligner,
                            reads[:batch], s_reads, case_a, device)
        del aligner, reads
        with timed("phase 7 trace"):
            trace_phase(tmp, s_inputs, s_ref, s_turn)
    with tempfile.TemporaryDirectory() as tmp, timed("phase 9 users"):
        users_phase(tmp, device)
    with timed("phase 10 bench"):
        bench_phase()

    for banned in ("jax", "mandalorion_tpu"):
        if banned in sys.modules:
            raise AssertionError(f"{banned} was imported")
    for name in errs:
        measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"],
                                            errs[name])
    stopped = stop_descendants()
    if stopped:
        print(f"chip_smoke: stopped processes still running at the end: "
              f"{stopped}", file=sys.stderr, flush=True)
    log(f"chip_smoke: every phase passed, {time.time() - t_start:.0f} s")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **measured[name], "library_ms": None}
        for name, src, rep, _counter in KERNELS]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    adopt_descendants()
    try:
        main(sys.argv[1:])
    finally:
        stop_descendants()
