"""Where csrc/dp.cu spends its time, on one CUDA card.

    python3 tools/dp_kernel_phases.py

For each launch of a set (the row classes of chip_smoke.py's envelope
sweep, from the same seed, and a batch of 11,542 gap fills of the main
path's sizes: 5-39 query rows, a few more target bases), it prints the
time of `kernels.dp_fused` as the route calls it (checks, layout, uploads,
buffers and the launch) beside the launch alone (`dp_launch` on buffers
prepared once), by CUDA events, and the host clock's split of the gap
fills' call. Then it builds a copy of the kernels whose
dp.cu reads clock64() between the phases of a problem (set-up, fill with
the row folds, walk) and prints them for a sample of warps and for each
team's warp 0 with the device's printf: read the phases as shares, the
readings cost cycles themselves.

The insertion points are lines of dp.cu, matched as text; the script fails,
naming the line, when an edit of the kernel has moved one.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from mandalorion_tpu_torch import AlignConfig, _build  # noqa: E402
from mandalorion_tpu_torch.align import kernels  # noqa: E402

WARP_EDITS = (
    ("  load_target<1>(A, p, nt, rev, share, lane, 32);\n",
     "  const long long t0 = clock64();\n"),
    ("  for (int s = 0; s < strips; ++s) {\n    int v, a;\n"
     "    const int qc = query_code(A, p, nq, rev, 32 * s + lane + 1);",
     "  const long long t1 = clock64();\n"),
    ("  walk<1>(P, mode, best, A.buf + static_cast<int64_t>(p) * A.steps,\n"
     "          A.steps, A.ks + p, win, lane);\n}\n\n// A tall and wide",
     "  const long long t2 = clock64();\n"),
)
WARP_PRINT = (
    "  if (blockIdx.x % 97 == 0 && lane == 0) printf(\"dp warp nq %d nt %d "
    "set-up %lld fill %lld walk %lld\\n\", nq, nt, t1 - t0, t2 - t1, "
    "clock64() - t2);\n")
TEAM_EDITS = (
    ("  if (threadIdx.x < kWarps) flags[threadIdx.x] = -1;\n",
     "  const long long t0 = clock64();\n"),
    ("  if (warp != 0) return;\n", "  const long long t1 = clock64();\n"),
)
TEAM_END = ("  walk<kTeamCols>(P, mode, best, A.buf + static_cast<int64_t>(p) "
            "* A.steps,\n                  A.steps, A.ks + p, win, lane);\n}"
            "\n\n__global__")
TEAM_PRINT = ("  if (lane == 0) printf(\"dp team nq %d nt %d fill %lld "
              "fold+walk %lld\\n\", nq, nt, t1 - t0, clock64() - t1);\n")


def insert_before(src: str, line: str, text: str) -> str:
    if src.count(line) != 1:
        raise SystemExit(f"dp_kernel_phases: {src.count(line)} matches of "
                         f"the source line {line!r}: the kernel was edited, "
                         f"bring the insertion points up to date")
    return src.replace(line, text + line)


def instrument(csrc: str) -> None:
    path = os.path.join(csrc, "dp.cu")
    with open(path) as fh:
        src = fh.read()
    for line, text in WARP_EDITS + TEAM_EDITS + ((TEAM_END, ""),):
        src = insert_before(src, line, text)
    # the prints go after the walks: at the ends of solve_warp, solve_team
    for end, text in ((WARP_EDITS[2][0], WARP_PRINT),
                      (TEAM_END, TEAM_PRINT)):
        cut = end.index("}")
        src = src.replace(end, end[:cut] + text + end[cut:])
    src = src.replace("#include <cuda_runtime.h>\n",
                      "#include <cuda_runtime.h>\n#include <cstdio>\n")
    with open(path, "w") as fh:
        fh.write(src)


def gap_fill_batch(rng, device):
    """11,542 problems of the main path's sizes on a random genome."""
    n = 11_542
    nq = rng.integers(5, 40, n)
    nt = np.maximum(nq + rng.integers(-5, 10, n), 1)
    genome = rng.integers(0, 4, 1 << 20).astype(np.uint8)
    t_lo = rng.integers(0, len(genome) - 64, n)
    queries = [np.where(rng.random(q) < 0.1, rng.integers(0, 4, q),
                        np.resize(genome[t:t + max(q, 1)], q))
               for q, t in zip(nq, t_lo)]
    q_lo = np.cumsum([0] + [len(q) for q in queries[:-1]])
    mode = rng.integers(0, 3, n)

    def put(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)

    return (put(genome, np.uint8), put(np.concatenate(queries), np.uint8),
            put(q_lo, np.int64), put(t_lo, np.int64), put(nq, np.int32),
            put(nt, np.int32), put(mode, np.uint8))


def launches(device):
    """(name, dp_fused arguments) of every launch timed."""
    out = []
    genome, oriented, q_lo, t_lo, nq, nt, mode = \
        chip_smoke.random_dp_problems(np.random.default_rng(0), device)
    for lo, hi in chip_smoke.ROW_CLASSES:
        sel = ((nq >= lo) & (nq <= hi)).nonzero()[:, 0]
        out.append((f"rows {lo}..{hi}", (genome, oriented, q_lo[sel],
                                         t_lo[sel], nq[sel], nt[sel],
                                         mode[sel])))
    out.append(("gap fills", gap_fill_batch(np.random.default_rng(1),
                                            device)))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("dp_kernel_phases: needs a CUDA card")
    device = torch.device("cuda")
    smi = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"]).strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    cfg = AlignConfig()
    sets = launches(device)
    for name, args in sets:
        steps = int((args[4] + args[5]).max())
        prep = kernels.dp_prepare(
            kernels.dp_layout(args[4].cpu().numpy(), args[5].cpu().numpy(),
                              torch.cuda.get_device_properties(
                                  device).multi_processor_count),
            steps, device)
        kernels.dp_launch(*args, prep, cfg, steps)
        full = chip_smoke.cuda_ms(lambda: kernels.dp_fused(*args, cfg, steps),
                                  5)
        alone = chip_smoke.cuda_ms(
            lambda: kernels.dp_launch(*args, prep, cfg, steps), 5)
        lay = prep[-1]
        print(f"{name}: {len(lay.order)} problems ({lay.n_small} a warp, "
              f"{lay.per_block} warps a block, "
              f"{len(lay.order) - lay.n_small} a team, "
              f"{int((lay.ptr_off >= 0).sum())} with scratch pointers, "
              f"{lay.warp_share} B a warp): dp_fused {full:.3f} ms, the "
              f"launch alone {alone:.3f} ms", flush=True)
    # the route's host side by part, on the gap fills: checks (a few
    # reductions, one fetch), layout and buffers, the launch call
    args = sets[-1][1]
    steps = int((args[4] + args[5]).max())
    parts = np.zeros(4)
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hi = kernels._check_dp_args(*args, steps)
        t1 = time.perf_counter()
        prep = kernels.dp_prepare(kernels._launch_layout(args[4], args[5],
                                                         *hi), steps, device)
        t2 = time.perf_counter()
        kernels.dp_launch(*args, prep, cfg, steps)
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        parts += np.diff([t0, t1, t2, t3, time.perf_counter()])
    print("gap fills, host clock, ms: checks %.3f, layout and buffers "
          "%.3f, launch call %.3f, then the card %.3f"
          % tuple(parts / 10 * 1e3), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(_build.CSRC, csrc)
        instrument(csrc)
        _build.CSRC, _build._LIB = csrc, None
        _build.load_kernels()
        for name, args in sets:
            print(f"instrumented, {name} (cycles):", flush=True)
            kernels.dp_fused(*args, cfg, int((args[4] + args[5]).max()))
            torch.cuda.synchronize()


if __name__ == "__main__":
    main()
