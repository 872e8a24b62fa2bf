"""Where a row of the POA forward kernel and a tile of the step walk
kernel spend their cycles, on one CUDA card.

    python3 tools/poa_kernel_phases.py

Copies mandalorion_tpu_torch/csrc into a temporary directory, inserts
clock64() readings between the phases of csrc/poa_fwd.cu's row loop and,
through a probe that takes the place of the one that does nothing, at the
marks of the step walk's tile loop (csrc/poa_walk.cu and the chase in
csrc/poa_chase.cuh; problem 0 prints its sums with the device's printf
when it ends), builds that copy with the package's own
`_build` module, and runs both kernels once on the last round's chunk of a
consensus of 8 isoforms x 40 reads x about 3 kb (adaptive band, W 256).
The readings cost cycles themselves and keep the compiler from moving
work across them, so the instrumented kernels are slower than the real
ones (both times are printed): read the phases as shares. Before that it
times the forward as built beside a build with 4 problems a block (one
a warp) in place of 1, the choice csrc/poa_fwd.cu's note speaks of.

The insertion points are lines of the two sources, matched as text; the
script fails, naming the line, when an edit of a kernel has moved one.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from mandalorion_tpu_torch import _build  # noqa: E402
from mandalorion_tpu_torch.poa import kernels as poa  # noqa: E402
from mandalorion_tpu_torch.poa.graph import PoaParams  # noqa: E402

SOURCES = _build.CSRC

PRELUDE = ('#include <cstdio>\n#define TICK(x) { long long now_ = clock64(); '
           'tacc[x] += now_ - tlast; tlast = now_; }\n')
SETUP = ('long long tacc[12] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}; '
         'long long tlast = clock64(); const long long tstart = tlast;\n')

FWD_PHASES = ("loop", "list+centre", "offset+query", "predecessors", "H pick",
              "tier scans", "final+pack", "stores", "first max", "row end")
# (line of the source, text put before it)
FWD_EDITS = (
    ("#include <cuda_runtime.h>\n", None),
    ("  int buf = 0;\n", SETUP),
    ("      const int base_v = s_base[", "      TICK(0)\n"),
    ("      const int off = min(max(center - eff, 0), off_max);",
     "      TICK(1)\n"),
    ("        // predecessor reads, declared order, strict >",
     "        TICK(2)\n"),
    ("        // H before insertions: diag >= D1 >= D2 on ties",
     "        TICK(3)\n"),
    ("        tile_scan_first(acc, org, jabs0, acc_c, org_c, lane);",
     "        TICK(4)\n"),
    ("        int fin[kCols], op_out[kCols];", "        TICK(5)\n"),
    ("        store8(H + row_at + e0, fin);", "        TICK(6)\n"),
    ("        // the tile's first maximum, in every lane", "        TICK(7)\n"),
    ("      // first-max column of the stored row; rows that are all",
     "      TICK(8)\n"),
    ("// ring_rows: kRingCells / W rows", None),
)
FWD_ROW_END = ("      __syncwarp();  // this row's state, offset and best "
               "column are visible\n")
FWD_PRINT = (
    '  if (b == 0 && lane == 0) printf("fwd rows %d cycles %lld phases '
    + " %lld" * len(FWD_PHASES) + '\\n", n, clock64() - tstart'
    + "".join(f", tacc[{i}]" for i in range(len(FWD_PHASES))) + ");\n")

WALK_PHASES = ("other steps", "offsets", "tile copies", "chase", "flush")
# the walk's phases are the marks of its probe (csrc/poa_chase.cuh): a probe
# that counts cycles takes the place of the one that does nothing
WALK_PROBE = (
    "struct ClockProbe {\n  long long tacc[5], tlast;\n"
    "  __device__ ClockProbe() {\n    tlast = clock64();\n"
    "    for (int i = 0; i < 5; ++i) tacc[i] = 0;\n  }\n"
    "  __device__ void mark(int x) {\n    const long long now = clock64();\n"
    "    tacc[x] += now - tlast;\n    tlast = now;\n  }\n};\n")
WALK_EDITS = (
    ('#include "poa_chase.cuh"\n', None),
    ("  poa_chase::NoProbe probe;\n", None),
    ("      probe.mark(0);\n", "      ++n_tiles;\n"),
    ("  if (lane == 0) ks[b] = k;",
     '  if (b == 0 && lane == 0) printf("walk steps %d tiles %d cycles %lld '
     'phases' + " %lld" * len(WALK_PHASES) + '\\n", k, n_tiles, '
     'clock64() - tstart'
     + "".join(f", probe.tacc[{i}]" for i in range(len(WALK_PHASES)))
     + ");\n"),
)


def insert_before(src: str, line: str, text: str) -> str:
    if src.count(line) != 1:
        raise SystemExit(f"poa_kernel_phases: {src.count(line)} matches of "
                         f"the source line {line!r}: a kernel was edited, "
                         f"bring the insertion points up to date")
    return src.replace(line, text + line)


def instrument(csrc: str) -> None:
    path = os.path.join(csrc, "poa_fwd.cu")
    with open(path) as fh:
        src = fh.read()
    for line, text in FWD_EDITS[1:-1]:
        src = insert_before(src, line, text)
    src = src.replace(FWD_EDITS[0][0], FWD_EDITS[0][0] + PRELUDE)
    if src.count(FWD_ROW_END) != 1:
        raise SystemExit("poa_kernel_phases: the forward's row end moved")
    src = src.replace(FWD_ROW_END, FWD_ROW_END + "      TICK(9)\n")
    # the kernel's closing brace is the last "}\n" before the host code
    head, tail = src.split(FWD_EDITS[-1][0])
    cut = head.rstrip().rfind("}")
    src = head[:cut] + FWD_PRINT + head[cut:] + FWD_EDITS[-1][0] + tail
    with open(path, "w") as fh:
        fh.write(src)

    path = os.path.join(csrc, "poa_walk.cu")
    with open(path) as fh:
        src = fh.read()
    for line, text in WALK_EDITS[2:]:
        src = insert_before(src, line, text)
    src = insert_before(src, WALK_EDITS[0][0], "").replace(
        WALK_EDITS[0][0], WALK_EDITS[0][0] + "#include <cstdio>\n"
        + WALK_PROBE)
    src = insert_before(src, WALK_EDITS[1][0], "").replace(
        WALK_EDITS[1][0], "  ClockProbe probe;\n  int n_tiles = 0;\n"
        "  const long long tstart = probe.tlast;\n")
    with open(path, "w") as fh:
        fh.write(src)


ONE_A_BLOCK = "constexpr int kWarps = 1;  // problems a block, one a warp\n"


def build_copy(tmp: str, name: str, edit) -> None:
    """Build and load csrc as edited by `edit(directory)`."""
    csrc = os.path.join(tmp, name)
    shutil.copytree(SOURCES, csrc)
    edit(csrc)
    _build.CSRC, _build._LIB = csrc, None
    _build.load_kernels()


def four_a_block(csrc: str) -> None:
    path = os.path.join(csrc, "poa_fwd.cu")
    with open(path) as fh:
        src = fh.read()
    with open(path, "w") as fh:
        fh.write(insert_before(src, ONE_A_BLOCK, "").replace(
            ONE_A_BLOCK, ONE_A_BLOCK.replace("= 1;", "= 4;")))


def bench_chunk(device):
    """The last round's chunk of 8 isoforms x 40 reads x about 3 kb."""
    rng = np.random.default_rng(1)
    sets = []
    for _ in range(8):
        true = rng.integers(0, 4, 3000).astype(np.uint8)
        sets.append([chip_smoke.noisy_copy(rng, true, 0.03)
                     for _ in range(40)])
    params = PoaParams(band=40, adaptive=True)
    poa.OBSERVER = obs = poa.RunObserver(keep_rounds={39})
    try:
        poa.poa_consensus_batch(sets, params, device)
    finally:
        poa.OBSERVER = None
    _k, W, l_cap, arrays = obs.kept[0]
    return arrays, params, W, l_cap


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("poa_kernel_phases: needs a CUDA card")
    device = torch.device("cuda")
    smi = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"]).strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    arrays, params, W, l_cap = bench_chunk(device)
    # a quarter of a second of launches first: both kernels wait on
    # latency, so their times follow the card's clock, which an idle card
    # has let drop
    fwd_in, _walk_in = chip_smoke.poa_problem_tensors(arrays, params, W,
                                                      device)
    chip_smoke.cuda_ms(lambda: poa.poa_forward(*fwd_in), 25)
    f_ms, w_ms, steps = chip_smoke.time_poa_kernels(arrays, params, W, l_cap,
                                                    device)
    print(f"chunk: {len(arrays[2])} problems, rows {arrays[2].tolist()}, W "
          f"{W}, {steps} walk steps; the kernels as built: forward "
          f"{f_ms:.3f} ms, walk {w_ms:.3f} ms", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        build_copy(tmp, "four", four_a_block)
        f4_ms, _w, _s = chip_smoke.time_poa_kernels(arrays, params, W, l_cap,
                                                    device)
        print(f"forward with 4 problems a block: {f4_ms:.3f} ms", flush=True)
        build_copy(tmp, "phases", instrument)
        print("instrumented: forward phases " + ", ".join(FWD_PHASES)
              + "; walk phases " + ", ".join(WALK_PHASES)
              + " (cycles of problem 0, summed over its rows / tiles)",
              flush=True)
        fwd_in, (nn, ends, ql) = chip_smoke.poa_problem_tensors(
            arrays, params, W, device)
        # each launch prints its line; the first loads the new library
        mats = poa.poa_forward(*fwd_in)
        poa.poa_walk(nn, ends, ql, mats, l_cap)
        t_f = chip_smoke.cuda_ms(lambda: poa.poa_forward(*fwd_in), 1)
        t_w = chip_smoke.cuda_ms(
            lambda: poa.poa_walk(nn, ends, ql, mats, l_cap), 1)
        torch.cuda.synchronize()
        print(f"instrumented kernels: forward {t_f:.3f} ms, walk {t_w:.3f} "
              f"ms", flush=True)


if __name__ == "__main__":
    main()
