"""Where a row of the POA forward kernel and a tile of the step walk
kernel spend their time, on one CUDA card, under each warp count of the
forward.

    python3 tools/poa_kernel_phases.py

Its chunk is the last round's chunk of a consensus of 8 isoforms x 40
reads x about 3 kb (adaptive band, W 256), launched as its 8 problems (a
block and an SM each) and repeated to 296, more problems than the card
has SMs, as in the wide rounds of chr21_r2c2_isoforms.mixed. A row's time
is a launch's time over its tallest problem's rows.

First it prints how the chunk's rows read their predecessors and times
the forward as built on both launches, and the step walk. Then, for 1, 2,
4 and 8 warps a problem (csrc/poa_fwd.cu's kWarps, the choice its note
speaks of), it builds a copy of the two POA kernels' sources with that
count and times it on both launches and on the chunk at W 512 and 1024
(two and four tiles a row); and a copy that also has clock64() readings
between the phases of the forward's row loop and, through a probe that
takes the place of the one that does nothing, at the marks of the step
walk's tile loop (csrc/poa_walk.cu and the chase in csrc/poa_chase.cuh),
and runs that on the chunk: thread 0 of problem 0 prints its cycles a row
by phase with the device's printf when it ends (the walk its sums over
its tiles). The readings cost
cycles themselves and keep the compiler from moving work across them, so
the instrumented kernels are slower than the real ones (both times are
printed): read the phases as shares. Barrier waits fall in the phase
that ends at them: the tier scans and the row end.

The copies hold the POA kernels' sources alone (the library built from
them exports mando_poa_fwd and mando_poa_walk). The insertion points are
lines of the sources, matched as text; the script fails, naming the line,
when an edit of a kernel has moved one.
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
POA_SOURCES = ("poa_fwd.cu", "poa_walk.cu", "poa_chase.cuh")
POA_ENTRIES = ("mando_poa_fwd", "mando_poa_walk")
# the one C entry of the other sources that loading the library needs
ERRORS_CU = ('#include <cuda_runtime.h>\n'
             'extern "C" const char* mando_error_string(int code) {\n'
             '  return cudaGetErrorString(static_cast<cudaError_t>(code));\n'
             '}\n')
WIDE_COPIES = 37  # the 8-problem chunk x 37: 296 problems
WARP_COUNTS = (1, 2, 4, 8)
WARPS_LINE = (f"constexpr int kWarps = {poa.FWD_WARPS};  // warps a problem, "
              f"its block\n")

PRELUDE = ('#include <cstdio>\n#define TICK(x) { long long now_ = clock64(); '
           'tacc[x] += now_ - tlast; tlast = now_; }\n')
SETUP = ('long long tacc[12] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}; '
         'long long tlast = clock64(); const long long tstart = tlast;\n')

FWD_PHASES = ("loop", "list+centre", "offset+query", "predecessors", "H pick",
              "tier scans", "final+pack", "first max", "stores", "row end")
# (line of the source, text put before it)
FWD_EDITS = (
    ("#include <cuda_runtime.h>\n", None),
    ("  int par = 0;  // the scan slots' buffer, flipped every tile\n", SETUP),
    ("      const int base_v = s_base[", "      TICK(0)\n"),
    ("      const int off = min(max(center - eff, 0), off_max);",
     "      TICK(1)\n"),
    ("        // predecessor reads, declared order, strict >",
     "        TICK(2)\n"),
    ("        // H before insertions: diag >= D1 >= D2 on ties",
     "        TICK(3)\n"),
    ("        tile_scan_first(acc, org, jabs0, acc_c, org_c, lane, warp,",
     "        TICK(4)\n"),
    ("        int fin[kCols], op_out[kCols];", "        TICK(5)\n"),
    ("        // the tile's first maximum, in every lane", "        TICK(6)\n"),
    ("        // the stores issue while the reductions run",
     "        TICK(7)\n"),
    ("      // the row's first maximum over the warps; the barrier also",
     "      TICK(8)\n"),
    ("// ring_rows: kRingCells / W rows", None),
)
FWD_ROW_END = "      if constexpr (kWarps == 1) __syncwarp();\n"
FWD_PRINT = (
    '  if (b == 0 && threadIdx.x == 0) printf("fwd warps %d rows %d cycles a '
    'row %lld:' + "".join(f" {p} %lld" for p in FWD_PHASES)
    + '\\n", kWarps, n, (clock64() - tstart) / max(n, 1)'
    + "".join(f", tacc[{i}] / max(n, 1)" for i in range(len(FWD_PHASES)))
    + ");\n")

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


def edit_file(csrc: str, name: str, fn) -> None:
    path = os.path.join(csrc, name)
    with open(path) as fh:
        src = fh.read()
    with open(path, "w") as fh:
        fh.write(fn(src))


def instrument_forward(src: str) -> str:
    for line, text in FWD_EDITS[1:-1]:
        src = insert_before(src, line, text)
    src = src.replace(FWD_EDITS[0][0], FWD_EDITS[0][0] + PRELUDE)
    src = insert_before(src, FWD_ROW_END, "").replace(
        FWD_ROW_END, FWD_ROW_END + "      TICK(9)\n")
    # the kernel's closing brace is the last "}\n" before the host code
    head, tail = src.split(FWD_EDITS[-1][0])
    cut = head.rstrip().rfind("}")
    return head[:cut] + FWD_PRINT + head[cut:] + FWD_EDITS[-1][0] + tail


def instrument_walk(src: str) -> str:
    for line, text in WALK_EDITS[2:]:
        src = insert_before(src, line, text)
    src = insert_before(src, WALK_EDITS[0][0], "").replace(
        WALK_EDITS[0][0], WALK_EDITS[0][0] + "#include <cstdio>\n"
        + WALK_PROBE)
    return insert_before(src, WALK_EDITS[1][0], "").replace(
        WALK_EDITS[1][0], "  ClockProbe probe;\n  int n_tiles = 0;\n"
        "  const long long tstart = probe.tlast;\n")


def instrument(csrc: str) -> None:
    edit_file(csrc, "poa_fwd.cu", instrument_forward)
    edit_file(csrc, "poa_walk.cu", instrument_walk)


def set_warps(csrc: str, warps: int) -> None:
    """Sets the forward's warps a problem to `warps`."""
    edit_file(csrc, "poa_fwd.cu", lambda src: insert_before(
        src, WARPS_LINE, "").replace(WARPS_LINE, WARPS_LINE.replace(
            f"= {poa.FWD_WARPS};", f"= {warps};")))


def build_copy(tmp: str, name: str, edit) -> None:
    """Build and load the POA sources as edited by `edit(directory)`."""
    csrc = os.path.join(tmp, name)
    os.makedirs(csrc)
    for src in POA_SOURCES:
        shutil.copy(os.path.join(SOURCES, src), csrc)
    with open(os.path.join(csrc, "errors.cu"), "w") as fh:
        fh.write(ERRORS_CU)
    edit(csrc)
    _build.CSRC, _build._LIB = csrc, None
    _build.load_kernels()


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


def list_shape(arrays) -> str:
    """How the chunk's rows read their predecessors: the share of rows by
    live entries, and of entries 16 rows back or more (beyond the ring at
    W 256)."""
    _base, preds, nn, *_ = arrays
    live, far = [], []
    for b, n in enumerate(nn.tolist()):
        pr = preds[b, :n].astype(np.int64)
        rows = np.arange(1, n + 1)[:, None]
        live.append((pr >= 0).sum(axis=1))
        far.append(((pr >= 0) & (rows - pr >= 16)).sum(axis=1))
    live, far = np.concatenate(live), np.concatenate(far)
    shares = ", ".join(f"{k}: {np.mean(live == k) * 100:.1f}%"
                       for k in range(1, 4))
    return (f"rows by predecessors {shares}, 4+: "
            f"{np.mean(live >= 4) * 100:.1f}%; entries 16 rows back or more "
            f"{far.sum() / live.sum() * 100:.1f}%")


def forward_ms(fwd_in) -> float:
    """The forward's mean of 3 launches by CUDA events, after one
    untimed."""
    poa.poa_forward(*fwd_in)
    return chip_smoke.cuda_ms(lambda: poa.poa_forward(*fwd_in), 3)


def row_us(ms: float, arrays) -> str:
    return f"{ms:.3f} ms ({ms * 1000 / int(arrays[2].max()):.3f} us a row)"


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("poa_kernel_phases: needs a CUDA card")
    device = torch.device("cuda")
    smi = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"]).strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"card: {smi}, {sms} SMs", flush=True)
    arrays, params, W, l_cap = bench_chunk(device)
    wide = tuple(np.concatenate([a] * WIDE_COPIES) for a in arrays)
    launches = (("chunk", arrays), ("wide", wide))
    ins = {name: chip_smoke.poa_problem_tensors(a, params, W, device)
           for name, a in launches}
    # a quarter of a second of launches first: both kernels wait on
    # latency, so their times follow the card's clock, which an idle card
    # has let drop
    chip_smoke.cuda_ms(lambda: poa.poa_forward(*ins["chunk"][0]), 25)
    _f, w_ms, steps = chip_smoke.time_poa_kernels(arrays, params, W, l_cap,
                                                  device)
    print(f"chunk: {len(arrays[2])} problems, rows {arrays[2].tolist()}, W "
          f"{W}, {steps} walk steps; wide: the chunk x {WIDE_COPIES}, "
          f"{len(wide[2])} problems; {list_shape(arrays)}", flush=True)
    for name, a in launches:
        print(f"as built, {name}: forward ({poa.FWD_WARPS} warps a problem) "
              f"{row_us(forward_ms(ins[name][0]), a)}", flush=True)
    print(f"as built: step walk on the chunk {w_ms:.3f} ms", flush=True)
    wider = [(f"chunk at W {w}", chip_smoke.poa_problem_tensors(
        arrays, params, w, device)[0]) for w in (512, 1024)]
    print("instrumented: forward phases " + ", ".join(FWD_PHASES)
          + " (cycles a row of problem 0's thread 0, on the chunk); walk "
          "phases " + ", ".join(WALK_PHASES) + " (cycles of problem 0, "
          "summed over its tiles)", flush=True)
    # the copies link only the POA kernels
    signatures = _build._SIGNATURES
    _build._SIGNATURES = {k: v for k, v in signatures.items()
                          if k in POA_ENTRIES}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for warps in WARP_COUNTS:
                build_copy(tmp, f"warps{warps}",
                           lambda csrc: set_warps(csrc, warps))
                times = [f"{name} {row_us(forward_ms(ins[name][0]), a)}"
                         for name, a in launches]
                times += [f"{name} {row_us(forward_ms(args), arrays)}"
                          for name, args in wider]
                print(f"{warps} warps a problem: " + ", ".join(times),
                      flush=True)
                build_copy(tmp, f"phases{warps}", lambda csrc: (
                    set_warps(csrc, warps), instrument(csrc)))
                fwd_in, (nn, ends, ql) = ins["chunk"]
                # the launch prints its line; the first loads the library
                mats = poa.poa_forward(*fwd_in)
                t_f = chip_smoke.cuda_ms(lambda: poa.poa_forward(*fwd_in), 1)
                print(f"instrumented, {warps} warps a problem: forward "
                      f"{t_f:.3f} ms", flush=True)
            poa.poa_walk(nn, ends, ql, mats, l_cap)
            t_w = chip_smoke.cuda_ms(
                lambda: poa.poa_walk(nn, ends, ql, mats, l_cap), 1)
            torch.cuda.synchronize()
            print(f"instrumented: walk on the chunk {t_w:.3f} ms", flush=True)
    finally:
        _build._SIGNATURES = signatures


if __name__ == "__main__":
    main()
