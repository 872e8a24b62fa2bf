"""The benchmark of mandalorion_tpu_torch on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Run from the root of a checkout. The cell is an entry of BENCHMARK.json's
`workloads`; its configuration and traffic mix are the files
benchmark/configs/<config>.json and benchmark/traffic/<traffic>.json, its
metrics the readers benchmark/metrics/<metric>.py.

Set-up: the card, the port's kernel and native libraries (built on first
use into their fixed directories in the checkout), the genome,
annotation and pool of samples from the seed by the configuration's
generator (benchmark/generators/<name>.py; under TMPDIR; their seconds
are printed and left out of setup_s), and one warm-up job over one more
sample of the mix, which writes the index cache that every timed job
loads. The window: whole jobs, one at a time, each a call of the port's
command line entry in this process over the pool's next sample; jobs
start while their seconds sum to less than --seconds. Between jobs, and
outside the window's seconds, each job's answer is read and its files
deleted. The process adopts the orphans of the program's workers (a child
subreaper) and waits for those that have ended once the window closes.
After the window every job's answer is judged against the
generator's plain reference. The last line of stdout is the result, one
JSON object; the numbers compared close stderr.

--trace 1 traces every job's stages (MANDO_TPU_PROFILE) and reports the
per-layer metrics; --trace 0 reports the end-to-end metrics. Without a
CUDA card the command prints no result and exits with code 3.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=(0, 1))
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed is a whole number >= 0")

    # the program builds its kernel and native libraries into fixed
    # directories inside the checkout (mandalorion_tpu_torch/_build,
    # native/_build) and reads no cache path from the environment
    for name in ("MANDO_TPU_NO_NATIVE", "MANDO_TPU_PROFILE"):
        os.environ.pop(name, None)
    sys.path.insert(0, HERE)
    if ROOT not in sys.path:
        sys.path.insert(1, ROOT)
    import bm_harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = bm_harness.find_cell(bench, args.workload)
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no CUDA card for {args.workload} (needs {chips}): "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 3

    bm_harness.adopt_orphans()
    result = bm_harness.run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), device="cuda", reap=True)
    found = bm_harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures "
              f"the port alone", file=sys.stderr)
        return 4
    result["device"]["kind"] = torch.cuda.get_device_name()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
