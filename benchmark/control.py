"""The control of `correct`: the reference put in the program's place
with its exactness broken (the generator's `control_answer`), judged as
a run is judged, on a cell's own pool at its own size.

    python3 benchmark/control.py --workload <cell> --seeds <n>,<n>,...
                                 [--jobs <k>]

For each seed: the cell's genome, annotation and pool, as a run makes
them; `--jobs` samples of the pool (as many as a window runs) answered
by the control; the numbers compared and each one's limit, one JSON line
a seed. Needs no card and runs no program: a benchmark run never calls
it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import bm_data  # noqa: E402
import bm_harness  # noqa: E402


def control_numbers(cell, seed: int, jobs: int, work: str) -> dict:
    cfg, mix, gen = cell.config, cell.traffic, cell.generator
    lay = gen.make_layout(cfg, bm_data.sub_seed(seed, 1))
    profile = gen.expression(mix, lay)
    per_job = []
    for k in range(jobs):
        sample = gen.make_sample(lay, cfg, profile,
                                 bm_data.sub_seed(seed, 2,
                                                  k % int(mix["pool"])),
                                 os.path.join(work, "sample.fasta"))
        ans = gen.control_answer(lay, cfg, sample, seed + k)
        per_job.append(gen.judge(lay, cfg, sample, ans))
    return gen.numbers(per_job)


def main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--jobs", type=int, default=3)
    args = p.parse_args(argv)
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as fh:
        cell = bm_harness.find_cell(json.load(fh), args.workload)
    limits = cell.config["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory() as work:
            got = control_numbers(cell, seed, args.jobs, work)
        fails = [k for k in cell.generator.NUMBERS if got[k] > limits[k]]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": got, "limits": limits,
                          "fails": fails, "correct": not fails}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
