"""Shared set-up of the benchmark's own tests: the harness's modules on
the path, and a cell cut to a size that the CPU runs in seconds."""

import copy
import dataclasses
import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)

import bm_harness  # noqa: E402


def bench_json() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def tiny(cell: "bm_harness.Cell", genes: int = 4, top: int = 80,
         first_rank: int = 1):
    """The cell on 3 Mbp with 12 genes, its mix cut to `genes` genes at
    Zipf depths top / (first_rank + r), a pool of 2."""
    cell = dataclasses.replace(cell, config=copy.deepcopy(cell.config),
                               traffic=copy.deepcopy(cell.traffic))
    cell.config["layout"].update(genome_bp=3_000_000, n_genes=12)
    cell.traffic["expression"].update(genes=genes, zipf_top=top,
                                      first_rank=first_rank)
    cell.traffic["pool"] = 2
    return cell


@pytest.fixture
def tiny_cell():
    return tiny(bm_harness.find_cell(bench_json(), "chr21_r2c2.deep"))
