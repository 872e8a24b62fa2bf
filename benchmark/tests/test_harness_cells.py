"""Cells found by name, BENCHMARK.json's form, and the run without a
card."""

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import bm_harness
from conftest import BENCH, ROOT, bench_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_cell_of_new_files_is_found_and_listed(tmp_path):
    """A later cell adds a configuration file, a traffic file, a
    generator file and an entry, and edits nothing."""
    for kind in ("configs", "traffic", "generators"):
        os.makedirs(tmp_path / kind)
    shutil.copy(os.path.join(BENCH, "configs", "chr21_r2c2.json"),
                tmp_path / "configs" / "chr21_r2c2.json")
    with open(os.path.join(BENCH, "generators", "planted_isoforms.py")) as fh:
        source = fh.read()
    (tmp_path / "generators" / "planted_twice.py").write_text(
        source + "\nTWICE = True\n")
    with open(os.path.join(BENCH, "configs", "chr21_r2c2.json")) as fh:
        cfg = json.load(fh)
    cfg["flags"] = ["--consensus_engine", "star"]
    cfg["generator"] = "planted_twice"
    (tmp_path / "configs" / "chr21_star.json").write_text(json.dumps(cfg))
    mix = {"why": "two genes", "expression": {"genes": 2, "zipf_top": 9,
                                               "first_rank": 1,
                                               "profile_seed": 3},
           "pool": 2}
    (tmp_path / "traffic" / "pair.json").write_text(json.dumps(mix))
    bench = bench_json()
    bench["per_layer"].append({"name": "poa_fwd_roofline", "unit": "%",
                               "moves": "reads_per_s",
                               "workloads": ["chr21_r2c2.deep"]})
    bench["workloads"].append({"name": "chr21_star.pair",
                               "config": "chr21_star", "traffic": "pair",
                               "chips": 4, "why": "x"})
    assert "chr21_star.pair" in bm_harness.list_cells(bench, str(tmp_path))
    assert "chr21_r2c2.deep" not in bm_harness.list_cells(bench,
                                                          str(tmp_path))
    cell = bm_harness.find_cell(bench, "chr21_star.pair", str(tmp_path))
    assert cell.config["flags"] == ["--consensus_engine", "star"]
    assert cell.traffic["expression"]["zipf_top"] == 9
    assert cell.generator.TWICE and cell.chips == 4
    assert [m["name"] for m in cell.end_to_end] == ["reads_per_s",
                                                    "setup_s"]
    # a metric limited to other cells is not this cell's
    assert "poa_fwd_roofline" not in [m["name"] for m in cell.per_layer]
    # the cell's own numbers compared, each with its limit
    assert set(cell.generator.NUMBERS) == set(cell.config["limits"])


def test_benchmark_json_keeps_to_its_form():
    b = bench_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           f"{w['traffic']}.json"))
    metrics = b["end_to_end"] + b["per_layer"]
    assert "setup_s" in [m["name"] for m in b["end_to_end"]]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] == "reads_per_s"
    for name in names + cells:
        assert NAME.match(name)


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command exits non-zero and prints no
    result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "chr21_r2c2.deep", "--seed", str(2**31 + 5),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "metrics" not in out.stdout


def test_an_orphan_of_the_program_is_reaped():
    """A process that a forked worker leaves behind ends as this run's
    child, and the run waits for it."""
    code = textwrap.dedent(f"""
        import os, sys, time
        sys.path.insert(0, {BENCH!r})
        import bm_harness
        bm_harness.adopt_orphans()
        worker = os.fork()
        if worker == 0:
            if os.fork() == 0:
                time.sleep(0.3)
            os._exit(0)
        os.waitpid(worker, 0)
        time.sleep(1.5)
        print(bm_harness.reap_children(), bm_harness.reap_children())
        """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "0"]
