"""The benchmark's data generator."""

import importlib.util
import os

import numpy as np
import pytest

import bm_data
import bm_harness
from conftest import ROOT, bench_json, tiny


def _tool():
    path = os.path.join(ROOT, "tools", "run_configs_torch.py")
    spec = importlib.util.spec_from_file_location("run_configs_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _config(isoforms):
    return dict(layout=dict(
        chrom="chr1", genome_bp=3_000_000, n_genes=12, gene_offset=5000,
        exons_per_gene=[2, 7], exon_len=[150, 1200], intron_len=[200, 30_000],
        layout_seed=0, isoforms_per_gene=isoforms, isoform_seed=1))


@pytest.mark.parametrize("isoforms", [[1, 2], [1, 4]])
def test_layout_is_config3s_at_its_seeds(tmp_path, isoforms):
    """The layout at config-3's seeds and sizes gives the genome and the
    genes of tools/run_config3.py's dataset (tools/run_configs_torch.py's
    maker); each gene's first isoform is config-3's transcript."""
    _tool().config3_files(str(tmp_path), 12, 1, 3)
    gen = bm_harness._module("generators", "planted_isoforms")
    lay = gen.make_layout(_config(isoforms), 4)
    genome, ann = gen.write_layout(lay, str(tmp_path / "bench"))
    with open(genome, "rb") as a, open(tmp_path / "genome.fasta", "rb") as b:
        assert a.read() == b.read()
    with open(tmp_path / "ann.gtf") as fh:
        theirs = fh.read()
    with open(ann) as fh:
        mine = fh.read()
    firsts = "".join(line for line in mine.splitlines(True)
                     if '"T' in line and '.' not in
                     line.split('transcript_id "')[1].split('"')[0])
    assert firsts == theirs
    if isoforms == [1, 2]:
        assert mine == theirs
    else:
        assert len(mine) > len(theirs)
        assert max(len(g.isoforms) for g in lay.genes) == 3


def _pool(cell, seed, tmp_path, tag):
    gen = cell.generator
    lay = gen.make_layout(cell.config, bm_data.sub_seed(seed, 1))
    prof = gen.expression(cell.traffic, lay)
    samples = [gen.make_sample(lay, cell.config, prof,
                               bm_data.sub_seed(seed, 2, k),
                               str(tmp_path / f"{tag}{k}.fa"))
               for k in range(2)]
    return lay, samples, [open(s.path, "rb").read() for s in samples]


@pytest.mark.parametrize("cell", ["chr21_r2c2.deep",
                                  "chr21_r2c2_cardpoa.shallow",
                                  "chr21_r2c2_cardpoa.mixed"])
def test_pool_repeats_for_a_seed_and_differs_for_another(tmp_path, cell):
    # each mix under a configuration, whether or not BENCHMARK.json has
    # that cell
    bench = bench_json()
    config, traffic = cell.split(".", 1)
    if cell not in {w["name"] for w in bench["workloads"]}:
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1})
    cell = tiny(bm_harness.find_cell(bench, cell), genes=3, top=12)
    big = 2**31 + 7
    lay_a, sa, a = _pool(cell, big, tmp_path, "a")
    lay_b, _, b = _pool(cell, big, tmp_path, "b")
    lay_c, sc, c = _pool(cell, big + 1, tmp_path, "c")
    assert a == b and np.array_equal(lay_a.genome, lay_b.genome)
    assert a[0] != a[1]                  # the pool's samples differ
    assert a[0] != c[0] and not np.array_equal(lay_a.genome, lay_c.genome)
    # every seed has the same work: genes, isoforms, reads and lengths
    assert [(g.exons, g.isoforms) for g in lay_a.genes] == \
        [(g.exons, g.isoforms) for g in lay_c.genes]
    for x, y in zip(sa, sc):
        assert {k: v.shape for k, v in x.reads.items()} == \
            {k: v.shape for k, v in y.reads.items()}
    assert [len(x) for x in a] == [len(x) for x in c]


def test_reads_are_their_transcripts_with_substitutions(tmp_path):
    cell = tiny(bm_harness.find_cell(bench_json(), "chr21_r2c2.deep"),
                genes=4, top=200)
    lay, samples, _ = _pool(cell, 2**32 + 5, tmp_path, "s")
    rate = cell.config["reads"]["sub_rate"]
    diff = bases = 0
    for (g, i), block in samples[0].reads.items():
        t = lay.transcript(g, i)
        assert block.shape[1] == len(t)
        diff += int(np.count_nonzero(block != t))
        bases += block.size
    # every substitution changes its base
    assert abs(diff / bases - rate) < 0.2 * rate
    # several isoforms a gene, and exon skipping among them
    assert any(len(lay.genes[g].isoforms) > 1 for g, _ in samples[0].reads)


def test_mix_sizes():
    """The three mixes' sizes, as their files give them."""
    cell = bm_harness.find_cell(bench_json(), "chr21_r2c2.deep")
    gen = cell.generator
    lay = gen.make_layout(cell.config, 1)
    sizes = {}
    for mix in ("deep", "shallow", "mixed"):
        traffic = bm_harness._load_json("traffic", mix, bm_harness.HERE)
        prof = gen.expression(traffic, lay)
        sizes[mix] = (len({g for g, _, _ in prof}), len(prof),
                      sum(d for _, _, d in prof), max(d for _, _, d in prof))
    assert sizes["deep"] == (20, 34, 17_989, 2727)
    assert sizes["shallow"] == (200, 379, 8_835, 100)
    assert sizes["mixed"] == (60, 110, 9_356, 1333)
