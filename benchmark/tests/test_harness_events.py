"""The generator `isoform_events` of cell chr21_r2c2_isoforms.mixed: its
layout's rules, the judge against answers that split or merge tandem
pairs, the control, a tiny sound run on the CPU, and the readers of the
spans it adds."""

import collections
import os

import numpy as np
import pytest

import bm_data
import bm_harness
import bm_reference
import control
from conftest import bench_json, tiny
from mandalorion_tpu_torch.pipeline import observe

CELL = "chr21_r2c2_isoforms.mixed"
# short exons and introns and near tandem sites: the plain POA forward of
# --consensus_backend device costs about a millisecond a graph row here
SHORT = dict(genome_bp=1_500_000, n_genes=6, exon_len=[150, 250],
             intron_len=[200, 1200], exons_per_gene=[2, 5], isoform_seed=48)


@pytest.fixture(scope="module")
def cell():
    return bm_harness.find_cell(bench_json(), CELL)


@pytest.fixture(scope="module")
def full(cell):
    """The cell's layout at its own size, from a large seed."""
    return cell.generator.make_layout(cell.config,
                                      bm_data.sub_seed(2**31 + 3, 1))


def _short(cell, top, flags=None):
    cell = tiny(cell, genes=3, top=top)
    cell.config["layout"].update(SHORT)
    cell.config["events"]["tandem_ext"] = [300, 320]
    cell.traffic["expression"]["profile_seed"] = 4
    if flags is not None:
        cell.config["flags"] = flags
    return cell


def _overlaps(a, b) -> bool:
    return a[0] < b[1] and b[0] < a[1]


def test_main_chains_are_planted_isoforms(cell, full):
    """Each gene's main isoform is planted_isoforms' first (config-3's
    gene) at the same layout keys and seeds."""
    other = bm_harness.find_cell(bench_json(), "chr21_r2c2_cardpoa.mixed")
    theirs = other.generator.make_layout(other.config, 1)
    assert [g.exons for g in full.genes] == [g.exons for g in theirs.genes]
    assert all(g.isoforms[0] == g.exons and g.kinds[0] == "main"
               for g in full.genes)


def test_layout_keeps_its_rules(cell, full):
    """New exons inside the gene's slot and off every other exon; tandem
    sites 300 bp or more apart; at most 7 A after each polyA site; retained
    introns of 5,000 bp or less; GT..AG at every junction, which cannot
    slide; each gene's further isoforms of distinct kinds."""
    ev = cell.config["events"]
    genome = full.genome
    seen = collections.Counter()
    for gene in full.genes:
        main = gene.exons
        kinds = gene.kinds[1:]
        assert len(set(kinds)) == len(kinds) <= ev["further"]
        seen.update(kinds)
        for iso, kind in zip(gene.isoforms, gene.kinds):
            assert iso == sorted(iso)
            assert all(a[1] < b[0] for a, b in zip(iso, iso[1:]))
            assert gene.slot[0] <= iso[0][0] and iso[-1][1] <= gene.slot[1]
            donor, acceptor = ((b"GT", b"AG") if gene.strand == "+"
                               else (b"CT", b"AC"))
            for (_s1, e1), (s2, _e2) in zip(iso, iso[1:]):
                assert genome[e1:e1 + 2].tobytes() == donor
                assert genome[s2 - 2:s2].tobytes() == acceptor
                # no junction slides to a place that reads the same bases
                assert genome[e1 - 1] != genome[s2 - 1]
                assert genome[s2] != genome[e1]
            site = cell.generator.polya_site(iso, gene.strand)
            lo, hi = cell.generator.polya_window(site, gene.strand,
                                                 ev["polya_window"])
            a = b"A" if gene.strand == "+" else b"T"
            assert genome[lo:hi].tobytes().count(a) <= ev["polya_a_max"]
            new = [x for x in iso if x not in main]
            if kind in ("alt_first", "alt_last"):
                assert len(new) == 1
                assert not any(_overlaps(new[0], x) for x in main)
            if kind == "alt_last":
                tx = main if gene.strand == "+" else main[::-1]
                s, e = cell.generator._last_intron(tx)
                m = ev["alt_last_margin"]
                assert s + m <= new[0][0] and new[0][1] <= e - m
            if kind == "retained":
                assert len(iso) == len(main) - 1
                gaps = [b[0] - a[1] for a, b in zip(main, main[1:])]
                kept = [b[0] - a[1] for a, b in zip(main, main[1:])
                        if (a[0], b[1]) in iso]
                assert kept == [min(gaps)] and min(gaps) <= \
                    ev["retained_max"]
            if kind == "tandem":
                far = abs(cell.generator.polya_site(iso, gene.strand)
                          - cell.generator.polya_site(main, gene.strand))
                assert ev["tandem_ext"][0] <= far < ev["tandem_ext"][1]
                assert far >= 300
    assert set(seen) == set(cell.generator.KINDS)


def test_mix_sizes(cell, full):
    """mixed's 60 genes (cardpoa.mixed's) with their events: 292 isoforms
    of 3 reads or more, 174 of 10 or more, 9,360 reads; 22 genes have an
    intron short enough to retain."""
    prof = cell.generator.expression(cell.traffic, full)
    genes = {g for g, _, _ in prof}
    depth = [d for _, _, d in prof]
    assert (len(genes), len(prof), sum(depth)) == (60, 292, 9_360)
    assert min(depth) >= 3 and sum(d >= 10 for d in depth) == 174
    ev, lay = cell.config["events"], cell.config["layout"]
    retains = [g for g in genes if "retained" in cell.generator._allowed(
        full.genes[g].exons, full.genes[g].strand, full.genes[g].slot, lay,
        ev)]
    assert len(retains) == 22


def _planted_answer(gen, lay, sample, merge_tandem=False):
    """What a sound program answers: each read aligned along its
    transcript's exons, an isoform for each transcript of 3 reads or more
    with its column majority as sequence, every read assigned to its
    transcript's isoform; with `merge_tandem`, each tandem-UTR isoform's
    reads assigned to, and counted in, its gene's main isoform."""
    alignments, isoforms, assigned = {}, {}, {}
    for (g, i), block in sample.reads.items():
        gene = lay.genes[g]
        exons = lay.exons(g, i)
        blocks = tuple((s, e - s) for s, e in exons)
        starts = tuple(np.cumsum([0] + [b for _s, b in blocks[:-1]]))
        owner = 0 if merge_tandem and gene.kinds[i] == "tandem" else i
        name = f"I{g}.{owner}"
        if owner == i and len(block) >= 3:
            isoforms[name] = bm_reference.Isoform(
                gene.strand, tuple(exons), gen.majority(block)[0].tobytes(),
                0)
        for k, read in enumerate(block):
            a = bm_reference.Alignment(gene.strand, blocks, starts, 0, 0)
            a.matches, a.mismatches = bm_reference.recount(lay.genome, read,
                                                           a)
            alignments[gen.read_name(g, i, k)] = [a]
            if name in isoforms:
                assigned[gen.read_name(g, i, k)] = name
                isoforms[name].count += 1
    return bm_reference.Answer(alignments, isoforms, assigned)


def test_merged_tandem_pairs_are_not_correct(cell, tmp_path):
    """The planted answer reads 0 on every number; the same answer with
    each tandem pair merged into one isoform misses the tandem reads and
    is not correct."""
    small = tiny(cell, genes=12, top=600)
    gen, limits = small.generator, small.config["limits"]
    lay = gen.make_layout(small.config, bm_data.sub_seed(2**31 + 9, 1))
    prof = gen.expression(small.traffic, lay)
    sample = gen.make_sample(lay, small.config, prof,
                             bm_data.sub_seed(2**31 + 9, 2, 0),
                             str(tmp_path / "s.fasta"))
    sound = gen.numbers([gen.judge(lay, small.config, sample,
                                   _planted_answer(gen, lay, sample))])
    assert all(v == 0 for v in sound.values()), sound
    merged = gen.numbers([gen.judge(lay, small.config, sample,
                                    _planted_answer(gen, lay, sample,
                                                    True))])
    assert merged["missed_per_10k"] > limits["missed_per_10k"], merged
    assert merged["aln_bad"] == merged["consensus_bad"] == 0


def test_the_control_fails(cell, tmp_path):
    small = tiny(cell, genes=12, top=600)
    limits = small.config["limits"]
    for seed in (2**31 + 1, 2**31 + 2):
        got = control.control_numbers(small, seed, 2, str(tmp_path))
        fails = {k for k in small.generator.NUMBERS if got[k] > limits[k]}
        assert fails >= {"introns_off_per_10k", "consensus_bad",
                         "misassigned_per_10k", "counts_off_per_10k",
                         "missed_per_10k"}, got


def test_a_tiny_sound_run_is_correct(cell, tmp_path):
    """A traced run of 3 short genes of every event kind, each transcript
    of 3 reads or more, on the native consensus engine (the plain POA
    forward of the cell's own flags would take minutes here; the tests of
    the port compare that route with the native one on such a sample):
    correct; F_rules_ms_per_kread and D_ends_ms_per_kread read numbers,
    each inside its stage's share; nothing left behind."""
    result = bm_harness.run_cell(_short(cell, top=80, flags=[]),
                                 2**31 + 7, 0.01, True, device="cpu",
                                 work_root=str(tmp_path))
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["correct"] is True, result["checks"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert 0 < metrics["D_ends_ms_per_kread"] < \
        metrics["D_prepare_ms_per_kread"]
    assert 0 < metrics["F_rules_ms_per_kread"] < \
        metrics["host_ms_per_kread"]
    assert os.listdir(tmp_path) == []


def test_new_readers_read_nothing_without_their_spans(monkeypatch):
    """A program whose runs have no such spans (the parent commit's):
    None, not 0."""
    timer = observe.StageTimer(None)
    timer.started, timer.ended = 10.5, 13.5
    timer.spans = {("F_filter", "", "filter.chroms"): [1, 0.2, None],
                   ("D_define", "", "define.prepare"): [1, 0.4, None]}
    monkeypatch.setattr(observe, "RUNS", collections.deque([timer]))
    job = bm_harness.Job(0, 2000, 10.0, 14.0, {}, trace={})
    run = bm_harness.Run("c", True, True, 1.0, 1.0, [job])
    for name in ("F_rules_ms_per_kread", "D_ends_ms_per_kread"):
        assert bm_harness.reader(name)(run) is None
    timer.spans[("D_define", "define.prepare", "define.ends")] = \
        [1, 0.3, 12]
    assert bm_harness.reader("D_ends_ms_per_kread")(run) == \
        pytest.approx(1e6 * 0.3 / 2000)
    assert bm_harness.reader("F_rules_ms_per_kread")(run) is None
