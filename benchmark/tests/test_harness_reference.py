"""The plain reference against the port's host route, and the control
and the faults that `correct` has to catch, on the CPU at a small size."""

import os

import pytest

import bm_data
import bm_harness
import bm_reference
import control
from conftest import bench_json, tiny

HOST_ROUTE = ("--chain_backend", "native", "--dp_backend", "numpy",
              "--consensus_backend", "native")


def _sample(cell, seed, work):
    gen = cell.generator
    lay = gen.make_layout(cell.config, bm_data.sub_seed(seed, 1))
    genome, ann = gen.write_layout(lay, str(work / "ref"))
    prof = gen.expression(cell.traffic, lay)
    sample = gen.make_sample(lay, cell.config, prof,
                             bm_data.sub_seed(seed, 2, 0),
                             str(work / "s.fasta"))
    return lay, genome, ann, sample


@pytest.mark.parametrize("seed", [2**31 + 11, 2**33 + 3])
def test_reference_agrees_with_the_host_route(tmp_path, tiny_cell, seed):
    from mandalorion_tpu_torch.pipeline import cli
    lay, genome, ann, sample = _sample(tiny_cell, seed, tmp_path)
    out = str(tmp_path / "out")
    assert cli.main(["-p", out, "-G", genome, "-g", ann, "-f", sample.path,
                     *HOST_ROUTE, "--device", "cpu", "-t", "2"]) == 0
    got = tiny_cell.generator.judge(lay, tiny_cell.config, sample,
                                    bm_reference.parse_answer(out))
    assert got["aln_bad"] == 0 and got["consensus_bad"] == 0
    assert got["isoforms_off"] == 0 and got["required"] >= 4
    # a read whose junction the aligner places at an equal-scoring site
    # next to the planted one is rare: at most 2% here
    for k in ("introns_off", "misassigned", "counts_off"):
        assert got[k] <= 0.02 * got["reads"], got


def test_the_judge_names_a_consensus_one_base_long(tmp_path, tiny_cell):
    """Each transcript's column majority as its isoform is no consensus
    off; the same with one first base doubled is one, and its note says
    where."""
    gen = tiny_cell.generator
    lay, _, _, sample = _sample(tiny_cell, 2**31 + 23, tmp_path)
    isoforms = {f"I{g}.{i}": bm_reference.Isoform(
        lay.genes[g].strand, tuple(lay.exons(g, i)),
        gen.majority(block)[0].tobytes(), len(block))
        for (g, i), block in sample.reads.items()}
    answer = bm_reference.Answer({}, isoforms, {})
    got = gen.judge(lay, tiny_cell.config, sample, answer)
    assert got["consensus_bad"] == 0 and got["notes"] == []
    need = tiny_cell.config["judge"]["required_reads"]
    name, iso = next((f"I{g}.{i}", isoforms[f"I{g}.{i}"])
                     for (g, i), block in sample.reads.items()
                     if len(block) >= need)
    iso.seq = iso.seq[:1] + iso.seq
    got = gen.judge(lay, tiny_cell.config, sample, answer)
    assert got["consensus_bad"] == 1
    assert got["notes"][0].startswith(f"consensus {name} ")
    assert got["notes"][0].endswith("length +1")


def test_the_control_fails(tmp_path):
    cell = tiny(bm_harness.find_cell(bench_json(), "chr21_r2c2.deep"),
                genes=4, top=60)
    limits = cell.config["limits"]
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        got = control.control_numbers(cell, seed, 2, str(tmp_path))
        fails = [k for k in cell.generator.NUMBERS if got[k] > limits[k]]
        assert set(fails) >= {"introns_off_per_10k", "consensus_bad",
                              "misassigned_per_10k", "counts_off_per_10k"}


def _half_of_the_reads(monkeypatch):
    from mandalorion_tpu_torch.pipeline import stages
    original = stages.module_a

    def module_a(paths, *args, **kw):
        original(paths, *args, **kw)
        path = paths.t("mm2Alignments.psl")
        with open(path) as fh:
            lines = fh.readlines()
        with open(path, "w") as fh:
            fh.writelines(lines[::2])

    monkeypatch.setattr(stages, "module_a", module_a)


def _consensus_altered(monkeypatch):
    """Module D's answer altered where it is written: the middle base of
    every consensus."""
    from mandalorion_tpu_torch.pipeline import stages
    original = stages.module_d

    def module_d(paths, *args, **kw):
        original(paths, *args, **kw)
        path = paths.t("Isoform_Consensi.fasta")
        with open(path) as fh:
            lines = fh.read().split("\n")
        for j in range(1, len(lines), 2):
            seq = lines[j]
            if seq:
                mid = len(seq) // 2
                lines[j] = seq[:mid] + ("A" if seq[mid] != "A" else "C") \
                    + seq[mid + 1:]
        with open(path, "w") as fh:
            fh.write("\n".join(lines))

    monkeypatch.setattr(stages, "module_d", module_d)


def _consensus_gains_a_first_base(monkeypatch):
    """Module D's answer with its first base doubled, as the program's
    heaviest path gives it where one read's start aligns as an
    insertion."""
    from mandalorion_tpu_torch.pipeline import stages
    original = stages.module_d

    def module_d(paths, *args, **kw):
        original(paths, *args, **kw)
        path = paths.t("Isoform_Consensi.fasta")
        with open(path) as fh:
            lines = fh.read().split("\n")
        for j in range(1, len(lines), 2):
            lines[j] = lines[j][:1] + lines[j]
        with open(path, "w") as fh:
            fh.write("\n".join(lines))

    monkeypatch.setattr(stages, "module_d", module_d)


def _state_unchanged(monkeypatch):
    from mandalorion_tpu_torch import native
    monkeypatch.setattr(native, "native_poa_consensus",
                        lambda oriented, params: oriented[0])


@pytest.mark.parametrize("fault", [_half_of_the_reads, _consensus_altered,
                                   _consensus_gains_a_first_base,
                                   _state_unchanged])
def test_a_broken_run_is_not_correct(tmp_path, monkeypatch, tiny_cell,
                                     fault):
    """A run with the timed path broken underneath (everything but the
    look for a card) comes out not correct."""
    fault(monkeypatch)
    result = bm_harness.run_cell(tiny_cell, 2**31 + 99, 0.01, False,
                                 device="cpu", work_root=str(tmp_path))
    assert result["attempted"] >= 1
    assert result["correct"] is False, result["checks"]


def test_a_sound_run_is_correct(tmp_path, tiny_cell):
    """The same run with nothing broken: correct, its per-layer metrics
    read, and nothing left behind."""
    result = bm_harness.run_cell(tiny_cell, 2**31 + 99, 0.01, True,
                                 device="cpu", work_root=str(tmp_path))
    checks = result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["correct"] is True, checks
    assert checks["aln_bad"]["value"] == 0
    assert checks["consensus_bad"]["value"] == 0
    assert set(result["metrics"]) >= {"host_ms_per_kread", "A_ms_per_kread",
                                      "D_ms_per_kread"}
    assert os.listdir(tmp_path) == []       # the run left nothing behind
