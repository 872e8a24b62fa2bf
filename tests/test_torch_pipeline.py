"""The port's run_pipeline against mandalorion_tpu's: byte-identical
artifacts (the `_artifact_bytes` set of __graft_entry__.py) on a small
simulated run, module A on the CPU through the kernels' plain versions."""

import os

import pytest

from mandalorion_tpu.config import PipelineConfig, PoaConfig
from mandalorion_tpu.native import load_native
from mandalorion_tpu.pipeline.stages import run_pipeline as reference_run
from mandalorion_tpu.utils.simulate import make_dataset
from mandalorion_tpu_torch.pipeline import cli
from mandalorion_tpu_torch.pipeline.stages import run_pipeline

pytestmark = pytest.mark.skipif(load_native() is None,
                                reason="native library unavailable")

ARTIFACTS = ("Isoforms.filtered.fasta", "Isoforms.filtered.clean.psl",
             "Isoforms.filtered.clean.gtf", "Isoforms.filtered.clean.quant",
             "Isoforms.filtered.clean.tpm",
             os.path.join("tmp", "reads2isoforms.txt"))


def _artifacts(out_dir):
    blobs = {}
    for name in ARTIFACTS:
        with open(os.path.join(out_dir, name), "rb") as fh:
            blobs[name] = fh.read()
        assert blobs[name], name
    return blobs


@pytest.fixture
def dataset(tmp_path):
    make_dataset(str(tmp_path), n_genes=3, n_reads_per_gene=20,
                 genome_len=90_000, seed=0)
    return [os.path.join(tmp_path, f) for f in
            ("genome.fasta", "ann.gtf", "reads.fasta")]


def test_artifacts_match_reference(tmp_path, dataset):
    cfg = PipelineConfig(threads=2)
    reference_run(str(tmp_path / "ref"), *dataset, cfg)
    run_pipeline(str(tmp_path / "port"), *dataset, cfg, device="cpu")
    assert _artifacts(tmp_path / "port") == _artifacts(tmp_path / "ref")


def test_cli_matches_reference(tmp_path, dataset):
    genome, ann, reads = dataset
    reference_run(str(tmp_path / "ref"), *dataset, PipelineConfig(threads=1))
    assert cli.main(["-p", str(tmp_path / "port"), "-G", genome, "-g", ann,
                     "-f", reads, "-t", "1", "--device", "cpu"]) == 0
    assert _artifacts(tmp_path / "port") == _artifacts(tmp_path / "ref")


@pytest.mark.parametrize("flags", [["--devices", "2"],
                                   ["--index_backend", "sharded"],
                                   ["--consensus_backend", "device"]])
def test_cli_rejects_unported_options(tmp_path, dataset, flags):
    genome, ann, reads = dataset
    with pytest.raises(NotImplementedError, match="not yet ported"):
        cli.main(["-p", str(tmp_path / "x"), "-G", genome, "-g", ann,
                  "-f", reads, "--device", "cpu", *flags])


def test_cli_device_choice():
    args = cli.build_parser().parse_args(["-G", "g.fa"])
    assert args.device == "cuda"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--device", "tpu"])


def test_poa_device_backend_not_ported(tmp_path, dataset):
    cfg = PipelineConfig(poa=PoaConfig(backend="device"))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        run_pipeline(str(tmp_path / "x"), *dataset, cfg, device="cpu")
