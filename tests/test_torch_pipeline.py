"""The port's run_pipeline against mandalorion_tpu's: byte-identical
artifacts (the `_artifact_bytes` set of __graft_entry__.py) on a small
simulated run, modules A and D on the CPU through the kernels' plain
versions."""

import os

import pytest

from mandalorion_tpu.config import PipelineConfig as ReferenceConfig
from mandalorion_tpu.native import load_native
from mandalorion_tpu.pipeline.stages import run_pipeline as reference_run
from mandalorion_tpu.utils.simulate import make_dataset
from mandalorion_tpu_torch.config import PipelineConfig, PoaConfig
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
    reference_run(str(tmp_path / "ref"), *dataset, ReferenceConfig(threads=2))
    run_pipeline(str(tmp_path / "port"), *dataset, PipelineConfig(threads=2),
                 device="cpu")
    assert _artifacts(tmp_path / "port") == _artifacts(tmp_path / "ref")


def test_cli_matches_reference(tmp_path, dataset):
    genome, ann, reads = dataset
    reference_run(str(tmp_path / "ref"), *dataset, ReferenceConfig(threads=1))
    assert cli.main(["-p", str(tmp_path / "port"), "-G", genome, "-g", ann,
                     "-f", reads, "-t", "1", "--device", "cpu"]) == 0
    assert _artifacts(tmp_path / "port") == _artifacts(tmp_path / "ref")


@pytest.mark.parametrize("flags", [["--devices", "2"],
                                   ["--index_backend", "sharded"]])
def test_cli_rejects_unported_options(tmp_path, dataset, flags):
    """The two options the port once refused now run: --devices 2
    shards every dispatch over two CPU shards; --index_backend sharded
    without a mesh keeps the replicated index, as the reference does.
    Byte-identical to the reference either way."""
    genome, ann, reads = dataset
    reference_run(str(tmp_path / "ref"), *dataset, ReferenceConfig(threads=1))
    assert cli.main(["-p", str(tmp_path / "port"), "-G", genome, "-g", ann,
                     "-f", reads, "-t", "1", "--device", "cpu",
                     *flags]) == 0
    assert _artifacts(tmp_path / "port") == _artifacts(tmp_path / "ref")


def test_cli_device_choice():
    args = cli.build_parser().parse_args(["-G", "g.fa"])
    assert args.device == "cuda"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--device", "tpu"])


@pytest.fixture
def small_dataset(tmp_path):
    """Two genes x 8 reads: the plain PyTorch POA forward costs about a
    millisecond a graph row on the CPU."""
    make_dataset(str(tmp_path), n_genes=2, n_reads_per_gene=8,
                 genome_len=60_000, seed=1)
    return [os.path.join(tmp_path, f) for f in
            ("genome.fasta", "ann.gtf", "reads.fasta")]


def test_device_consensus_matches_reference(tmp_path, small_dataset,
                                            monkeypatch):
    """Module D through the port's POA device route (plain versions on the
    CPU). The reference's consensus backends give identical consensi, so
    its default run is the yardstick."""
    from mandalorion_tpu_torch.poa import kernels as poa
    reference_run(str(tmp_path / "ref"), *small_dataset,
                  ReferenceConfig(threads=2))
    obs = poa.RunObserver()
    monkeypatch.setattr(poa, "OBSERVER", obs)
    run_pipeline(str(tmp_path / "port"), *small_dataset,
                 PipelineConfig(threads=2, poa=PoaConfig(backend="device")),
                 device="cpu")
    assert obs.rounds > 0 and obs.chunks
    assert _artifacts(tmp_path / "port") == _artifacts(tmp_path / "ref")


def test_cli_device_consensus_matches_reference(tmp_path, small_dataset):
    genome, ann, reads = small_dataset
    reference_run(str(tmp_path / "ref"), *small_dataset,
                  ReferenceConfig(threads=1))
    assert cli.main(["-p", str(tmp_path / "port"), "-G", genome, "-g", ann,
                     "-f", reads, "-t", "1", "--device", "cpu",
                     "--consensus_backend", "device"]) == 0
    assert _artifacts(tmp_path / "port") == _artifacts(tmp_path / "ref")
