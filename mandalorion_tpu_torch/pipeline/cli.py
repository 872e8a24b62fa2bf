"""`mando-tpu-torch`: the `mando-tpu` command line with module A on a
CUDA device.

    mando-tpu-torch -p out -g ann.gtf -G genome.fa -f reads.fofn --device cuda

It takes the `mando-tpu` flag set plus --device. Module A always runs
the port's device route, so --dp_backend and --chain_backend select
nothing here; --devices > 1, --index_backend sharded and
--consensus_backend device are not yet ported and raise.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

from mandalorion_tpu.config import config_from_args
from mandalorion_tpu.pipeline.cli import build_parser as _reference_parser
from mandalorion_tpu.pipeline.stages import Paths
from mandalorion_tpu_torch.pipeline.stages import run_pipeline


def build_parser() -> argparse.ArgumentParser:
    p = _reference_parser()
    p.usage = ("\n\nmando-tpu-torch -p . -g gencodeV29.gtf -G hg38.fasta "
               "-f reads.fofn --device cuda\n")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device for module A's chain and DP kernels (cpu "
                        "runs their plain PyTorch versions)")
    return p


def _not_ported(args) -> None:
    if int(args.devices or 0) > 1:
        raise NotImplementedError("--devices is not yet ported to "
                                  "mandalorion_tpu_torch")
    if args.index_backend == "sharded":
        raise NotImplementedError("--index_backend sharded is not yet "
                                  "ported to mandalorion_tpu_torch")
    if args.consensus_backend == "device":
        raise NotImplementedError("--consensus_backend device is not yet "
                                  "ported to mandalorion_tpu_torch")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    parser = build_parser()
    if not argv:
        parser.print_help()
        return 0
    args = parser.parse_args(argv)
    _not_ported(args)
    cfg = config_from_args(args)
    if args.external_sam:
        # as mando-tpu: the SAM replaces module A's alignments
        paths = Paths(args.path)
        os.makedirs(paths.tmp, exist_ok=True)
        shutil.copy(args.external_sam, paths.t("mm2Alignments.sam"))
        stale = paths.t("mm2Alignments.psl")
        if os.path.exists(stale):
            os.remove(stale)
        if "A" in cfg.modules:
            cfg = cfg.replace(modules=cfg.modules.replace("A", ""))
    run_pipeline(args.path, args.genome_sequence, args.genome_annotation,
                 args.Consensus_reads, cfg, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
