"""`mando-tpu-torch`: the Mando-compatible command line
(`Mando.py:21-199` flag set) on PyTorch and CUDA.

    mando-tpu-torch -p . -g ann.gtf -G genome.fa -f reads.fofn

It takes the `mando-tpu` flag set plus --device. Module A runs the pair
--chain_backend {device,native} x --dp_backend {device,rowscan,numpy}
(the reference's dp 'pallas' is 'device' here). The default, device and
device, runs the chain and DP kernels on --device; the host route
(native C++ in -t forked workers, a process that never touches CUDA) is

    mando-tpu-torch ... --chain_backend native --dp_backend numpy

and every other pair runs module A in this process with the device
parts on --device: a device chain stages each batch through the C seed,
fill and emit stages around the chain kernel, a native chain picks each
read's chain in C and fills its gaps in Python before the batch's DP
problem list goes to the DP backend. 'rowscan' runs the DP kernel's
plain PyTorch version on --device, and only when named.

--consensus_backend device runs module D's graph POA through the POA
kernels on --device. --devices N > 1 installs an N-shard mesh of --device
around the run (parallel.mesh.make_mesh: N distinct cards, or N virtual
shards on the CPU); every batched device dispatch shards over it, with
byte-identical results. --index_backend sharded splits the genome index
into hash ranges over that mesh.

MANDO_TPU_NO_NATIVE=1 runs without the port's native C++ library (it is
then neither built nor loaded): seeding, gap fill, the host DP and PSL
emission take their numpy twins and Python staging, a device chain runs
the batch's segment lists through the chain kernel, and
--consensus_backend auto resolves to device. The kernels stay on
--device; the artifacts do not change.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import sys

from mandalorion_tpu_torch.config import config_from_args
from mandalorion_tpu_torch.parallel.mesh import make_mesh, use_mesh
from mandalorion_tpu_torch.pipeline.stages import (
    VERSION, Paths, run_pipeline)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        usage=("\n\nmando-tpu-torch -p . -g gencodeV29.gtf -G hg38.fasta "
               "-f reads.fofn --device cuda\n"))
    p.add_argument("-p", "--path", type=str, default=".",
                   help="Directory to put output files into")
    p.add_argument("-u", "--upstream_buffer", type=str, default="10",
                   help="upstream leniency window for polyA/TSS (default 10)")
    p.add_argument("-d", "--downstream_buffer", type=str, default="50",
                   help="downstream leniency window (default 50)")
    p.add_argument("-g", "--genome_annotation", type=str, default="None",
                   help="Genome annotation file (gtf)")
    p.add_argument("-G", "--genome_sequence", type=str,
                   help="Genome file (fasta)")
    p.add_argument("-r", "--minimum_ratio", type=str, default="0.01",
                   help="min proportion of locus reads per isoform")
    p.add_argument("-i", "--minimum_internal_ratio", type=str, default="1")
    p.add_argument("-R", "--minimum_reads", type=str, default="3",
                   help="minimum reads per isoform (default 3)")
    p.add_argument("-f", "--Consensus_reads", type=str,
                   help="fasta/fastq path, comma list, or .fofn")
    p.add_argument("-O", "--overhangs", type=str, default="0,40,0,40",
                   help="min5,max5,min3,max3 unaligned end bounds")
    p.add_argument("-t", "--minimap2_threads", type=str, default="8",
                   help="host threads")
    p.add_argument("-I", "--minimum_isoform_length", type=str, default="200")
    p.add_argument("-n", "--minimum_feature_count", type=str, default="2")
    p.add_argument("-w", "--splice_site_window", type=str, default="1")
    p.add_argument("-A", "--Acutoff", type=str, default="0.5")
    p.add_argument("-W", "--white_list_polyA", type=str, default="0")
    p.add_argument("-m", "--multi_exon_only", default="0",
                   action="store_const", const="1")
    p.add_argument("-j", "--junctions", type=str,
                   default="gtag,gcag,atac,ctac,ctgc,gtat")
    p.add_argument("-M", "--Modules", default="APDFQ",
                   help="modules to run: subset of APDFQ")
    p.add_argument("-P", "--pacbio", default=False, action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--dp_backend", default="device",
                   choices=["device", "rowscan", "numpy"],
                   help="gap-fill DP backend (bit-identical): device = "
                        "the CUDA kernel csrc/dp.cu on --device, rowscan "
                        "= its plain PyTorch row scan on --device, numpy "
                        "= host native C++")
    p.add_argument("--chain_backend", default="device",
                   choices=["device", "native"],
                   help="chain DP backend: device = one launch of the "
                        "CUDA kernel csrc/chain.cu per read batch on "
                        "--device, native = the host C++ chain a read "
                        "(with --dp_backend numpy: the host route in -t "
                        "forked workers)")
    p.add_argument("--consensus_engine", default="graph",
                   choices=["star", "graph"],
                   help="isoform consensus engine: star (backbone+votes, "
                        "fast path) or graph (full partial-order "
                        "alignment; batched on device per locus)")
    p.add_argument("--consensus_backend", default="auto",
                   choices=["auto", "native", "device"],
                   help="graph-POA execution backend: auto (the host "
                        "C++ engine; device under MANDO_TPU_NO_NATIVE), "
                        "native, or device (the batched POA kernels on "
                        "--device)")
    p.add_argument("--index_backend", default="replicated",
                   choices=["replicated", "sharded"],
                   help="genome index placement: replicated per host, or "
                        "sharded by hash range over the device mesh "
                        "(requires --devices > 1 or an installed mesh)")
    p.add_argument("--devices", default=0, type=int,
                   help="install an N-device mesh around the run: every "
                        "batched device dispatch (chain DP, gap-fill DP, "
                        "POA, quant merge) shards over it; 0 = no mesh "
                        "(single device). Results are byte-identical at "
                        "any N")
    p.add_argument("--index_cache", default="", type=str,
                   help="persist/reuse the genome minimizer index at this"
                        " .npz path (minimap2 .mmi analogue); rebuilt"
                        " automatically when genome or k/w change")
    p.add_argument("--external_sam", default=None, type=str,
                   help="use alignments from this SAM file instead of the "
                        "built-in aligner (the reference's --mm2_path "
                        "interop: run with -M PDFQ)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the device routes (cpu runs the "
                        "kernels' plain PyTorch versions)")
    p.add_argument("-v", "--version", action="version", version=VERSION)
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    parser = build_parser()
    if not argv:
        parser.print_help()
        return 0
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if args.external_sam:
        paths = Paths(args.path)
        os.makedirs(paths.tmp, exist_ok=True)
        shutil.copy(args.external_sam, paths.t("mm2Alignments.sam"))
        # a stale PSL from a previous run would shadow the external SAM
        # (module P only converts when the PSL is absent/empty)
        stale = paths.t("mm2Alignments.psl")
        if os.path.exists(stale):
            os.remove(stale)
        if "A" in cfg.modules:
            cfg = cfg.replace(modules=cfg.modules.replace("A", ""))
    mesh = (make_mesh(int(args.devices), device=args.device)
            if int(args.devices or 0) > 1 else None)
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        run_pipeline(args.path, args.genome_sequence,
                     args.genome_annotation, args.Consensus_reads, cfg,
                     device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
