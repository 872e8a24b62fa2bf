"""Satellite-tool command line: `mando-tpu-torch-utils <subcommand>`.

Covers the reference's utils/ scripts (SURVEY §2.1 C16-C20) as
subcommands: polya, polya-nd, tpm, lrgasp, pslx, hla, phase, bam2fasta.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(prog="mando-tpu-torch-utils")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("polya", help="trim 3' polyA tails (directional)")
    sp.add_argument("-i", "--inFile", required=True)
    sp.add_argument("-o", "--outFile", required=True)
    sp.add_argument("-t", "--trimmedBases", default=None,
                    help="n5,n3 fixed end trim before tail detection")

    sp = sub.add_parser("polya-nd",
                        help="orient by polyA then trim (non-directional)")
    sp.add_argument("-i", "--inFile", required=True)
    sp.add_argument("-o", "--outFile", required=True)
    sp.add_argument("-t", "--trimmedBases", default=None)

    sp = sub.add_parser("tpm", help="recompute TPM from a quant file "
                                    "(column-sum denominator)")
    sp.add_argument("quant")
    sp.add_argument("out")

    sp = sub.add_parser("lrgasp", help="export LRGASP submission files")
    sp.add_argument("mando_folder")
    sp.add_argument("model_folder")
    sp.add_argument("expr_folder")
    sp.add_argument("sample_ids", help="comma separated")

    sp = sub.add_parser("pslx", help="psl + fastas -> pslx")
    sp.add_argument("-p", "--psl", required=True)
    sp.add_argument("-r", "--reads", required=True)
    sp.add_argument("-g", "--targets", required=True)
    sp.add_argument("-x", "--out", required=True)

    sp = sub.add_parser("hla", help="HLA typing of isoforms")
    sp.add_argument("-r", "--reads_fasta_file", required=True)
    sp.add_argument("-g", "--genome_fasta_file", required=True)
    sp.add_argument("-f", "--hla_fasta_file", required=True)

    sp = sub.add_parser("phase", help="SNP phasing (TurboPhaser)")
    sp.add_argument("-v", "--vcf_file", required=True)
    sp.add_argument("-r", "--pslx_file_for_phasing", required=True)
    sp.add_argument("-s", "--pslx_files_to_be_sorted", required=True,
                    help="comma separated")
    sp.add_argument("-p", "--output_path", required=True)

    sp = sub.add_parser("index", help="prebuild a genome minimizer index"
                        " (.npz; minimap2 -d analogue)")
    sp.add_argument("genome")
    sp.add_argument("out", help=".npz path (use with mando-tpu-torch"
                    " --index_cache)")
    sp.add_argument("-k", "--kmer", type=int, default=15)
    sp.add_argument("-w", "--window", type=int, default=5)

    sp = sub.add_parser("bam2fasta", help="PacBio BAM -> fasta")
    sp.add_argument("bam")
    sp.add_argument("fasta")

    sp = sub.add_parser("emtrey", help="SAM -> (extended) PSL")
    sp.add_argument("-i", "--inputFile", required=True)
    sp.add_argument("-o", "--outputFile", required=True)
    sp.add_argument("-m", "--mando", action="store_true",
                    help="24-col extended PSL for pipeline-internal use")

    sp = sub.add_parser("clean-psl", help="merge sub-intron gaps in a PSL")
    sp.add_argument("psl")
    sp.add_argument("out")
    sp.add_argument("--keep-secondary", action="store_true",
                    help="keep all alignments per read (default: first only)")

    args = p.parse_args(argv)

    if args.cmd in ("polya", "polya-nd"):
        from mandalorion_tpu_torch.utils.polya import trim_fastx
        tb = (tuple(int(x) for x in args.trimmedBases.split(","))
              if args.trimmedBases else None)
        n = trim_fastx(args.inFile, args.outFile, tb,
                       directional=args.cmd == "polya")
        print(f"\t{n} reads written")
    elif args.cmd == "tpm":
        from mandalorion_tpu_torch.core.quant import convert_quant_to_tpm
        convert_quant_to_tpm(args.quant, args.out)
    elif args.cmd == "lrgasp":
        from mandalorion_tpu_torch.utils.lrgasp import export_lrgasp
        export_lrgasp(args.mando_folder, args.model_folder,
                      args.expr_folder, args.sample_ids.split(","))
    elif args.cmd == "pslx":
        from mandalorion_tpu_torch.io.fastx import fastx_to_dict
        from mandalorion_tpu_torch.utils.pslx import psl_to_pslx
        psl_to_pslx(args.psl, fastx_to_dict(args.reads),
                    fastx_to_dict(args.targets), args.out)
    elif args.cmd == "hla":
        from mandalorion_tpu_torch.io.fastx import fastx_to_dict
        from mandalorion_tpu_torch.utils.hla import (
            find_gene_matches, type_alleles)
        genome = fastx_to_dict(args.genome_fasta_file)
        match = find_gene_matches(args.reads_fasta_file, genome)
        for name, cat, mism, indels, length in type_alleles(
                args.reads_fasta_file, match, args.hla_fasta_file):
            print("Best Match", cat, "Mismatches:", mism, "Indels:",
                  indels, "Alignment length:", length)
    elif args.cmd == "phase":
        from mandalorion_tpu_torch.utils.phaser import phase
        phase(args.vcf_file, args.pslx_file_for_phasing,
              args.pslx_files_to_be_sorted.split(","), args.output_path)
    elif args.cmd == "index":
        import time
        from mandalorion_tpu_torch.align.index import build_index, save_index
        from mandalorion_tpu_torch.io.fastx import fastx_to_dict
        t0 = time.time()
        idx = build_index(fastx_to_dict(args.genome), args.kmer,
                          args.window)
        save_index(idx, args.out)
        print(f"\t{len(idx.sorted_hashes)} minimizers in "
              f"{time.time() - t0:.1f}s -> {args.out}")
    elif args.cmd == "bam2fasta":
        from mandalorion_tpu_torch.io.bam import bam_to_fasta
        n = bam_to_fasta(args.bam, args.fasta)
        print(f"\t{n} records written")
    elif args.cmd == "emtrey":
        from mandalorion_tpu_torch.io.sam import sam_to_psl
        sam_to_psl(args.inputFile, args.outputFile, mando=args.mando)
    elif args.cmd == "clean-psl":
        from mandalorion_tpu_torch.core.cleanpsl import clean_psl_file
        clean_psl_file(args.psl, args.out, primary=not args.keep_secondary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
