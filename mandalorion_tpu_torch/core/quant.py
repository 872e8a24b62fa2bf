"""Per-sample isoform quantification (module Q).

Equivalent of `assignReadsToIsoforms.py`: map every read to the sample file
it came from, count reads per (filtered isoform, sample), and emit quant +
TPM tables. Reference quirks preserved: only reads assigned to *filtered*
isoforms are counted, but TPM divides by ALL reads in the sample
(`assignReadsToIsoforms.py:44-46`); rows end with a trailing tab; TPM is
rounded to 3 decimals.

The count matrix itself is one segment-sum over (isoform_idx, sample_idx)
pairs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from mandalorion_tpu_torch.io.fastx import read_fastx


def map_read_locations(fasta_list: Sequence[str]
                       ) -> Tuple[List[str], Dict[str, str], Dict[str, int]]:
    """read name -> sample path, plus total reads per sample
    (`mapReadLocation`, :51-69). Missing/empty sample files stay listed
    with zero reads (module A tolerates them; Q must not crash at the
    end of a long run)."""
    import os
    sample_list: List[str] = []
    read_map: Dict[str, str] = {}
    totals: Dict[str, int] = {}
    for path in fasta_list:
        path = path.strip()
        sample_list.append(path)
        totals[path] = 0
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            continue
        for name, _seq, _q in read_fastx(path):
            read_map[name] = path
            totals[path] += 1
    return sample_list, read_map, totals


def read_r2i(r2i_path: str) -> Dict[str, List[str]]:
    """reads2isoforms.txt -> isoform -> [read names] (`read_r2i`, :72-86)."""
    r2i: Dict[str, List[str]] = {}
    with open(r2i_path) as fh:
        for line in fh:
            read, isoform = line.rstrip("\n").split("\t")
            r2i.setdefault(isoform, []).append(read)
    return r2i


def count_matrix(filtered_isoforms: Sequence[str],
                 r2i: Dict[str, List[str]],
                 read_map: Dict[str, str],
                 sample_list: Sequence[str]) -> np.ndarray:
    """(num_isoforms, num_samples) read-count matrix via one segment sum."""
    sample_idx = {s: j for j, s in enumerate(sample_list)}
    iso_idx = {iso: i for i, iso in enumerate(filtered_isoforms)}
    flat: List[int] = []
    n_samples = len(sample_list)
    for iso in filtered_isoforms:
        i = iso_idx[iso]
        for read in r2i.get(iso, []):
            sample = read_map.get(read)
            if sample is None:  # its sample file went missing since D ran
                continue
            flat.append(i * n_samples + sample_idx[sample])
    n_segments = len(filtered_isoforms) * n_samples
    # A pipeline mesh can only be installed through parallel.mesh's
    # use_mesh, so when that module was never imported there is no mesh,
    # and importing it here would pull torch into a host-only module Q.
    import sys
    mesh_mod = sys.modules.get("mandalorion_tpu_torch.parallel.mesh")
    mesh = mesh_mod.pipeline_mesh() if mesh_mod is not None else None
    if mesh is not None and flat and n_segments:
        # per-shard bincount + all_reduce over the mesh (exact: integer
        # counts), parallel/dist.py
        from mandalorion_tpu_torch.parallel.dist import mesh_count_matrix
        counts = mesh_count_matrix(mesh, np.asarray(flat, np.int64),
                                   n_segments)
    else:
        counts = np.bincount(
            np.asarray(flat, np.int64), minlength=n_segments,
        ) if flat else np.zeros(n_segments, np.int64)
    return counts.reshape(len(filtered_isoforms), n_samples)


def write_quant(filtered_psl_path: str, r2i_path: str,
                fasta_list: Sequence[str], quant_path: str,
                tpm_path: str) -> None:
    """Emit Isoforms.filtered.clean.quant / .tpm in reference format."""
    sample_list, read_map, totals = map_read_locations(fasta_list)
    r2i = read_r2i(r2i_path)
    isoforms: List[str] = []
    with open(filtered_psl_path) as fh:
        for line in fh:
            if line.strip():
                isoforms.append(line.split("\t")[9])
    counts = count_matrix(isoforms, r2i, read_map, sample_list)
    denom = np.array([totals[s] for s in sample_list], np.float64)

    with open(quant_path, "w") as outq, open(tpm_path, "w") as outt:
        header = "Isoform\t" + "".join(s + "\t" for s in sample_list) + "\n"
        outq.write(header)
        outt.write(header)
        for i, iso in enumerate(isoforms):
            outq.write(iso + "\t")
            outt.write(iso + "\t")
            for j in range(len(sample_list)):
                outq.write(f"{int(counts[i, j])}\t")
                total = float(denom[j])
                tpm = (round(int(counts[i, j]) / total * 1_000_000, 3)
                       if total > 0 else 0.0)
                outt.write(f"{tpm}\t")
            outq.write("\n")
            outt.write("\n")


def convert_quant_to_tpm(quant_path: str, out_path: str) -> None:
    """Recompute TPM with denominator = quant column sums — the alternate
    TPM definition (`utils/convertQuantToTPM.py`, SURVEY §5.9)."""
    with open(quant_path) as fh:
        header = fh.readline()
        # strip() drops the quant rows' trailing tab, as the reference does
        rows = [line.strip().split("\t") for line in fh if line.strip()]
    if not rows:
        with open(out_path, "w") as out:
            out.write(header)
        return
    n_cols = max(len(r) - 1 for r in rows)
    mat = np.zeros((len(rows), n_cols), np.float64)
    for i, r in enumerate(rows):
        vals = [v for v in r[1:] if v != ""]
        mat[i, :len(vals)] = [int(v) for v in vals]
    scale = 1_000_000 / mat.sum(axis=0)
    with open(out_path, "w") as out:
        out.write(header)
        for i, r in enumerate(rows):
            vals = mat[i] * scale
            out.write(r[0] + "\t" + "\t".join(str(v) for v in vals) + "\n")
