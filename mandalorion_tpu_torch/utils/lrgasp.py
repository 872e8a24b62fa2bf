"""LRGASP submission exporter.

Equivalent of `utils/convertOutput2LRGASPformat.py`: copies the filtered
GTF as models.gtf, filters reads2isoforms to surviving models
(read_model_map.tsv), and writes expression.tsv with the column-sum TPM
definition (the convertQuantToTPM variant, SURVEY §5.9)."""

from __future__ import annotations

import os
import shutil
from typing import Sequence

import numpy as np


def export_lrgasp(mando_folder: str, model_folder: str, expr_folder: str,
                  sample_ids: Sequence[str]) -> None:
    psl = os.path.join(mando_folder, "Isoforms.filtered.clean.psl")
    gtf = os.path.join(mando_folder, "Isoforms.filtered.clean.gtf")
    quant = os.path.join(mando_folder, "Isoforms.filtered.clean.quant")
    r2i = os.path.join(mando_folder, "tmp", "reads2isoforms.txt")

    os.makedirs(model_folder, exist_ok=True)
    os.makedirs(expr_folder, exist_ok=True)
    shutil.copy(gtf, os.path.join(model_folder, "models.gtf"))
    shutil.copy(gtf, os.path.join(expr_folder, "models.gtf"))

    models = set()
    with open(psl) as fh:
        for line in fh:
            if line.strip():
                models.add(line.split("\t")[9])

    with open(os.path.join(model_folder, "read_model_map.tsv"), "w") as out:
        out.write("read_id\ttranscript_id\n")
        with open(r2i) as fh:
            for line in fh:
                if line.split("\t")[1].strip() in models:
                    out.write(line)

    with open(quant) as fh:
        header = fh.readline()
        rows = [line.rstrip("\n").split("\t") for line in fh
                if line.strip()]
    n_cols = max((len(r) - 1 for r in rows), default=0)
    mat = np.zeros((len(rows), n_cols), np.float64)
    for i, r in enumerate(rows):
        vals = [v for v in r[1:] if v != ""]
        mat[i, :len(vals)] = [int(v) for v in vals]
    scale = np.divide(1_000_000, mat.sum(axis=0),
                      out=np.zeros(n_cols), where=mat.sum(axis=0) > 0)
    with open(os.path.join(expr_folder, "expression.tsv"), "w") as out:
        out.write("ID\t" + "".join(s + "\t" for s in sample_ids) + "\n")
        for i, r in enumerate(rows):
            vals = mat[i] * scale
            out.write(r[0] + "\t" + "\t".join(str(v) for v in vals) + "\n")
