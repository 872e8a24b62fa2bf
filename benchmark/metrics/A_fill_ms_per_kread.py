"""A_fill_ms_per_kread: seconds of span align.fill (the C fill stage)
under A_alignment, per 1,000 reads, in ms."""

import bm_spans


def read(run):
    return bm_spans.ms_per_kread(run, "A_alignment", ["align.fill"])
