"""A_emit_ms_per_kread: seconds of span align.emit (the C emit stage)
under A_alignment, per 1,000 reads, in ms."""

import bm_spans


def read(run):
    return bm_spans.ms_per_kread(run, "A_alignment", ["align.emit"])
