"""A_seed_ms_per_kread: seconds of span align.seed (the C seed stage,
native_stage_seed_batch) under A_alignment, per 1,000 reads, in ms."""

import bm_spans


def read(run):
    return bm_spans.ms_per_kread(run, "A_alignment", ["align.seed"])
