"""A_glue_ms_per_kread: seconds of spans align.read, align.records and
align.write (module A's Python glue: reading the reads in batches, the
PslRecord loop, the PSL writes) under A_alignment, per 1,000 reads, in
ms."""

import bm_spans


def read(run):
    return bm_spans.ms_per_kread(run, "A_alignment", ["align.read",
                                                      "align.records",
                                                      "align.write"])
