"""D_prepare_ms_per_kread: seconds of span define.prepare (the annotation
parse, the loci and the forked prepare pool with its wait) under
D_define, per 1,000 reads, in ms."""

import bm_spans


def read(run):
    return bm_spans.ms_per_kread(run, "D_define", ["define.prepare"])
