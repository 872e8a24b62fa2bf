"""D_resolve_ms_per_kread: seconds of span define.resolve (the consensus
of every isoform: the native engine or the POA round loop) under
D_define, per 1,000 reads, in ms."""

import bm_spans


def read(run):
    return bm_spans.ms_per_kread(run, "D_define", ["define.resolve"])
