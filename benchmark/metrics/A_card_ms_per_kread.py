"""A_card_ms_per_kread: seconds of spans align.chain and align.dp (the
chain and DP calls on the card: staging, launch, results back) under
A_alignment, per 1,000 reads, in ms."""

import bm_spans


def read(run):
    return bm_spans.ms_per_kread(run, "A_alignment",
                                 ["align.chain", "align.dp"])
