"""F_rules_ms_per_kread: seconds of spans filter.ratio and filter.contain
(module F's locus-coverage ratio rule, and its containment and polyA
rule, timed in the chromosome jobs) under F_filter, per 1,000 reads, in
ms. Nothing to read from a program without these spans."""

import bm_spans

SPANS = ["filter.ratio", "filter.contain"]


def read(run):
    if not any(("F_filter", n) in s for _j, s in bm_spans.traced_spans(run)
               for n in SPANS):
        return None
    return bm_spans.ms_per_kread(run, "F_filter", SPANS)
