"""D_ends_ms_per_kread: seconds of span define.ends (module D's end
calling, `define_start_end_sites`, timed in the forked prepare workers
and summed over loci: worker seconds, not wall time) under D_define, per
1,000 reads, in ms. Nothing to read from a program without this span."""

import bm_spans


def read(run):
    if not any(("D_define", "define.ends") in s
               for _j, s in bm_spans.traced_spans(run)):
        return None
    return bm_spans.ms_per_kread(run, "D_define", ["define.ends"])
