"""unstaged_ms_per_kread: each traced job's wall seconds (its end less its
start, host clock) less its stage seconds (tmp/timing.tsv) less the
profiler's own seconds (span profiler under run), summed over the
traced jobs whose spans are found, per 1,000 of their reads, in ms: the
time between stages (the command line, the run's set-up, the wait for
module P's checkpoint writer)."""

import bm_spans


def read(run):
    found = bm_spans.traced_spans(run)
    reads = sum(j.n_reads for j, _s in found)
    if not reads:
        return None
    return 1e6 * sum(j.end - j.start - sum(j.stages.values())
                     - s.get(("run", "profiler"), 0.0)
                     for j, s in found) / reads
