"""The program's spans of each job, for the per-layer readers.

The program (`mandalorion_tpu_torch.pipeline.observe`) writes a run's
spans into its tmp/spans.tsv, one row a (stage, parent, span): calls,
seconds, items; and it keeps each of its last runs' timers in memory, in
`observe.RUNS`. The harness deletes a job's files before the readers run,
so a reader takes a job's spans from memory: those of the run that
started and ended inside the job's window (host clock). A program
without spans (no `RUNS`), or a job with no such run, gives None.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

OBSERVE = "mandalorion_tpu_torch.pipeline.observe"


def job_spans(job) -> Optional[Dict[Tuple[str, str], float]]:
    """{(stage, span): seconds} of the program's run inside the job's
    window, summed over the spans' parents; None where there is none."""
    observe = sys.modules.get(OBSERVE)
    runs = getattr(observe, "RUNS", None)
    if runs is None:
        return None
    for timer in runs:
        if timer.ended is not None and \
                job.start <= timer.started <= timer.ended <= job.end:
            out: Dict[Tuple[str, str], float] = {}
            for (stage, _parent, name), row in timer.spans.items():
                out[(stage, name)] = out.get((stage, name), 0.0) + row[1]
            return out
    return None


def traced_spans(run) -> List[tuple]:
    """[(job, spans)] of the traced jobs whose spans are found."""
    found = [(j, job_spans(j)) for j in run.traced_jobs()]
    return [(j, s) for j, s in found if s is not None]


def ms_per_kread(run, stage: str, names: Sequence[str]) -> Optional[float]:
    """The seconds of the named spans under `stage`, summed over the
    traced jobs whose spans are found, per 1,000 of their reads, in ms."""
    found = traced_spans(run)
    reads = sum(j.n_reads for j, _s in found)
    if not reads:
        return None
    return 1e6 * sum(s.get((stage, n), 0.0) for _j, s in found
                     for n in names) / reads
