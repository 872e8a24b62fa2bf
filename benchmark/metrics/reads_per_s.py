"""reads_per_s: all reads of all jobs in the window over the window's
seconds, which are the jobs' own from each one's start to its end (host
clock)."""


def read(run):
    span = run.window_s
    return run.reads / span if run.jobs and span > 0 else None
