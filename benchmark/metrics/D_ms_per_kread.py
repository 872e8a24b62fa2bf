"""D_ms_per_kread: seconds of module D from each window job's
tmp/timing.tsv, per 1,000 reads, in ms."""


def read(run):
    if not run.reads:
        return None
    return 1e6 * run.stage_s("D_define") / run.reads
