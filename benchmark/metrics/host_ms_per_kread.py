"""host_ms_per_kread: seconds of the pipeline's host stages (the index
cache load, P, F and Q) from each window job's tmp/timing.tsv, per 1,000
reads, in ms."""


def read(run):
    if not run.reads:
        return None
    host = run.stage_s("index_build", "P_parsing", "F_filter", "Q_quant")
    return 1e6 * host / run.reads
