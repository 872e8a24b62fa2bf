"""D_staging_share: host seconds of module D's round loop in its C
staging calls (the program's RunObserver's fill_s + apply_s) over the
D_define seconds, in %. Nothing to read where the loop ran no round (the
native engine)."""


def read(run):
    jobs = [j for j in run.traced_jobs() if j.rounds]
    d = sum(j.stages.get("D_define", 0.0) for j in jobs)
    if not jobs or d <= 0:
        return None
    return 100.0 * sum(j.fill_s + j.apply_s for j in jobs) / d
