"""idle_share: the share of all traced stage windows in which no kernel,
memcpy or memset ran on the card, in %."""


def read(run):
    stages = [b for j in run.traced_jobs() for b in j.trace.values()]
    window = sum(b["window_s"] for b in stages)
    if not stages or window <= 0 or any(b["busy_s"] is None
                                        for b in stages):
        return None
    return 100.0 * (1.0 - sum(b["busy_s"] for b in stages) / window)
