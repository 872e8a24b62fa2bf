"""device_peak_gb: torch.cuda.max_memory_allocated() of the window's
fullest job (reset before each), in GB."""


def read(run):
    peaks = [j.peak_bytes for j in run.jobs if j.peak_bytes is not None]
    return max(peaks) / 1e9 if peaks else None
