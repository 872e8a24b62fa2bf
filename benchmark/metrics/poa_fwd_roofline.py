"""poa_fwd_roofline: the least time of every POA forward launch by its
bytes (bm_roofline.poa_fwd_bytes over PEAK_BYTES_S) over the summed
device time of poa_fwd_kernel in the traces, in %."""

import bm_roofline
import bm_trace


def read(run):
    jobs = [j for j in run.traced_jobs() if j.fwd_bytes]
    device_s = sum(bm_trace.kernel_seconds(j.trace, "poa_fwd_kernel")
                   for j in jobs)
    if not jobs or device_s <= 0:
        return None
    least = sum(j.fwd_bytes for j in jobs) / bm_roofline.PEAK_BYTES_S
    return 100.0 * least / device_s
