"""serve_p95_ms: the 95th percentile of the latency of every call in the
window, from the call to its lanes on the host (host clock)."""

import statistics


def read(run):
    if run.family != "serve" or len(run.latencies_s) < 2:
        return None
    return 1e3 * statistics.quantiles(run.latencies_s, n=100)[94]
