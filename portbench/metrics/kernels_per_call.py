"""kernels_per_call.<family>: device kernels in the traced calls over their
count, from the trace (the host's launch path, read from no counter of
the program)."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return run.trace.kernels / run.traced_units
