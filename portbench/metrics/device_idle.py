"""device_idle.<family>: the share of the untraced window in which the card
was idle: 1 - (the card's busy time a step or call, the union of the
device intervals over the traced steps or calls, from the trace) x (the
window's steps or calls) / (the window's seconds). The traced window's
own idle share (`busy_s` / `window_s`) also holds the profiler's cost on
the host, which swings from run to run."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.units:
        return None
    busy = run.trace.busy_s / run.traced_units
    return 100.0 * (1.0 - busy * run.units / run.seconds)
