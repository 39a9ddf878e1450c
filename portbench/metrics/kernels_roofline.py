"""kernels_roofline.<family>: the least time the card could take for the
traced steps' or calls' operations (`portbench/work`: per operation the
larger of its FLOPs over the bf16 peak and its bytes over the HBM
bandwidth) over the card's busy time in them (the union of the device
intervals)."""

from portbench.work.erfnet import bound_s


def read(run):
    if run.trace is None or run.peaks is None or run.trace.busy_s <= 0:
        return None
    least = bound_s(run.ops, run.peaks["flops"], run.peaks["bytes"])
    return 100.0 * least * run.traced_units / run.trace.busy_s
