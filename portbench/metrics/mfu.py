"""mfu.<family>: the model's FLOPs completed in the window (`portbench/work`,
at the cell's batch: forward, and for training each layer's input and
weight gradient) over the window's seconds, as a share of the card's
published dense bf16 peak (`portbench/peaks.py`)."""


def read(run):
    if run.peaks is None:
        return None
    flops = sum(op.flops for op in run.ops) * run.units
    return 100.0 * flops / run.seconds / run.peaks["flops"]
