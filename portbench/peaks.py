"""The card's published peaks that the utilization metrics divide by.

One table for every cell: NVIDIA's H100 SXM data sheet, dense rates, at the
full 700 W power limit (a card set lower reads lower; the run prints its
limit). The bf16 tensor-core rate stands for every precision, so that no
implementation reads above 100% of it.
"""

from __future__ import annotations

from typing import Optional

PEAKS = {"H100": {"flops": 989e12, "bytes": 3.35e12}}


def for_card(kind: str) -> Optional[dict]:
    """{"flops": FLOP/s, "bytes": bytes/s} of the card named `kind`
    (`torch.cuda.get_device_name()`), None for a card not in the table."""
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    return None
