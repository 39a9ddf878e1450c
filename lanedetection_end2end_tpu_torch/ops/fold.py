"""The fixed-order fold of per-block partial sums, in PyTorch.

The kernels whose blocks each hold a partial sum of the same outputs (the
weight and bias gradients and the moments of K6-K9 and K11 in both
dtypes, K12's moments) write one row of partials per block and add the
rows in one launch of `csrc/fold.cuh::fold_rows_kernel`, in this order:

    G = row_groups(rows, entries)            (a power of two)
    s[g] = sum over rows b = g, g + G, g + 2G, ... in turn of part[b, e]
    for h = G/2, G/4, ..., 1:  s[g] = s[g] + s[g + h]  for g < h
    out[e] = s[0]

so the sums reproduce themselves bit for bit. `fold_rows` writes that
order; the wrappers size their partials scratch from the `*_rows` counts,
the block partition of each kernel, which depends on the shape alone. The
CPU tests hold the partitions and this order against the plain sums.
"""

from __future__ import annotations

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def row_groups(rows: int, entries: int) -> int:
    """The fold's row groups over `rows` rows of `entries` entries
    (ldfold::row_groups): the least power of two that leaves a group at
    most four rows, at most 256; for a segment of 1024 entries or more, at
    most sixteen rows, at most 32 (a fold block then reads 8 entries and
    more of a row)."""
    wide = entries >= 1024
    per, most = (cdiv(rows, 16), 32) if wide else (cdiv(rows, 4), 256)
    g = 1
    while g < min(per, most):
        g *= 2
    return g


def fold_rows(part: torch.Tensor) -> torch.Tensor:
    """(rows, ...) partials -> (...): the fold kernel's order of
    additions (each entry of a row one entry of the segment), in `part`'s
    dtype."""
    rows = part.shape[0]
    G = row_groups(rows, part[0].numel())
    s = []
    for g in range(G):
        a = torch.zeros_like(part[0])
        for b in range(g, rows, G):
            a = a + part[b]
        s.append(a)
    h = G // 2
    while h:
        for g in range(h):
            s[g] = s[g] + s[g + h]
        h //= 2
    return s[0]


def ew_rows(n: int, threads: int = 256, cap: int = 132 * 8) -> int:
    """Blocks of a grid-stride elementwise kernel over n items
    (conv_s2.cuh::ew_blocks, the half blocks' dyv_kernel): ceil(n /
    threads), at most `cap`."""
    return min(cdiv(n, threads), cap)


def split_rows(nchunks: int, per_tap: int) -> tuple:
    """(blocks a tap, chunks a block) of a weight gradient that splits
    `nchunks` pixel chunks evenly over about `per_tap` blocks a tap."""
    cpb = cdiv(nchunks, max(per_tap, 1))
    return cdiv(nchunks, cpb), cpb
