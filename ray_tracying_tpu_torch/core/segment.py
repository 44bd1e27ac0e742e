"""A gather whose backward adds up without atomics.

Differentiable rendering gathers a small table (a geom's material and
transform record, G of them) into every ray lane, millions of lanes onto
at most a few thousand columns.  The backward of such a gather adds each
lane's cotangent into its column: as an atomic scatter-add that is millions
of atomics on a handful of addresses, and its sum changes with the order in
which they land.  `segment_sum` adds the same terms by sorting the lanes by
column, taking prefix sums in f64 and one difference a column: no atomics,
the same bits on every run.
"""

from __future__ import annotations

import torch


def segment_sum(values: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """out[:, k] = sum of values[:, i] over the i with index[i] == k, for
    (C, R) values and (R,) int64 index in [0, n).  The lanes are sorted by
    index, prefix sums taken in f64 and differenced at each segment's end;
    f64 keeps the difference of two large prefixes exact far below f32's
    last bit."""
    c = values.shape[0]
    sorted_idx, order = torch.sort(index)
    csum = torch.cumsum(values.index_select(1, order).double(), dim=1)
    csum = torch.cat([csum.new_zeros((c, 1)), csum], dim=1)
    ends = torch.searchsorted(sorted_idx, torch.arange(n, device=index.device), right=True)
    upto = csum.index_select(1, ends)
    return torch.diff(upto, dim=1, prepend=upto.new_zeros((c, 1))).to(values.dtype)


class _GatherColumns(torch.autograd.Function):
    """table.index_select(1, index), with `segment_sum` as its backward."""

    @staticmethod
    def forward(ctx, table, index):
        ctx.save_for_backward(index)
        ctx.n = table.shape[1]
        return table.index_select(1, index)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        return segment_sum(g, index, ctx.n), None


def gather_columns(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(C, R) columns `index` of a (C, G) table (index: (R,) int64 in
    [0, G)), differentiable in the table; the values of
    table.index_select(1, index)."""
    return _GatherColumns.apply(table, index)
