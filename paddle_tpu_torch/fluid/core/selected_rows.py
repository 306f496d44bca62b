"""SelectedRows: the sparse row-slice gradient — the port of
``paddle_tpu/fluid/core/selected_rows.py``.

A (rows, values, height) triple (reference selected_rows.h:19): the
gradient of an ``embedding(is_sparse=True)`` table is the [N, D] slab of
its looked-up rows' output gradients, never a dense [V, D] tensor.  Rows
may repeat; :func:`merge_rows` sums the duplicates into N slots, and a
vacated slot holds the sentinel row ``height`` with zero values, which
every consumer ignores.  A plain class of two tensors and an int.

Everything here has a static shape and makes no host sync, so a step
that holds it can be captured in a CUDA graph: no ``unique``, no
``nonzero``, no boolean indexing.  Repeated rows are summed by
:func:`segment_sum`, which sorts and sums each segment in a fixed order
(no atomics), so a sum is the same at every run; every row scatter then
has distinct rows, and a sentinel slot either adds -0.0 (an exact no-op
for every value) or writes a value another slot writes too.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["SelectedRows", "merge_rows", "segment_sum", "row_targets",
           "drop_sentinels"]


def segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int
                ) -> torch.Tensor:
    """[n, D...] sums of ``values`` [N, D...] by ``ids`` [N] in [0, n):
    the adjoint of a row gather, ``aten.embedding_dense_backward``,
    which sorts the ids and sums each run in a fixed order on the card
    (no atomics: the same bits at every run) and in index order on the
    CPU."""
    feat = tuple(values.shape[1:])
    out = torch.ops.aten.embedding_dense_backward(
        values.reshape(values.shape[0], -1), ids.long(), n, -1, False)
    return out.reshape((n,) + feat)


class SelectedRows:
    """rows: int [N] row indices (duplicates allowed; entries equal to
    ``height`` are vacated slots and are ignored); values: [N, D] row
    data; height: the table's row count V."""

    __slots__ = ("rows", "values", "height")

    def __init__(self, rows, values, height: int):
        self.rows = rows
        self.values = values
        self.height = int(height)

    @property
    def dense_shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    def to_dense(self) -> torch.Tensor:
        """The [height, D] tensor with each row's values summed (sentinel
        rows dropped: they sum into a spare row, sliced off)."""
        return segment_sum(self.values, self.rows.long().clamp(
            max=self.height), self.height + 1)[: self.height]

    def scatter_add_to(self, dense: torch.Tensor, scale=None
                       ) -> torch.Tensor:
        """``dense[rows] += scale * values``, in place (exact under
        duplicates: they are summed first)."""
        m = merge_rows(self)
        v = m.values.to(dense.dtype)
        if scale is not None:
            v = v * scale
        sentinel, target = row_targets(m.rows, self.height)
        return dense.index_add_(0, target, drop_sentinels(sentinel, v))

    def __repr__(self):
        return (f"SelectedRows(rows={tuple(getattr(self.rows, 'shape', ()))}, "
                f"values={tuple(getattr(self.values, 'shape', ()))}, "
                f"height={self.height})")


def drop_sentinels(sentinel: torch.Tensor, v: torch.Tensor
                   ) -> torch.Tensor:
    """``v`` with the sentinel slots' rows -0.0: adding -0.0 leaves every
    value as it was, -0.0 and +0.0 included."""
    return torch.where(sentinel.reshape((-1,) + (1,) * (v.dim() - 1)),
                       torch.full((), -0.0, dtype=v.dtype, device=v.device),
                       v)


def row_targets(rows: torch.Tensor, height: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sentinel mask, int64 rows to write) for merged ``rows``: a
    sentinel slot writes to the first slot's row, which is a real row
    unless every slot is vacant (then row ``height - 1``).  Merged rows
    are sorted, so real rows come first."""
    rows = rows.long()
    sentinel = rows >= height
    target = torch.where(sentinel, rows[:1], rows).clamp(max=height - 1)
    return sentinel, target


def merge_rows(sr: SelectedRows) -> SelectedRows:
    """Sum duplicate rows, keeping N slots (reference merge_rows, the
    static-shape analog of selected_rows_functor.cc MergeAdd).  Slot k
    holds the k-th smallest distinct row and its summed values; the
    slots after the last distinct row hold the sentinel ``height`` and
    zeros.  The rows are sorted (stable) for the slots' order, each
    sorted slot gets its segment's id, and ``segment_sum`` adds the
    values by those ids."""
    rows = sr.rows.long()
    n = rows.shape[0]
    order = torch.sort(rows, stable=True).indices
    r = rows[order]
    new = torch.ones(n, dtype=torch.bool, device=rows.device)
    new[1:] = r[1:] != r[:-1]
    seg = torch.cumsum(new.long(), 0) - 1                 # [N] segment ids
    # each value's segment, in the values' own order
    ids = torch.empty_like(seg).index_copy_(0, order, seg)
    merged_v = segment_sum(sr.values, ids, n)
    # slot seg takes its segment's row (a spare slot n takes the writes
    # of the other sorted slots, and is dropped)
    merged_r = torch.full((n + 1,), sr.height, dtype=sr.rows.dtype,
                          device=rows.device)
    merged_r.index_copy_(0, torch.where(new, seg, torch.full_like(seg, n)),
                         r.to(sr.rows.dtype))
    return SelectedRows(merged_r[:n], merged_v, sr.height)
