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
:func:`merge_rows`, which sorts and sums each run of equal rows in a
fixed order (no atomics), so a sum is the same at every run; every row
scatter then has distinct rows, and a sentinel slot either adds -0.0 (an exact no-op
for every value) or writes a value another slot writes too.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = ["SelectedRows", "merge_rows", "segment_sum", "row_targets",
           "drop_sentinels"]


def segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int
                ) -> torch.Tensor:
    """[n, D...] sums of ``values`` [N, D...] by ``ids`` [N] in [0, n):
    the adjoint of a row gather, each row's values summed in index order
    from 0.0 (float32 for half-precision values), as the CPU's
    embedding backward adds them.  The ids are sorted stably, and
    ``segment_reduce`` sums each run of equal ids into the slot of the
    run's last sorted position (the other slots are empty: +0.0);
    ``index_add_`` then adds the N slots into zeros by id.  A row gets
    one sum and zeros, and a sum from 0.0 is never -0.0, so the order of
    the adds cannot change a bit: the same bits at every run, on the
    card and the CPU, capturable (fixed shapes, no host read), with
    work by the N looked-up rows, not the n table rows.  PyTorch's own
    adjoint, ``aten.embedding_dense_backward``, is not deterministic on
    the card where ids repeat many times (a position table's 64 copies
    of each row at batch 64 gave different bits run to run)."""
    keys, order = torch.sort(ids.reshape(-1).long(), stable=True)
    flat = values.reshape(values.shape[0], math.prod(values.shape[1:]))
    acc = flat if flat.dtype in (torch.float32, torch.float64) \
        else flat.float()
    # slot j sums [start of j's run, j + 1) if j ends its run, else
    # nothing: offsets[j] = the start of j's run, offsets[N] = N
    offsets = torch.cat([torch.searchsorted(keys, keys),
                         keys.new_full((1,), keys.shape[0])])
    sums = torch.segment_reduce(acc[order], "sum", offsets=offsets, axis=0,
                                unsafe=True)
    out = torch.zeros((n, sums.shape[1]), dtype=acc.dtype,
                      device=acc.device).index_add_(0, keys, sums)
    return out.to(flat.dtype).reshape((n,) + tuple(values.shape[1:]))


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
    zeros.  One stable sort of the rows gives the slots' order and each
    sorted slot's run; ``segment_reduce`` adds each run's values in
    index order from 0.0 (float32 for half-precision values), as the
    CPU's embedding backward adds them: one thread a column of a run,
    no atomics, so the same bits at every run, and capturable (fixed
    shapes, no host read)."""
    rows = sr.rows.long()
    n = rows.shape[0]
    r, order = torch.sort(rows, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=rows.device)
    first[1:] = r[1:] != r[:-1]
    seg = torch.cumsum(first.long(), 0) - 1           # sorted slot -> run
    # run k starts at offsets[k]; the runs past the last are empty
    offsets = torch.searchsorted(
        seg, torch.arange(n + 1, dtype=seg.dtype, device=seg.device))
    flat = sr.values.reshape(n, -1)
    acc = flat if flat.dtype in (torch.float32, torch.float64) \
        else flat.float()
    merged_v = torch.segment_reduce(acc[order], "sum", offsets=offsets,
                                    axis=0, unsafe=True)
    merged_v = merged_v.to(flat.dtype).reshape(sr.values.shape)
    # slot k takes run k's row (a spare slot n takes the writes of the
    # other sorted slots, and is dropped)
    merged_r = torch.full((n + 1,), sr.height, dtype=sr.rows.dtype,
                          device=rows.device)
    merged_r.index_copy_(0, torch.where(first, seg, torch.full_like(seg, n)),
                         r.to(sr.rows.dtype))
    return SelectedRows(merged_r[:n], merged_v, sr.height)
