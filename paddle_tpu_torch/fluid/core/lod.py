"""Sequence tensors — the port of ``paddle_tpu/fluid/core/lod.py``.

A batch of variable-length sequences is a dense padded block plus the
length of each row, as in the reference:

    SeqArray.data     [batch, max_len, *feature_dims]   (padded)
    SeqArray.lengths  [batch] int32                     (valid prefix lengths)

Sequence ops mask instead of walking level-of-detail offsets.  Here the
fields are torch tensors on the executor's device (``make_seq`` builds
one on the host, with numpy fields, for a feed), and the class is a plain
container: the executor and the lowering unwrap and re-wrap it where the
reference relies on JAX's pytree flattening.  Level-2 sequences
(``NestedSeqArray``, packed on the host by ``make_nested_seq``) are a
batch of sequences of sequences, padded on both levels.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SeqArray", "NestedSeqArray", "make_seq", "seq_mask",
           "make_nested_seq"]


class SeqArray:
    """A batch of variable-length sequences: padded data + lengths."""

    __slots__ = ("data", "lengths")

    def __init__(self, data, lengths):
        self.data = data
        self.lengths = lengths

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def batch_size(self):
        return self.data.shape[0]

    @property
    def max_len(self):
        return self.data.shape[1]

    def mask(self, dtype=None):
        """[batch, max_len] validity mask (True inside each sequence)."""
        m = seq_mask(self.lengths, self.max_len)
        return m if dtype is None else m.to(dtype)

    def with_data(self, data):
        return SeqArray(data, self.lengths)

    def detach(self) -> "SeqArray":
        return SeqArray(self.data.detach(), self.lengths)

    def __repr__(self):
        return (f"SeqArray(data={tuple(self.data.shape)}, "
                f"lengths={tuple(self.lengths.shape)})")


class NestedSeqArray:
    """Level-2 sequences: a batch of sequences of sequences (the
    reference's nested LoD: paragraphs of sentences of words, beam
    decode's per-source candidate lists).

        data           [batch, max_outer, max_inner, *feat]
        outer_lengths  [batch]             sub-sequences per row
        inner_lengths  [batch, max_outer]  items per sub-sequence

    ``np.asarray(nested)`` is the padded data block; LoD-aware ops read
    the lengths."""

    __slots__ = ("data", "outer_lengths", "inner_lengths")

    def __init__(self, data, outer_lengths, inner_lengths):
        self.data = data
        self.outer_lengths = outer_lengths
        self.inner_lengths = inner_lengths

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def lod_level(self):
        return 2

    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(self.data)
        return arr.astype(dtype) if dtype is not None else arr

    def outer_mask(self) -> torch.Tensor:
        """[batch, max_outer] bool: which sub-sequences exist."""
        return seq_mask(self.outer_lengths, self.data.shape[1])

    def inner_mask(self) -> torch.Tensor:
        """[batch, max_outer, max_inner] bool: which items exist."""
        pos = torch.arange(self.data.shape[2], dtype=torch.int32,
                           device=self.inner_lengths.device)
        m = pos < self.inner_lengths.to(torch.int32)[..., None]
        return m & self.outer_mask()[..., None]

    def flatten_outer(self) -> SeqArray:
        """Level 1: [batch * max_outer, max_inner, *feat] with each
        sub-sequence's length (0 for a vacant outer slot)."""
        b, n = self.data.shape[:2]
        lens = torch.where(self.outer_mask(),
                           self.inner_lengths.to(torch.int32), 0)
        return SeqArray(self.data.reshape((b * n,) + self.data.shape[2:]),
                        lens.reshape(b * n))

    def with_data(self, data) -> "NestedSeqArray":
        return NestedSeqArray(data, self.outer_lengths, self.inner_lengths)

    def detach(self) -> "NestedSeqArray":
        return self.with_data(self.data.detach())

    def __repr__(self):
        return (f"NestedSeqArray(data={tuple(self.data.shape)}, "
                f"outer={tuple(self.outer_lengths.shape)}, "
                f"inner={tuple(self.inner_lengths.shape)})")


def seq_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[batch, max_len] bool mask from lengths (on the lengths' device)."""
    pos = torch.arange(max_len, dtype=torch.int32, device=lengths.device)
    return pos[None, :] < lengths.to(torch.int32)[:, None]


def make_seq(seqs, dtype=None, max_len=None, bucket=None) -> SeqArray:
    """Host-side packing: list of per-sequence arrays -> SeqArray of numpy
    arrays, right-padded with zeros.  ``bucket`` rounds max_len up to a
    multiple of it."""
    seqs = [np.asarray(s, dtype=dtype) for s in seqs]
    lengths = np.asarray([len(s) for s in seqs], dtype=np.int32)
    ml = int(max_len if max_len is not None
             else (lengths.max() if len(seqs) else 0))
    if bucket:
        ml = int(np.ceil(max(ml, 1) / bucket) * bucket)
    feat = seqs[0].shape[1:] if seqs else ()
    data = np.zeros((len(seqs), ml) + feat,
                    dtype=seqs[0].dtype if seqs else dtype)
    for i, s in enumerate(seqs):
        data[i, : len(s)] = s
    return SeqArray(data, lengths)


def make_nested_seq(nested, dtype=None, outer_bucket=None,
                    inner_bucket=None) -> NestedSeqArray:
    """Host-side packing: a list (batch) of lists (outer) of sequences ->
    NestedSeqArray of numpy arrays, zero-padded on both levels.
    ``outer_bucket`` / ``inner_bucket`` round the padded extents up to a
    multiple of them."""
    batch = len(nested)
    outer_lengths = np.asarray([len(row) for row in nested], np.int32)
    n_max = int(outer_lengths.max()) if batch else 0
    if outer_bucket:
        n_max = int(np.ceil(max(n_max, 1) / outer_bucket) * outer_bucket)
    seqs = [[np.asarray(s, dtype=dtype) for s in row] for row in nested]
    m_max = max((len(s) for row in seqs for s in row), default=0)
    if inner_bucket:
        m_max = int(np.ceil(max(m_max, 1) / inner_bucket) * inner_bucket)
    # the feature shape of the first row's first sub-sequence, or of a
    # later row's while that is () (an empty first sub-sequence); the
    # dtype of the first sub-sequence: the reference's choice
    feat = ()
    for row in seqs:
        if row:
            feat = row[0].shape[1:]
        if feat:
            break
    first = next((s for row in seqs for s in row), None)
    data = np.zeros((batch, n_max, m_max) + feat,
                    dtype=(first.dtype if first is not None else None)
                    or dtype)
    inner_lengths = np.zeros((batch, n_max), np.int32)
    for i, row in enumerate(seqs):
        for j, s in enumerate(row):
            data[i, j, : len(s)] = s
            inner_lengths[i, j] = len(s)
    return NestedSeqArray(data, outer_lengths, inner_lengths)
