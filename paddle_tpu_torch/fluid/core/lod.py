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
(``NestedSeqArray``) are ported as the output type of
``beam_search_decode`` only: the executor fetches one, and a ``data``
var or an op input of level 2 is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SeqArray", "NestedSeqArray", "make_seq", "seq_mask"]


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
    reference's nested LoD; beam decode's per-source candidate lists).

        data           [batch, max_outer, max_inner, *feat]
        outer_lengths  [batch]             sub-sequences per row
        inner_lengths  [batch, max_outer]  items per sub-sequence

    ``np.asarray(nested)`` is the padded data block."""

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
