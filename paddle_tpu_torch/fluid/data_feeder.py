"""DataFeeder — the port of ``paddle_tpu/fluid/data_feeder.py`` (analog of
python/paddle/v2/fluid/data_feeder.py): python minibatch rows into the
executor's feed dict (dense arrays, or SeqArrays for lod_level > 0
slots); ``decorate_reader`` wraps a batch reader in the prefetching
``pipeline_io.DataLoader``."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .core.lod import make_seq
from .framework import Variable

__all__ = ["DataFeeder"]


class DataFeeder:
    def __init__(self, feed_list: Sequence[Variable], place=None,
                 program=None, seq_bucket: int = 16):
        self.feed_vars = list(feed_list)
        self.place = place
        # max_len padded up to a multiple: bounds the step signatures a
        # run of batches captures
        self.seq_bucket = seq_bucket

    def feed(self, data: Sequence[Sequence]) -> Dict[str, object]:
        """``data`` is a list of rows, each row one value per feed var."""
        cols = list(zip(*data))
        out: Dict[str, object] = {}
        for var, col in zip(self.feed_vars, cols):
            dtype = np.int32 if var.dtype in ("int64", "int32") else np.float32
            if var.lod_level > 0:
                seqs = [np.asarray(c, dtype=dtype) for c in col]
                shape = [d for d in var.shape[1:] if d != -1]
                seqs = [s.reshape(-1, *shape) if shape else s for s in seqs]
                out[var.name] = make_seq(seqs, dtype=dtype,
                                         bucket=self.seq_bucket)
            else:
                arr = np.asarray(col, dtype=dtype)
                shape = [d for d in (var.shape or []) if d != -1]
                if shape and list(arr.shape[1:]) != shape:
                    arr = arr.reshape(arr.shape[0], *shape)
                out[var.name] = arr
        return out

    def decorate_reader(self, reader, capacity: int = 2,
                        device_prefetch: bool = True):
        """Reference ``DataFeeder.decorate_reader``: wrap a batch reader
        so this feeder's row -> feed-dict conversion and the copy to
        the device (this feeder's place; the card by default) happen on
        a background thread, ``capacity`` batches ahead of the consuming
        step.  Returns a ``DataLoader``: iterate it and pass each dict
        to ``Executor.run`` / ``run_pipeline``."""
        from .pipeline_io import DataLoader

        return DataLoader(reader, feeder=self, capacity=capacity,
                          device_prefetch=device_prefetch, place=self.place)
