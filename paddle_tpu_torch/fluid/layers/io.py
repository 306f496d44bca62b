"""Data layers — the port of ``paddle_tpu/fluid/layers/io.py``: ``data``,
and the input-pipeline surface that replaces the reference's reader op
stack (``py_reader`` / ``double_buffer`` / prefetch): a ``DataLoader``
(fluid/pipeline_io.py) whose background thread batches, converts and
copies feeds to the device ahead of the executor."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["data", "data_loader", "py_reader", "double_buffer"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True, main_program=None, startup_program=None,
         type=None):
    """Declare an input variable.  With ``append_batch_size`` (default)
    the leading batch dim is dynamic (-1).  With ``lod_level=1`` the
    value fed is a SeqArray (padded [batch, time, *shape] + lengths, see
    ``core/lod.py``), with ``lod_level=2`` a NestedSeqArray (padded
    [batch, outer, inner, *shape] + both levels' lengths)."""
    helper = LayerHelper("data", name=name, main_program=main_program,
                         startup_program=startup_program)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.block.create_var(name=name, shape=shape, dtype=dtype,
                                   lod_level=lod_level,
                                   stop_gradient=stop_gradient)


def data_loader(reader, feed_list=None, feeder=None, capacity: int = 2,
                device_prefetch: bool = True, place=None):
    """Build a device-prefetch ``DataLoader`` over ``reader`` (a
    zero-arg callable yielding batches).  ``feed_list`` (data Variables)
    converts raw row batches with a ``DataFeeder`` on the producer
    thread, ``feeder`` supplies your own converter; with neither the
    reader yields feed dicts.  ``place``: the prefetch's device (the
    card by default)."""
    from ..data_feeder import DataFeeder
    from ..pipeline_io import DataLoader

    if feed_list is not None:
        if feeder is not None:
            raise ValueError("pass feed_list or feeder, not both")
        feeder = DataFeeder(feed_list)
    return DataLoader(reader, feeder=feeder, capacity=capacity,
                      device_prefetch=device_prefetch, place=place)


def py_reader(capacity, feed_list=None, reader=None,
              use_double_buffer: bool = True, name=None, place=None):
    """The reference's ``py_reader`` (a python thread feeding a bounded
    queue) as the equivalent ``DataLoader``; ``use_double_buffer`` maps
    to device prefetch."""
    return data_loader(reader, feed_list=feed_list, capacity=capacity,
                       device_prefetch=use_double_buffer, place=place)


def double_buffer(reader, place=None, capacity: int = 2):
    """The reference's ``double_buffer`` reader op: keep the next
    ``capacity`` batches on the device while the current one computes.
    ``reader`` yields feed dicts, or is a DataLoader already (returned
    as it is)."""
    from ..pipeline_io import DataLoader

    if isinstance(reader, DataLoader):
        return reader
    return data_loader(reader, capacity=capacity, place=place)
