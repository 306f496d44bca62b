"""Data layers — the port of ``paddle_tpu/fluid/layers/io.py``, cut to
``data``.  The reference's input pipeline (``data_loader``, ``py_reader``,
``double_buffer``) is not ported: feeds are numpy arrays or tensors handed
to ``Executor.run``."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True, main_program=None, startup_program=None,
         type=None):
    """Declare an input variable.  With ``append_batch_size`` (default)
    the leading batch dim is dynamic (-1).  With ``lod_level=1`` the
    value fed is a SeqArray (padded [batch, time, *shape] + lengths, see
    ``core/lod.py``); level-2 sequences are not ported."""
    if lod_level >= 2:
        raise NotImplementedError(
            f"data({name!r}): lod_level >= 2 (NestedSeqArray) is not "
            f"ported to paddle_tpu_torch")
    helper = LayerHelper("data", name=name, main_program=main_program,
                         startup_program=startup_program)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.block.create_var(name=name, shape=shape, dtype=dtype,
                                   lod_level=lod_level,
                                   stop_gradient=stop_gradient)
