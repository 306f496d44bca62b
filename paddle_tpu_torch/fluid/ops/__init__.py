"""Op corpus of the port: importing this package registers every op
emitter the slices run (tensor, math, activation, nn, loss, optimizer,
sequence and recurrent ops).  ``cache_ops`` and ``quant_ops`` hold the
serving path's paged KV writes and its int8 quantize-on-write rule as
plain tensor functions."""

from . import (  # noqa: F401
    activation_ops,
    loss_ops,
    math_ops,
    nn_ops,
    optimizer_ops,
    rnn_ops,
    sequence_ops,
    tensor_ops,
)
