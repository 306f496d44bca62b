"""Op corpus of the port: importing this package registers every op
emitter the slices run (tensor, math, activation, nn, loss, optimizer,
sequence and recurrent ops, ``lrn`` in ``misc_ops``, the serving steps'
KV-cache writes, page copies and attentions in ``cache_ops``, beam search
in ``beam_ops``, the control-flow ops and tensor arrays in
``control_flow_ops``, and the linear-chain CRF and chunk evaluation in
``crf_ops``).  ``quant_ops`` holds the int8 quantize-on-write
rule as plain tensor functions."""

from . import (  # noqa: F401
    activation_ops,
    beam_ops,
    cache_ops,
    control_flow_ops,
    crf_ops,
    loss_ops,
    math_ops,
    misc_ops,
    nn_ops,
    optimizer_ops,
    rnn_ops,
    sequence_ops,
    tensor_ops,
)
