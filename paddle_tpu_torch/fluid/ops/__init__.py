"""Op corpus of the port: importing this package registers every op
emitter the slices run (tensor, math, activation, nn, loss, optimizer,
sequence and recurrent ops, ``lrn`` in ``misc_ops``, the serving steps'
KV-cache writes, page copies and attentions in ``cache_ops``, beam search
in ``beam_ops``, the control-flow ops and tensor arrays in
``control_flow_ops``, the linear-chain CRF and chunk evaluation in
``crf_ops``, the CTC loss, edit distance and path collapse in
``ctc_ops``, and SSD's priors, matching, loss and NMS in
``detection_ops``, feed / fetch / save / load / print in ``io_ops``,
and the int8 quantize, dequantize and quantized products in
``quant_ops``, whose calibration rule the KV pool's quantize-on-write
shares)."""

from . import (  # noqa: F401
    activation_ops,
    beam_ops,
    cache_ops,
    control_flow_ops,
    crf_ops,
    ctc_ops,
    detection_ops,
    io_ops,
    loss_ops,
    math_ops,
    misc_ops,
    nn_ops,
    optimizer_ops,
    quant_ops,
    rnn_ops,
    sequence_ops,
    tensor_ops,
)
