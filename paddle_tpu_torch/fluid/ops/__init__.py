"""Tensor functions of the port's serving path: the paged KV writes
(``cache_ops``) and the int8 quantize-on-write rule (``quant_ops``)."""
