"""Program-rewrite transforms over the ProgramDesc IR — the port of
``paddle_tpu/fluid/transforms``.  The one resident is the post-training
int8 weight quantization (quantize.py), which the serving engine's
``quantize="int8"`` runs."""

from .quantize import QuantStats, quantize_program  # noqa: F401

__all__ = ["quantize_program", "QuantStats"]
