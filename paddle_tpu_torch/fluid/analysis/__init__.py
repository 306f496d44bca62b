"""paddle_tpu_torch.fluid.analysis — the port of
``paddle_tpu.fluid.analysis``, cut to what the serving generator's
``bucket_set`` needs: ``dataflow.ProgramView`` (a cycle-safe view of a
ProgramDesc with each op's reads and writes) and
``recompile.enumerate_buckets`` (the closed set of feed signatures a
program compiles to).  The passes, ``analyze_program``, the cost model,
the sharding propagation and ``recompile_pass`` are not ported."""

from __future__ import annotations

from .dataflow import ProgramView
from .recompile import enumerate_buckets, feed_vars

__all__ = ["ProgramView", "enumerate_buckets", "feed_vars"]
