"""The port's counterpart of ``paddle_tpu.fluid``: programs of blocks of
ops built by ``layers.*``, differentiated by ``append_backward`` /
``optimizer.Adam(...).minimize``, and run one step at a time by an
``Executor`` (one captured CUDA graph per step signature on the card,
the ops run eagerly through ``lowering.py`` on the CPU).  Importing it
registers the op emitters.

Cut to what the Transformer training program (float32 or the bf16
``amp_dtype`` recipe), the paged serving step, the LSTM text classifiers
and the book's first two chapters need; level-1 sequence inputs are
``SeqArray`` feeds (``make_seq``), and ``io`` holds ``prune_program``.
Not ported (they raise ``NotImplementedError`` where the API reaches
them): level-2 sequence inputs (``NestedSeqArray`` is only
``beam_search_decode``'s output), sparse embeddings, meshes and sequence
parallelism, batch norm, gradient clipping and regularizers, optimizers
other than SGD, Momentum and Adam, control-flow ops, the compile cache
and ``cost_analysis``."""

from . import ops as _ops  # registers the op emitters  # noqa: F401
from . import initializer, io, layers, nets, optimizer, unique_name  # noqa: F401
from .backward import append_backward
from .core.lod import SeqArray, make_seq
from .core.registry import registered_ops
from .executor import (CPUPlace, CUDAPlace, Executor, Scope, global_scope,
                       scope_from_numpy, scope_guard, scope_to_numpy)
from .framework import (Block, Operator, Parameter, Program, Variable,
                        default_main_program, default_startup_program,
                        program_guard, switch_main_program,
                        switch_startup_program)
from .param_attr import ParamAttr

__all__ = [
    "layers", "nets", "optimizer", "initializer", "unique_name", "io",
    "append_backward", "registered_ops", "SeqArray", "make_seq",
    "Executor", "Scope", "global_scope", "scope_guard", "CUDAPlace",
    "CPUPlace", "scope_from_numpy", "scope_to_numpy",
    "Program", "Block", "Operator", "Variable", "Parameter", "ParamAttr",
    "default_main_program", "default_startup_program", "program_guard",
    "switch_main_program", "switch_startup_program",
]
