"""The port's counterpart of ``paddle_tpu.fluid``: programs of blocks of
ops built by ``layers.*``, differentiated by ``append_backward`` /
``optimizer.Adam(...).minimize``, and run one step at a time by an
``Executor`` (one captured CUDA graph per step signature on the card,
the ops run eagerly through ``lowering.py`` on the CPU).  Importing it
registers the op emitters.

Cut to what the Transformer training program (float32 or the bf16
``amp_dtype`` recipe), the paged serving step, the LSTM text
classifiers, the book's chapters through image classification, the
embedding chapters (CTR wide&deep, word2vec, the recommender: sparse
embeddings), the optimizer front end (every optimizer, ModelAverage
too, ``regularizer``, ``clip``, ``learning_rate_decay``), control flow
and the seq2seq models, and semantic role labeling (the linear-chain
CRF, ``evaluator``) need; level-1 sequence inputs are ``SeqArray``
feeds (``make_seq``, ``DataFeeder``, the prefetching ``DataLoader``).
``io`` saves and loads tensors, checkpoints and inference models in the
reference's file format, ``checkpoint`` keeps periodic training
checkpoints, ``transforms`` rewrites an inference program to int8
weights, and ``profiler`` times steps.  Not ported (they raise
``NotImplementedError`` where the API reaches them): level-2 sequence
inputs (``NestedSeqArray`` is only ``beam_search_decode``'s output),
meshes and sequence parallelism, the compile cache, ``cost_analysis``
and ``export_stablehlo``."""

from . import ops as _ops  # registers the op emitters  # noqa: F401
from . import (checkpoint, clip, evaluator, initializer, io,  # noqa: F401
               layers, learning_rate_decay, nets, optimizer, profiler,
               regularizer, transforms, unique_name)
from .backward import append_backward
from .core.lod import SeqArray, make_seq
from .core.registry import registered_ops
from .data_feeder import DataFeeder
from .executor import (CPUPlace, CUDAPlace, Executor, Scope, global_scope,
                       scope_from_numpy, scope_guard, scope_to_numpy)
from .pipeline_io import DataLoader
from .framework import (Block, Operator, Parameter, Program, Variable,
                        default_main_program, default_startup_program,
                        program_guard, switch_main_program,
                        switch_startup_program)
from .param_attr import ParamAttr

__all__ = [
    "layers", "nets", "optimizer", "initializer", "unique_name", "io",
    "regularizer", "clip", "learning_rate_decay", "evaluator", "DataFeeder",
    "DataLoader", "checkpoint", "profiler", "transforms",
    "append_backward", "registered_ops", "SeqArray", "make_seq",
    "Executor", "Scope", "global_scope", "scope_guard", "CUDAPlace",
    "CPUPlace", "scope_from_numpy", "scope_to_numpy",
    "Program", "Block", "Operator", "Variable", "Parameter", "ParamAttr",
    "default_main_program", "default_startup_program", "program_guard",
    "switch_main_program", "switch_startup_program",
]
