"""User-facing graph-building API: Variable / Operator / Block / Program —
the port of ``paddle_tpu/fluid/framework.py``.

Shape and dtype inference runs each op's emitter once at build time on
``meta`` tensors (the reference abstractly evaluates its JAX emitter with
``jax.eval_shape``): one inference rule per op, always consistent with
the lowering.  Dynamic dims (-1) stand in as a dummy extent, and the
recorded dtypes follow the reference's runtime, where int64 and float64
narrow to int32 and float32, so a program serializes to the same bytes
in both packages.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

from . import unique_name
from .core import registry as _registry
from .core.desc import BlockDesc, OpDesc, ProgramDesc, VarDesc
from .core.lod import NestedSeqArray, SeqArray
from .core.registry import EmitCtx, get_op_info
from .core.types import VarType, canonical_dtype, runtime_dtype, torch_dtype

__all__ = [
    "Variable", "Parameter", "Operator", "Block", "Program",
    "default_main_program", "default_startup_program", "program_guard",
    "switch_main_program", "switch_startup_program", "grad_var_name",
]

grad_var_name = _registry.grad_var_name

# dummy extents standing in for a dynamic (-1) dim and for a sequence's
# padded time axis during inference
_DUMMY_BATCH = 13
_DUMMY_TIME = 11

# ops whose build-time inference is skipped (IO and markers)
_NO_INFER_OPS = {"feed", "fetch", "while", "conditional_block", "print",
                 "save", "load", "save_combine", "load_combine"}

# ops that consume randomness.  Each instance gets a __rng_salt__ attr at
# build time, unique within its program; the *_grad op copies the attr.
# The salt counter lives on the Program, so identical builds serialize
# byte-identically.
_RANDOM_OPS = {"dropout", "uniform_random", "gaussian_random",
               "truncated_gaussian_random", "nce", "sampling_id",
               "fused_attention"}

# ops whose ``is_test`` attr ``Program.clone(for_test=True)`` sets
_TEST_SENSITIVE_OPS = {
    "dropout": ("is_test",),
    "batch_norm": ("is_test",),
    "fused_attention": ("is_test",),
}


class Variable:
    """A named, typed slot in a Block, backed by a VarDesc."""

    def __init__(self, block: "Block", name: str,
                 type: str = VarType.DENSE_TENSOR, dtype="float32",
                 shape: Optional[Sequence[int]] = None, lod_level: int = 0,
                 persistable: bool = False, stop_gradient: bool = False):
        self.block = block
        desc = block.desc.vars.get(name)
        if desc is None:
            desc = VarDesc(name=name, type=type, dtype=canonical_dtype(dtype),
                           shape=list(shape) if shape is not None else None,
                           lod_level=lod_level, persistable=persistable,
                           stop_gradient=stop_gradient)
            block.desc.add_var(desc)
        self.desc = desc
        self.op: Optional[Operator] = None  # producer, set by append_op

    @property
    def name(self) -> str:
        return self.desc.name

    @property
    def shape(self):
        return tuple(self.desc.shape) if self.desc.shape is not None else None

    @property
    def dtype(self) -> str:
        return self.desc.dtype

    @property
    def lod_level(self) -> int:
        return self.desc.lod_level

    @property
    def type(self) -> str:
        return self.desc.type

    @property
    def persistable(self) -> bool:
        return self.desc.persistable

    @persistable.setter
    def persistable(self, v: bool):
        self.desc.persistable = bool(v)

    @property
    def stop_gradient(self) -> bool:
        return self.desc.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, v: bool):
        self.desc.stop_gradient = bool(v)

    @property
    def grad_name(self) -> str:
        return grad_var_name(self.name)

    def abstract_value(self):
        """The ``meta`` tensor (a SeqArray of them for a sequence var)
        standing in for this var during inference."""
        return abstract_from_meta(self.shape, self.dtype, self.lod_level,
                                  name=self.name)

    def __repr__(self):
        return (f"Variable(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype}, lod_level={self.lod_level})")


class Parameter(Variable):
    """Trainable persistable variable."""

    def __init__(self, block, name, shape, dtype="float32", trainable=True,
                 optimize_attr=None, regularizer=None, gradient_clip_attr=None,
                 sharding: Optional[Sequence[Optional[str]]] = None, **kw):
        super().__init__(block, name, dtype=dtype, shape=shape,
                         persistable=True, stop_gradient=not trainable, **kw)
        self.trainable = trainable
        self.optimize_attr = optimize_attr or {"learning_rate": 1.0}
        self.regularizer = regularizer
        self.gradient_clip_attr = gradient_clip_attr
        self.sharding = tuple(sharding) if sharding is not None else None
        if sharding is not None:
            self.desc.sharding = list(sharding)

    def __repr__(self):
        return f"Parameter(name={self.name}, shape={self.shape}, dtype={self.dtype})"


class Operator:
    """One op of a Block, backed by an OpDesc."""

    def __init__(self, block: "Block", desc: OpDesc):
        self.block = block
        self.desc = desc

    @property
    def type(self) -> str:
        return self.desc.type

    def input(self, slot):
        return self.desc.input(slot)

    def output(self, slot):
        return self.desc.output(slot)

    @property
    def input_names(self):
        return self.desc.input_names()

    @property
    def output_names(self):
        return self.desc.output_names()

    def attr(self, name, default=None):
        return self.desc.attr(name, default)

    @property
    def attrs(self):
        return self.desc.attrs

    def __repr__(self):
        return f"Operator({self.desc!r})"


class Block:
    """A block of ops over vars, backed by a BlockDesc."""

    def __init__(self, program: "Program", desc: BlockDesc):
        self.program = program
        self.desc = desc
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def idx(self) -> int:
        return self.desc.idx

    @property
    def parent_idx(self) -> int:
        return self.desc.parent_idx

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def create_var(self, name=None, **kw) -> Variable:
        name = name or unique_name.generate("tmp")
        v = Variable(self, name, **kw)
        self.vars[name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, name=None, shape=None, dtype="float32",
                         **kw) -> Parameter:
        name = name or unique_name.generate("param")
        p = Parameter(self, name, shape=shape, dtype=dtype, **kw)
        self.vars[name] = p
        self.program._bump_version()
        return p

    def var(self, name: str) -> Variable:
        """Lookup in this block, then its ancestors."""
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        raise KeyError(f"variable {name!r} not found in block {self.idx}")

    def has_var(self, name: str) -> bool:
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None,
                  infer_shape: bool = True) -> Operator:
        attrs = dict(attrs or {})
        consumes_rng = type in _RANDOM_OPS
        if type == "fused_attention" and not attrs.get("dropout_rate"):
            consumes_rng = False  # deterministic unless dropout is on
        if consumes_rng and "__rng_salt__" not in attrs:
            attrs["__rng_salt__"] = self.program._next_rng_salt()
        desc = OpDesc(type=type,
                      inputs=_names_dict(inputs),
                      outputs=_names_dict(outputs),
                      attrs=attrs)
        self.desc.append_op(desc)
        op = Operator(self, desc)
        self.ops.append(op)
        out_vars = _vars_dict(outputs)
        for vs in out_vars.values():
            for v in vs:
                v.op = op
        if infer_shape and type not in _NO_INFER_OPS:
            self._infer_op(desc, _vars_dict(inputs), out_vars)
        self.program._bump_version()
        return op

    def _infer_op(self, desc: OpDesc, in_vars, out_vars) -> None:
        """Run the emitter on meta tensors to fill the output VarDescs.
        Inference is advisory, as in the reference: an op it cannot
        evaluate leaves its outputs' descs as declared."""
        info = get_op_info(desc.type)
        abstract_ins = {}
        batch_dyn = False
        try:
            for slot, vs in in_vars.items():
                abstract_ins[slot] = [v.abstract_value() for v in vs]
                batch_dyn = batch_dyn or any(
                    v.shape and v.shape[0] == -1 for v in vs)
        except ValueError:          # an input without a shape
            return
        try:
            with torch.no_grad():
                out_abs = info.emit(
                    EmitCtx(desc, device=torch.device("meta")), abstract_ins)
        except Exception:  # advisory, like the reference's batch dims
            return
        for slot, vals in out_abs.items():
            for var, av in zip(out_vars.get(slot, []), vals):
                red = reduce_abstract(av)
                if red is None:
                    continue
                shape, dtype, lod = red
                var.desc.lod_level = (max(var.desc.lod_level, lod)
                                      if lod else 0)
                if batch_dyn and shape and shape[0] == _DUMMY_BATCH:
                    shape[0] = -1
                var.desc.shape = shape
                var.desc.dtype = dtype


def abstract_from_meta(shape, dtype: str, lod_level: int = 0,
                       name: str = "<var>"):
    """A ``meta`` tensor from recorded var metadata: the dummy extent for
    dynamic dims, int64 narrowed to the reference runtime's int32.  A
    sequence var (``lod_level == 1``) becomes a SeqArray of meta tensors
    with a dummy time axis after the batch axis, a level-2 var a
    NestedSeqArray with two dummy axes there."""
    if shape is None:
        raise ValueError(f"variable {name} has no shape")
    shape = [(_DUMMY_BATCH if d == -1 else d) for d in shape]
    dt = torch_dtype(runtime_dtype(dtype))
    if lod_level >= 2:
        data = torch.empty([shape[0], _DUMMY_TIME, _DUMMY_TIME, *shape[1:]],
                           dtype=dt, device="meta")
        outer = torch.empty([shape[0]], dtype=torch.int32, device="meta")
        inner = torch.empty([shape[0], _DUMMY_TIME], dtype=torch.int32,
                            device="meta")
        return NestedSeqArray(data, outer, inner)
    if lod_level == 1:
        data = torch.empty([shape[0], _DUMMY_TIME, *shape[1:]], dtype=dt,
                           device="meta")
        lengths = torch.empty([shape[0]], dtype=torch.int32, device="meta")
        return SeqArray(data, lengths)
    return torch.empty(shape, dtype=dt, device="meta")


def reduce_abstract(av):
    """Collapse an emitter's meta output to its recorded-desc form:
    ``(shape, dtype_name, lod_level)`` — dropping the dummy time axes a
    SeqArray/NestedSeqArray carries — or None for opaque values (a
    RankTable, a tensor array).  The inverse of ``abstract_from_meta``,
    shared by ``_infer_op`` and the analyzer's shape re-check."""
    if isinstance(av, NestedSeqArray):
        # drop both dummy sequence axes
        d = av.data
        return [d.shape[0]] + list(d.shape[3:]), runtime_dtype(d.dtype), 2
    if isinstance(av, SeqArray):
        # drop the dummy time axis, as the desc records it
        d = av.data
        return [d.shape[0]] + list(d.shape[2:]), runtime_dtype(d.dtype), 1
    if isinstance(av, torch.Tensor):
        return list(av.shape), runtime_dtype(av.dtype), 0
    return None


def _names_dict(d) -> Dict[str, List[str]]:
    out = {}
    for slot, vs in (d or {}).items():
        if vs is None:
            continue
        if not isinstance(vs, (list, tuple)):
            vs = [vs]
        out[slot] = [v.name if isinstance(v, Variable) else str(v) for v in vs]
    return out


def _vars_dict(d) -> Dict[str, List[Variable]]:
    out = {}
    for slot, vs in (d or {}).items():
        if vs is None:
            continue
        if not isinstance(vs, (list, tuple)):
            vs = [vs]
        out[slot] = [v for v in vs if isinstance(v, Variable)]
    return out


class Program:
    """A ProgramDesc plus Python Block wrappers."""

    def __init__(self):
        self.desc = ProgramDesc()
        self.blocks: List[Block] = [Block(self, self.desc.global_block())]
        self._current_block_idx = 0
        self._version = 0
        self._seed: Optional[int] = None  # program-level RNG seed override
        self._rng_salt = 0                # per-program __rng_salt__ counter

    def _bump_version(self):
        self._version += 1

    def _next_rng_salt(self) -> int:
        """Next per-program RNG salt — deterministic for a given build
        sequence, so two identical builds serialize byte-identically."""
        self._rng_salt += 1
        return self._rng_salt

    @property
    def version(self) -> int:
        return self._version

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    def global_block(self) -> Block:
        return self.blocks[0]

    def create_block(self) -> Block:
        """A new block whose parent is the current one; it becomes the
        current block (a control-flow layer builds its body there, and
        its ops resolve the parent's vars through ``Block.var``)."""
        bd = self.desc.append_block(self._current_block_idx)
        b = Block(self, bd)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        return b

    def rollback(self):
        """Make the current block's parent current again."""
        self._current_block_idx = self.current_block().parent_idx

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def to_string(self) -> str:
        import json

        return json.dumps(self.desc.to_dict(), indent=2)

    def serialize_to_string(self) -> bytes:
        return self.desc.serialize_to_string()

    @classmethod
    def parse_from_string(cls, data: bytes) -> "Program":
        p = cls()
        p._load_desc(ProgramDesc.parse_from_string(data))
        return p

    def _load_desc(self, desc: ProgramDesc):
        self.desc = desc
        self.blocks = []
        for bd in desc.blocks:
            b = Block(self, bd)
            for name in bd.vars:
                b.vars[name] = Variable(b, name)
            for od in bd.ops:
                b.ops.append(Operator(b, od))
            self.blocks.append(b)
        self._current_block_idx = 0
        # an op appended after the load must not reuse a loaded op's salt
        self._rng_salt = max(
            (int(od.attrs["__rng_salt__"])
             for bd in desc.blocks for od in bd.ops
             if "__rng_salt__" in od.attrs), default=0)
        self._bump_version()

    def clone(self, for_test: bool = False) -> "Program":
        """A deep copy through the wire format, Parameters kept as such.
        ``for_test=True`` sets ``is_test`` on the ops that behave
        differently at inference (dropout, batch_norm, fused_attention)."""
        p = Program.parse_from_string(self.serialize_to_string())
        for b_src, b_dst in zip(self.blocks, p.blocks):
            for name, v in b_src.vars.items():
                if isinstance(v, Parameter):
                    pv = Parameter.__new__(Parameter)
                    pv.block = b_dst
                    pv.desc = b_dst.desc.vars[name]
                    pv.op = None
                    pv.trainable = v.trainable
                    pv.optimize_attr = v.optimize_attr
                    pv.regularizer = v.regularizer
                    pv.gradient_clip_attr = v.gradient_clip_attr
                    pv.sharding = v.sharding
                    b_dst.vars[name] = pv
        if for_test:
            for b in p.blocks:
                for op in b.ops:
                    if "is_test" in _TEST_SENSITIVE_OPS.get(op.type, ()):
                        op.desc.attrs["is_test"] = True
        p._seed = self._seed
        return p

    @property
    def random_seed(self):
        return self._seed

    @random_seed.setter
    def random_seed(self, seed):
        self._seed = seed

    def analyze(self, level: str = "full", fetch_list=None,
                passes=None, options=None):
        """Run the static analyzer (fluid/analysis) over this program —
        dataflow verification, grad-graph lint, sharding/donation safety,
        and (at ``level="full"``) abstract shape/dtype re-checking against
        the recorded descs.  ``level="cost"`` instead runs the static
        cost family (peak-HBM planner, roofline estimate, recompile-
        hazard lint, comms estimator); ``options`` feeds those passes
        (assume_batch, chip, budget_bytes, batch/time_buckets,
        mesh_axes, dcn_axes) and their structured output lands in the
        returned report's ``.reports``.  Returns a ``Diagnostics``
        report; pass ``fetch_list`` (vars or names you intend to read)
        so dead-code findings reflect real intent."""
        from .analysis import analyze_program

        return analyze_program(self, level=level, fetch=fetch_list,
                               passes=passes, options=options)

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def __repr__(self):
        nops = sum(len(b.ops) for b in self.blocks)
        return f"Program(blocks={len(self.blocks)}, ops={nops})"


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(program: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, program
    return old


def switch_startup_program(program: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, program
    return old


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    """Analog of fluid.program_guard."""
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
