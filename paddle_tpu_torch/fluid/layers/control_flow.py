"""Control-flow layers: While, StaticRNN, DynamicRNN, Switch, IfElse and
tensor arrays — the port of ``paddle_tpu/fluid/layers/control_flow.py``,
building the same programs byte for byte.

A body is built in a sub-block of the program (``Program.create_block``
/ ``rollback``); closing it appends the one op that runs it
(``ops/control_flow_ops.py``): the parent's vars the body writes become
the op's carries (``X``, each read through an ``@PRE`` snapshot so the
op's gradient re-reads the loop-entry value) and those it only reads
its closure inputs (``P``).  DynamicRNN is one masked
``dynamic_recurrent`` op over the padded SeqArray layout, where the
reference's fluid assembles lod_rank_table, lod_tensor_to_array, While
and shrink_memory.  Step inputs are batch-major [B, T, D] (dense) or
sequence vars (lod_level=1).  ``Print`` appends a ``print`` op, which
prints at every step (a program holding one runs eagerly on the card,
never captured: see ``ops/io_ops.py``).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

from .. import unique_name
from ..framework import Block, Variable
from ..layer_helper import LayerHelper

__all__ = [
    "While", "StaticRNN", "DynamicRNN", "Switch", "IfElse",
    "increment", "less_than", "less_equal", "greater_than", "greater_equal",
    "equal", "not_equal", "logical_and", "logical_or", "logical_xor",
    "logical_not", "array_write", "array_read", "array_length", "create_array",
    "lod_rank_table", "max_sequence_len", "lod_tensor_to_array",
    "array_to_lod_tensor", "shrink_memory", "Print",
    "reorder_lod_tensor_by_rank",
]


# ---------------------------------------------------------------------------
# small layer fns
# ---------------------------------------------------------------------------

def increment(x, value=1.0, in_place=True):
    """reference increment (control_flow.py): bump a counter var."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_tmp_variable(x.dtype)
    helper.append_op("increment", inputs={"X": x}, outputs={"Out": out},
                     attrs={"step": float(value)})
    return out


def _cmp_layer(op_type):
    def fn(x, y, cond=None, **ignored):
        helper = LayerHelper(op_type)
        if cond is None:
            cond = helper.create_tmp_variable("bool")
            cond.stop_gradient = True
        helper.append_op(op_type, inputs={"X": x, "Y": y},
                         outputs={"Out": cond})
        return cond
    fn.__name__ = op_type
    return fn


less_than = _cmp_layer("less_than")
less_equal = _cmp_layer("less_equal")
greater_than = _cmp_layer("greater_than")
greater_equal = _cmp_layer("greater_equal")
equal = _cmp_layer("equal")
not_equal = _cmp_layer("not_equal")


def _logical_layer(op_type, arity=2):
    def fn(x, y=None, out=None):
        helper = LayerHelper(op_type)
        if out is None:
            out = helper.create_tmp_variable("bool")
            out.stop_gradient = True
        ins = {"X": x} if arity == 1 else {"X": x, "Y": y}
        helper.append_op(op_type, inputs=ins, outputs={"Out": out})
        return out
    fn.__name__ = op_type
    return fn


logical_and = _logical_layer("logical_and")
logical_or = _logical_layer("logical_or")
logical_xor = _logical_layer("logical_xor")
logical_not = _logical_layer("logical_not", arity=1)


def create_array(dtype):
    """reference control_flow.py create_array — declares a tensor-array var;
    storage is allocated by the first array_write (capacity attr there)."""
    helper = LayerHelper("array")
    return helper.block.create_var(
        name=unique_name.generate("array"), type="tensor_array",
        dtype=dtype)


def array_write(x, i, array=None, capacity=64):
    """reference array_write (tensor_array_read_write_op.cc WriteToArray).

    ``capacity`` bounds the array when it is created by this write (a
    buffer of fixed shape); writes past capacity are dropped."""
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    inputs = {"X": x, "I": i}
    if array.op is not None or getattr(array, "_written", False):
        inputs["Array"] = array
    helper.append_op("write_to_array", inputs=inputs,
                     outputs={"Out": array}, attrs={"capacity": capacity})
    array._written = True
    # element shape metadata so array_read consumers can infer shapes
    if x.shape is not None:
        array.desc.shape = list(x.shape)
        array.desc.dtype = x.dtype
    return array


def array_read(array, i):
    """reference array_read (ReadFromArray)."""
    helper = LayerHelper("array_read")
    out = helper.create_tmp_variable(array.dtype)
    if array.shape is not None:
        out.desc.shape = list(array.shape)
    helper.append_op("read_from_array", inputs={"X": array, "I": i},
                     outputs={"Out": out}, infer_shape=False)
    return out


def array_length(array):
    """reference lod_array_length_op.cc."""
    helper = LayerHelper("array_length")
    out = helper.create_tmp_variable("int64")
    out.stop_gradient = True
    helper.append_op("array_length", inputs={"X": array},
                     outputs={"Out": out})
    return out


def lod_rank_table(x, level=0):
    """reference lod_rank_table_op.cc — lengths table of a sequence batch."""
    helper = LayerHelper("lod_rank_table")
    table = helper.block.create_var(name=unique_name.generate("rank_table"),
                                    type="raw")
    table.stop_gradient = True
    helper.append_op("lod_rank_table", inputs={"X": x},
                     outputs={"Out": table})
    return table


def max_sequence_len(rank_table):
    helper = LayerHelper("max_seqence_len")
    res = helper.create_tmp_variable("int64")
    res.stop_gradient = True
    helper.append_op("max_sequence_len", inputs={"RankTable": rank_table},
                     outputs={"Out": res})
    return res


def lod_tensor_to_array(x, table):
    helper = LayerHelper("lod_tensor_to_array")
    array = helper.block.create_var(name=unique_name.generate("array"),
                                    type="tensor_array", dtype=x.dtype)
    helper.append_op("lod_tensor_to_array",
                     inputs={"X": x, "RankTable": table},
                     outputs={"Out": array})
    array._written = True
    if x.shape is not None:
        # per-timestep element: [batch, features] (seq desc shapes already
        # exclude the time axis; dense [B, T, ...] drops dim 1)
        array.desc.shape = (list(x.shape) if x.lod_level
                            else [x.shape[0]] + list(x.shape[2:]))
        array.desc.dtype = x.dtype
    return array


def array_to_lod_tensor(x, table):
    helper = LayerHelper("array_to_lod_tensor")
    out = helper.create_tmp_variable(x.dtype, lod_level=1)
    helper.append_op("array_to_lod_tensor",
                     inputs={"X": x, "RankTable": table},
                     outputs={"Out": out})
    return out


def shrink_memory(x, i, table):
    """Kept for API parity; identity under padding+masking (see op doc)."""
    helper = LayerHelper("shrink_memory")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("shrink_rnn_memory",
                     inputs={"X": x, "I": i, "RankTable": table},
                     outputs={"Out": out})
    return out


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """reference print_op.cc: debug-print a tensor at every step of the
    running program."""
    helper = LayerHelper("print")
    helper.append_op("print", inputs={"In": input},
                     attrs={"first_n": first_n, "summarize": summarize,
                            "message": message or "",
                            "print_phase": print_phase})
    return input


# ---------------------------------------------------------------------------
# block-collection helpers
# ---------------------------------------------------------------------------

def _snapshot(parent: Block, variables):
    """Copy vars to fresh @PRE twins so a sub-block op's inputs keep their
    ENTRY values even though the op writes back to the original names — the
    desc-level SSA that lets the op's grad twin re-read correct values (the
    reference's fluid saves step-scopes instead)."""
    pres = []
    for v in variables:
        pre = parent.create_var(
            name=unique_name.generate(v.name + ".pre"), dtype=v.dtype,
            shape=list(v.shape) if v.shape else None, lod_level=v.lod_level,
            type=v.type)
        pre.stop_gradient = v.stop_gradient
        parent.append_op("assign", inputs={"X": v}, outputs={"Out": pre},
                         infer_shape=False)
        pres.append(pre)
    return pres


def _ancestor_var(block: Block, name: str) -> bool:
    b = block.parent_block
    while b is not None:
        if name in b.vars:
            return True
        b = b.parent_block
    return False


def _collect_block_io(sub_block: Block):
    """Classify parent-block vars touched by a sub-block: (written, read_only).

    The analog of the reference's scope-variable discovery in
    While.complete (control_flow.py:658-682): anything defined locally stays
    in the step scope; parent vars written become loop carries; parent vars
    only read are closure constants (slot P)."""
    local = set(sub_block.vars)
    written, read = [], []
    seen_w, seen_r = set(), set()
    for op in sub_block.ops:
        for name in op.desc.input_names():
            if (name and name not in local and name not in seen_r
                    and _ancestor_var(sub_block, name)):
                seen_r.add(name)
                read.append(name)
        for name in op.desc.output_names():
            if (name and name not in local and name not in seen_w
                    and _ancestor_var(sub_block, name)):
                seen_w.add(name)
                written.append(name)
    read_only = [n for n in read if n not in seen_w]
    return written, read_only


# ---------------------------------------------------------------------------
# While
# ---------------------------------------------------------------------------

class While:
    """reference control_flow.py While:602.

    ``max_iters`` bounds the trip count and makes the loop reverse-mode
    differentiable (exactly ``max_iters`` iterations, each kept where the
    condition held); without it the host reads the condition each
    iteration (forward-only)::

        i = layers.fill_constant(shape=[1], dtype='int64', value=0)
        cond = layers.less_than(x=i, y=n)
        loop = layers.While(cond=cond)
        with loop.block():
            ...
            layers.increment(x=i, in_place=True)
            layers.less_than(x=i, y=n, cond=cond)
    """

    def __init__(self, cond: Variable, max_iters: Optional[int] = None,
                 name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.max_iters = max_iters
        self.sub_block: Optional[Block] = None

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent = program.current_block()
        self.sub_block = program.create_block()
        try:
            yield
        finally:
            program.rollback()
        self._complete(parent)

    def _complete(self, parent: Block):
        written, read_only = _collect_block_io(self.sub_block)
        cond_name = self.cond_var.name
        x_names = [n for n in written if n != cond_name]
        p_names = [n for n in read_only if n != cond_name]
        x_vars = [parent.var(n) for n in x_names]
        pre_x = _snapshot(parent, x_vars)
        pre_cond, = _snapshot(parent, [self.cond_var])
        op = parent.append_op(
            "while",
            inputs={"Condition": pre_cond, "X": pre_x,
                    "P": [parent.var(n) for n in p_names]},
            outputs={"Out": x_vars, "CondOut": self.cond_var},
            attrs={"max_iters": self.max_iters,
                   "carried_names": x_names, "cond_name": cond_name},
            infer_shape=False)
        op.desc.set_block_attr("sub_block", self.sub_block.idx)


# ---------------------------------------------------------------------------
# StaticRNN / DynamicRNN
# ---------------------------------------------------------------------------

class _RNNBuilder:
    """Shared builder for StaticRNN (dense [B,T,D] inputs -> ``recurrent``
    op) and DynamicRNN (seq inputs -> masked ``dynamic_recurrent`` op)."""

    IN_RNN_BLOCK = False
    _op_type = "recurrent"

    def __init__(self, name=None, is_reverse=False):
        self.helper = LayerHelper(self._op_type, name=name)
        self.sub_block: Optional[Block] = None
        self.parent_block: Optional[Block] = None
        self.step_inputs = []      # (outer Variable, inner Variable)
        self.memories = []         # dict per memory
        self.outputs_inner = []    # inner Variables
        self.outputs_outer = []    # outer Variables (created at complete)
        self.is_reverse = is_reverse
        self._status = "outside"

    @contextlib.contextmanager
    def _guard(self):
        program = self.helper.main_program
        self.parent_block = program.current_block()
        self.sub_block = program.create_block()
        self._status = "in_block"
        try:
            yield
        finally:
            program.rollback()
        self._status = "done"
        self._complete()

    def step_input(self, x: Variable, level=0) -> Variable:
        assert self._status == "in_block", "step_input must be called in block()"
        if x.lod_level and x.lod_level > 0:
            inner_shape = list(x.shape or [])
        else:
            shape = list(x.shape or [])
            inner_shape = [shape[0]] + shape[2:]  # drop the time axis
        # a nested (level-2) input steps its OUTER axis: each step sees one
        # sub-sequence, i.e. a level-1 sequence (SubsequenceInput semantics)
        inner_lod = max((x.lod_level or 0) - 1, 0)
        inner = self.sub_block.create_var(
            name=unique_name.generate(f"{self.helper.name}.step_in"),
            dtype=x.dtype, shape=inner_shape, lod_level=inner_lod)
        self.step_inputs.append((x, inner))
        return inner

    def static_input(self, x: Variable) -> Variable:
        """Per-sequence constant input (reference StaticRNN.static_input /
        DynamicRNN static_input minus the rank-table reorder — padding keeps
        batch order stable)."""
        return x

    def memory(self, init: Optional[Variable] = None, shape=None,
               value=0.0, dtype="float32", need_reorder=False, **kw) -> Variable:
        assert self._status == "in_block", "memory must be called in block()"
        if init is not None:
            dtype = init.dtype
            ishape = list(init.shape or [])
        else:
            assert shape is not None, "memory needs init= or shape="
            ishape = [-1] + list(shape)
        inner = self.sub_block.create_var(
            name=unique_name.generate(f"{self.helper.name}.mem"),
            dtype=dtype, shape=ishape)
        self.memories.append({
            "pre": inner, "init": init, "update": None,
            "auto": None if init is not None else
            {"shape": list(shape), "value": float(value), "dtype": dtype}})
        return inner

    def update_memory(self, mem: Variable, var: Variable) -> None:
        for m in self.memories:
            if m["pre"].name == mem.name:
                m["update"] = var
                return
        raise ValueError(f"{mem.name} is not a memory of this RNN")

    def step_output(self, o: Variable) -> None:
        assert self._status == "in_block"
        self.outputs_inner.append(o)

    def output(self, *outputs) -> None:
        for o in outputs:
            self.step_output(o)

    def _seq_mode(self) -> bool:
        return any(x.lod_level and x.lod_level > 0
                   for x, _ in self.step_inputs)

    def _complete(self):
        assert self.step_inputs, "RNN needs at least one step_input"
        for m in self.memories:
            assert m["update"] is not None, \
                f"memory {m['pre'].name} never update_memory()'d"
        parent = self.parent_block
        seq = self._seq_mode()
        op_type = "dynamic_recurrent" if seq or self._op_type == \
            "dynamic_recurrent" else "recurrent"

        written, read_only = _collect_block_io(self.sub_block)
        inner_names = {v.name for _, v in self.step_inputs}
        inner_names |= {m["pre"].name for m in self.memories}
        p_names = [n for n in read_only if n not in inner_names]

        init_vars = [m["init"] for m in self.memories if m["init"] is not None]
        auto_specs = [m["auto"] for m in self.memories]

        # outer outputs: [B, T, ...] dense, or seq vars mirroring inputs
        x0 = self.step_inputs[0][0]
        t_dim = None if seq else (list(x0.shape or [None, None])[1])
        for o in self.outputs_inner:
            oshape = list(o.shape or [])
            if seq:
                # a sequence-valued step output stacks to a nested sequence
                outer_shape, lod = oshape, 1 + (o.lod_level or 0)
            else:
                outer_shape = [oshape[0] if oshape else -1, t_dim] + oshape[1:]
                lod = 0
            self.outputs_outer.append(parent.create_var(
                name=unique_name.generate(f"{self.helper.name}.out"),
                dtype=o.dtype, shape=outer_shape, lod_level=lod))
        final_states = [parent.create_var(
            name=unique_name.generate(f"{self.helper.name}.final"),
            dtype=m["pre"].dtype, shape=list(m["pre"].shape or []))
            for m in self.memories]

        op = parent.append_op(
            op_type,
            inputs={"X": [x for x, _ in self.step_inputs],
                    "InitStates": init_vars,
                    "P": [parent.var(n) for n in p_names]},
            outputs={"Out": self.outputs_outer,
                     "FinalStates": final_states},
            attrs={
                "step_input_names": [v.name for _, v in self.step_inputs],
                "state_names": [m["pre"].name for m in self.memories],
                "state_update_names": [m["update"].name
                                       for m in self.memories],
                "step_output_names": [o.name for o in self.outputs_inner],
                "auto_init_states": auto_specs,
                "is_reverse": self.is_reverse,
            }, infer_shape=False)
        op.desc.set_block_attr("sub_block", self.sub_block.idx)
        self._final_states = final_states

    def __call__(self):
        assert self._status == "done", "rnn() before the block closed"
        if len(self.outputs_outer) == 1:
            return self.outputs_outer[0]
        return self.outputs_outer


class StaticRNN(_RNNBuilder):
    """reference control_flow.py StaticRNN:378 — unrolled-shape RNN over
    dense [B, T, D] inputs, one ``recurrent`` op."""

    _op_type = "recurrent"

    def step(self):
        return self._guard()


class DynamicRNN(_RNNBuilder):
    """reference control_flow.py DynamicRNN:1252 — variable-length RNN.

    The reference assembles lod_rank_table + lod_tensor_to_array + While +
    shrink_memory; under SeqArray padding the whole assembly is one masked
    loop (``dynamic_recurrent``): finished sequences' carries freeze and
    their outputs are zeroed, which is exactly the reference's shrinking
    semantics without the batch reorder."""

    _op_type = "dynamic_recurrent"

    def block(self):
        return self._guard()


# ---------------------------------------------------------------------------
# Switch
# ---------------------------------------------------------------------------

class Switch:
    """reference control_flow.py Switch — if / elif / else chain.

    Each case body runs under ``conditional_block``; a case fires
    only when its condition holds and no earlier case fired.  Vars assigned
    in case bodies must already exist (assign a default before the Switch or
    in ``default()``), mirroring the reference's requirement that Switch
    cases assign to pre-created vars (e.g. learning-rate decay)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.pre_not_conds: List[Variable] = []
        self._inside = False

    def __enter__(self):
        self._inside = True
        return self

    def __exit__(self, *exc):
        self._inside = False
        return False

    @contextlib.contextmanager
    def _case_guard(self, cond: Optional[Variable]):
        program = self.helper.main_program
        parent = program.current_block()
        if cond is None:  # default: fires when no previous case fired
            assert self.pre_not_conds, "default() before any case()"
            eff = self.pre_not_conds[0]
            for nc in self.pre_not_conds[1:]:
                eff = logical_and(eff, nc)
        else:
            eff = cond
            for nc in self.pre_not_conds:
                eff = logical_and(eff, nc)
            self.pre_not_conds.append(logical_not(cond))
        sub_block = program.create_block()
        try:
            yield
        finally:
            program.rollback()
        written, read_only = _collect_block_io(sub_block)
        x_names = list(dict.fromkeys(read_only + written))
        pre_x = _snapshot(parent, [parent.var(n) for n in x_names])
        op = parent.append_op(
            "conditional_block",
            inputs={"Cond": eff, "X": pre_x},
            outputs={"Out": [parent.var(n) for n in written]},
            attrs={"out_names": written, "in_names": x_names,
                   "is_scalar_condition": True},
            infer_shape=False)
        op.desc.set_block_attr("sub_block", sub_block.idx)

    def case(self, condition: Variable):
        assert self._inside, "case() outside with-Switch"
        return self._case_guard(condition)

    def default(self):
        assert self._inside, "default() outside with-Switch"
        return self._case_guard(None)


def reorder_lod_tensor_by_rank(x, rank_table):
    """reference layers wrapper over reorder_lod_tensor_by_rank_op.cc:
    permute a sequence batch into the rank table's (descending-length)
    order."""
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    helper.append_op("reorder_lod_tensor_by_rank",
                     inputs={"X": x, "RankTable": rank_table},
                     outputs={"Out": out})
    return out


class IfElse:
    """reference control_flow.py IfElse (:1151): route rows by a boolean
    mask through a true and a false branch, then merge.

    The reference splits the batch into two *smaller* LoD tensors and runs
    each branch under a ConditionalBlock (split_lod_tensor_op.cc /
    conditional_block_op.cc).  Here, as in the JAX package, both branches
    compute over the full batch extent on mask-zeroed rows and
    merge_lod_tensor selects per row: identical results for the row-wise
    branch bodies IfElse is defined over, with no dynamic shapes
    (predication over both branches).

    Usage (reference-compatible)::

        ie = layers.IfElse(cond)
        with ie.true_block():
            d = ie.input(x)
            ie.output(layers.scale(d, scale=2.0))
        with ie.false_block():
            d = ie.input(x)
            ie.output(d)
        merged, = ie()
    """

    OUT_IF_ELSE_BLOCKS = 0
    IN_IF_ELSE_TRUE_BLOCKS = 1
    IN_IF_ELSE_FALSE_BLOCKS = 2

    def __init__(self, cond: Variable, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.status = IfElse.OUT_IF_ELSE_BLOCKS
        self.input_table = {}
        self.output_table = ([], [])     # (false_outs, true_outs) — ref order

    @contextlib.contextmanager
    def _block_guard(self, is_true: bool):
        if self.status != IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("cannot nest IfElse blocks")
        self.status = (IfElse.IN_IF_ELSE_TRUE_BLOCKS if is_true
                       else IfElse.IN_IF_ELSE_FALSE_BLOCKS)
        try:
            yield
        except BaseException:
            self.status = IfElse.OUT_IF_ELSE_BLOCKS
            raise            # user errors must not be masked by the check
        else:
            self.status = IfElse.OUT_IF_ELSE_BLOCKS
            if not self.output_table[1 if is_true else 0]:
                raise ValueError("Must set output inside block")

    def true_block(self):
        return self._block_guard(True)

    def false_block(self):
        return self._block_guard(False)

    def input(self, x: Variable) -> Variable:
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("input() must be called inside a block")
        if id(x) not in self.input_table:
            out_true = self.helper.create_tmp_variable(
                x.dtype, lod_level=x.lod_level)
            out_false = self.helper.create_tmp_variable(
                x.dtype, lod_level=x.lod_level)
            self.helper.append_op(
                "split_lod_tensor", inputs={"X": x, "Mask": self.cond},
                outputs={"OutTrue": out_true, "OutFalse": out_false},
                attrs={"level": 0})
            self.input_table[id(x)] = (out_true, out_false)
        out_true, out_false = self.input_table[id(x)]
        return (out_true
                if self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS
                else out_false)

    def output(self, *outs: Variable) -> None:
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("output() must be called inside a block")
        self.output_table[
            1 if self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS else 0
        ].extend(outs)

    def __call__(self):
        if self.status != IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("IfElse::__call__ must be out of sub-blocks")
        false_outs, true_outs = self.output_table
        if len(false_outs) != len(true_outs):
            raise ValueError(
                "true_block and false_block must set the same number of "
                "outputs")
        merged = []
        for t, f in zip(true_outs, false_outs):
            out = self.helper.create_tmp_variable(
                t.dtype, lod_level=t.lod_level)
            self.helper.append_op(
                "merge_lod_tensor",
                inputs={"InTrue": t, "InFalse": f, "Mask": self.cond},
                outputs={"Out": out}, attrs={"level": 0})
            merged.append(out)
        return merged
