"""Places, Scope and Executor — the port of ``paddle_tpu/fluid/executor.py``.

``Executor.run(program, feed, fetch_list)`` runs one step of a block
eagerly on the executor's device through ``lowering.run_block_ops``:
feeds become device tensors, persistable vars the block reads come from
the Scope, and the persistable vars it writes go back.  Where the
reference donates the state buffers to XLA, the port's optimizer ops
update the scope's tensors in place.

``Executor()`` and ``Executor(CUDAPlace(i))`` run on the card and raise
without one; only ``Executor(CPUPlace())`` runs on the CPU, as the tests
do.  ``scope_from_numpy`` / ``scope_to_numpy`` carry named arrays (a JAX
scope, a checkpoint) in and out of a Scope.  Feeds may be bfloat16
(``ml_dtypes`` arrays, as the reference takes them); fetches of a
bfloat16 value come back as float32.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .core.lod import SeqArray
from .core.types import runtime_dtype, torch_dtype
from .framework import Program, Variable, default_main_program
from .lowering import BlockPlan, run_block_ops

__all__ = ["Scope", "global_scope", "scope_guard", "Executor", "CPUPlace",
           "CUDAPlace", "scope_from_numpy", "scope_to_numpy"]


class CUDAPlace:
    """Device tag for one CUDA card (reference platform::CUDAPlace)."""

    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    @property
    def device(self) -> str:
        return f"cuda:{self.device_id}"

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


class CPUPlace:
    def __init__(self):
        self.device_id = 0

    @property
    def device(self) -> str:
        return "cpu"

    def __repr__(self):
        return "CPUPlace()"


class Scope:
    """name -> tensor map with parent chaining (reference scope.h:38),
    plus the RNG state of the steps run in it."""

    def __init__(self, parent: Optional["Scope"] = None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent
        self._rng_seed: Optional[int] = None
        self._rng_step: int = 0

    def var(self, name: str) -> str:
        self.vars.setdefault(name, None)
        return name

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return None

    def has_var(self, name: str) -> bool:
        s: Optional[Scope] = self
        while s is not None:
            if name in s.vars:
                return True
            s = s.parent
        return False

    def set_var(self, name: str, value) -> None:
        self.vars[name] = value

    def next_rng_bits(self, seed: Optional[int]) -> Tuple[int, int]:
        """(seed, step) of the next step: ``seed`` is the program's
        random_seed, else one drawn from the clock at the first step."""
        if self._rng_seed is None or (seed is not None
                                      and seed != self._rng_seed):
            self._rng_seed = (seed if seed is not None
                              else (time.time_ns() & 0x7FFFFFFF))
        self._rng_step += 1
        return self._rng_seed, self._rng_step


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    global _global_scope
    old, _global_scope = _global_scope, scope
    try:
        yield
    finally:
        _global_scope = old


def _place_device(place) -> torch.device:
    if place is None:
        return resolve_device(None)
    if isinstance(place, (CUDAPlace, CPUPlace)):
        return resolve_device(place.device)
    raise TypeError(f"Executor place must be CUDAPlace or CPUPlace, got "
                    f"{place!r}")


def _host_tensor(v) -> torch.Tensor:
    """A host value as a CPU tensor (a copy).  numpy has no bfloat16 of
    its own: an array of the ``ml_dtypes`` bfloat16 type (what a JAX
    program feeds) crosses as its 16-bit pattern, without importing
    ``ml_dtypes``."""
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.tensor(a)


def _to_device(v, device: torch.device):
    """One host value as a device tensor; int64 and float64 narrow to
    int32 and float32 as in the reference's runtime.  Arrays are copied:
    the optimizer ops update scope tensors in place, and a read-only
    array (a JAX buffer) must not be written through.  A SeqArray moves
    as its data and its int32 lengths."""
    if isinstance(v, SeqArray):
        return SeqArray(_to_device(v.data, device),
                        _to_device(v.lengths, device))
    t = v if isinstance(v, torch.Tensor) else _host_tensor(v)
    return t.to(device=device, dtype=torch_dtype(runtime_dtype(t.dtype)))


def _to_numpy(t):
    """A fetched value on the host: a numpy array, or a SeqArray of numpy
    data and lengths.  A bfloat16 value comes back as float32 (exactly):
    numpy has no bfloat16, where the reference returns an ``ml_dtypes``
    bfloat16 array."""
    if isinstance(t, SeqArray):
        return SeqArray(_to_numpy(t.data), _to_numpy(t.lengths))
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def scope_from_numpy(arrays: Mapping[str, Any], place=None,
                     scope: Optional[Scope] = None) -> Scope:
    """Put ``{name: array}`` into ``scope`` (a new Scope by default) as
    tensors on ``place``'s device (``None``: the card)."""
    device = _place_device(place)
    scope = Scope() if scope is None else scope
    for name, arr in arrays.items():
        scope.set_var(name, _to_device(np.asarray(arr), device))
    return scope


def scope_to_numpy(scope: Scope, names: Optional[Sequence[str]] = None
                   ) -> Dict[str, np.ndarray]:
    """The tensors of ``scope`` (all, or ``names``) as numpy arrays."""
    names = [n for n, v in scope.vars.items() if v is not None] \
        if names is None else names
    return {n: _to_numpy(scope.find_var(n)) for n in names}


class Executor:
    """Eager executor.  API mirrors fluid.Executor:
    ``run(program, feed, fetch_list, scope)`` -> list of numpy arrays."""

    def __init__(self, place: Union[CUDAPlace, CPUPlace, None] = None):
        self.device = _place_device(place)
        self.place = place if place is not None else CUDAPlace(
            self.device.index or 0)
        self._plans: Dict[tuple, BlockPlan] = {}

    @staticmethod
    def _program_key(program: Program) -> str:
        """Content key: the desc's fingerprint, recomputed only when the
        program's mutation version changes."""
        cached = getattr(program, "_fp_cache", None)
        if cached is not None and cached[0] == program.version:
            return cached[1]
        fp = program.desc.fingerprint()
        program._fp_cache = (program.version, fp)
        return fp

    def _plan(self, program: Program, feed_names, fetch_names) -> BlockPlan:
        key = (self._program_key(program), tuple(sorted(feed_names)),
               tuple(fetch_names))
        plan = self._plans.get(key)
        if plan is None:
            plan = BlockPlan(program.desc.global_block(), feed_names,
                             fetch_names)
            self._plans[key] = plan
        return plan

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True,
            mode: str = "train", **unported) -> List[Any]:
        """One step of ``program``'s global block.  ``mode="infer"``
        turns dropout off.  The reference's ``validate`` and ``guard``
        options are not ported and raise."""
        if unported:
            raise NotImplementedError(
                f"Executor.run: {', '.join(sorted(unported))} not ported "
                f"to paddle_tpu_torch")
        program = program or default_main_program()
        scope = scope or global_scope()
        feed = {k: _to_device(v, self.device)
                for k, v in (feed or {}).items()}
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        plan = self._plan(program, list(feed), fetch_names)
        env: Dict[str, Any] = {}
        for n in plan.state_in:
            v = scope.find_var(n)
            if v is None:
                raise RuntimeError(
                    f"Executor: variable {n!r} is read by the program but "
                    f"absent from the scope — did you run the startup "
                    f"program?")
            if v.device != self.device:
                raise ValueError(f"Executor: scope variable {n!r} is on "
                                 f"{v.device}, the executor runs on "
                                 f"{self.device}")
            env[n] = v
        env.update(feed)
        seed, step = scope.next_rng_bits(program.random_seed)
        with torch.no_grad():
            run_block_ops(plan, env, seed, step, self.device, mode)
        for n in plan.state_out:
            scope.set_var(n, env[n])
        fetches = [env[n] for n in fetch_names]
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return fetches

    def run_pipeline(self, *args, **kwargs):
        raise NotImplementedError("Executor.run_pipeline is not ported to "
                                  "paddle_tpu_torch")

    def run_steps(self, *args, **kwargs):
        raise NotImplementedError("Executor.run_steps is not ported to "
                                  "paddle_tpu_torch")

    def cost_analysis(self, *args, **kwargs):
        raise NotImplementedError("Executor.cost_analysis (XLA's HLO cost "
                                  "model) is not ported to paddle_tpu_torch")
