"""The serializable graph IR: programs of blocks of ops over typed vars —
a copy of ``paddle_tpu/fluid/core/desc.py``.

The canonical-JSON wire format (``serialize_to_string``, sorted keys,
compact separators) and its ``fingerprint`` are the contract between the
two packages: a program built by either serializes to the same bytes.
The desc layer is pure data; the port's lowering runs a block op by op
in eager PyTorch (``fluid/lowering.py``).
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional

from .types import VarType, canonical_dtype

__all__ = ["VarDesc", "OpDesc", "BlockDesc", "ProgramDesc"]


class VarDesc:
    """Analog of framework.proto VarDesc (:119) / var_desc.h:56."""

    __slots__ = ("name", "type", "dtype", "shape", "lod_level", "persistable",
                 "stop_gradient", "sharding")

    def __init__(self, name: str, type: str = VarType.DENSE_TENSOR,
                 dtype: str = "float32", shape: Optional[List[int]] = None,
                 lod_level: int = 0, persistable: bool = False,
                 stop_gradient: bool = False,
                 sharding: Optional[List[Optional[str]]] = None):
        self.name = name
        self.type = type
        self.dtype = canonical_dtype(dtype)
        self.shape = list(shape) if shape is not None else None
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        # per-dim mesh-axis names (TPU extension: SPMD placement is part of
        # the serialized program, the way pserver block assignment was part
        # of the reference's transpiled program)
        self.sharding = list(sharding) if sharding is not None else None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "type": self.type, "dtype": self.dtype,
            "shape": self.shape, "lod_level": self.lod_level,
            "persistable": self.persistable, "stop_gradient": self.stop_gradient,
            "sharding": self.sharding,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VarDesc":
        return cls(**d)

    def __repr__(self):
        return (f"VarDesc({self.name!r}, {self.type}, {self.dtype}, "
                f"shape={self.shape}, persistable={self.persistable})")


class OpDesc:
    """Analog of framework.proto OpDesc (:34) / op_desc.h:28.

    ``inputs`` / ``outputs`` map *slot names* (e.g. "X", "Out") to ordered
    lists of variable names — duplicate-slot arity is how the reference models
    variadic ops like ``sum``.  ``attrs`` hold JSON-serializable values; a
    sub-block reference is stored as ``{"__block__": idx}``.
    """

    __slots__ = ("type", "inputs", "outputs", "attrs")

    def __init__(self, type: str,
                 inputs: Optional[Dict[str, List[str]]] = None,
                 outputs: Optional[Dict[str, List[str]]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def input_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    def output_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name: str, default: Any = None) -> Any:
        return self.attrs.get(name, default)

    def block_attr(self, name: str) -> Optional[int]:
        v = self.attrs.get(name)
        if isinstance(v, dict) and "__block__" in v:
            return v["__block__"]
        return None

    def set_block_attr(self, name: str, block_idx: int) -> None:
        self.attrs[name] = {"__block__": int(block_idx)}

    def to_dict(self) -> Dict[str, Any]:
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": self.attrs}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OpDesc":
        return cls(type=d["type"], inputs=d.get("inputs"),
                   outputs=d.get("outputs"), attrs=d.get("attrs"))

    def __repr__(self):
        return f"OpDesc({self.type}: {self.inputs} -> {self.outputs})"


class BlockDesc:
    """Analog of framework.proto BlockDesc (:138) / block_desc.h:37."""

    __slots__ = ("idx", "parent_idx", "vars", "ops")

    def __init__(self, idx: int, parent_idx: int = -1):
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, VarDesc] = {}
        self.ops: List[OpDesc] = []

    def var(self, name: str) -> VarDesc:
        return self.vars[name]

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def add_var(self, desc: VarDesc) -> VarDesc:
        self.vars[desc.name] = desc
        return desc

    def append_op(self, op: OpDesc) -> OpDesc:
        self.ops.append(op)
        return op

    def prepend_op(self, op: OpDesc) -> OpDesc:
        self.ops.insert(0, op)
        return op

    def to_dict(self) -> Dict[str, Any]:
        return {
            "idx": self.idx, "parent_idx": self.parent_idx,
            "vars": {k: v.to_dict() for k, v in sorted(self.vars.items())},
            "ops": [op.to_dict() for op in self.ops],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BlockDesc":
        b = cls(d["idx"], d.get("parent_idx", -1))
        for name, vd in d.get("vars", {}).items():
            b.vars[name] = VarDesc.from_dict(vd)
        b.ops = [OpDesc.from_dict(od) for od in d.get("ops", [])]
        return b


class ProgramDesc:
    """Analog of framework.proto ProgramDesc (:148) / program_desc.h:29."""

    VERSION = 1

    def __init__(self):
        self.blocks: List[BlockDesc] = [BlockDesc(0, -1)]

    def block(self, idx: int) -> BlockDesc:
        return self.blocks[idx]

    def global_block(self) -> BlockDesc:
        return self.blocks[0]

    def append_block(self, parent_idx: int) -> BlockDesc:
        b = BlockDesc(len(self.blocks), parent_idx)
        self.blocks.append(b)
        return b

    def to_dict(self) -> Dict[str, Any]:
        return {"version": self.VERSION,
                "blocks": [b.to_dict() for b in self.blocks]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ProgramDesc":
        p = cls()
        p.blocks = [BlockDesc.from_dict(bd) for bd in d["blocks"]]
        return p

    # -- wire format ---------------------------------------------------------
    def serialize_to_string(self) -> bytes:
        """Canonical JSON (sorted keys) — the analog of proto SerializeToString
        used by save_inference_model (reference fluid/io.py:297)."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":")).encode("utf-8")

    @classmethod
    def parse_from_string(cls, data: bytes) -> "ProgramDesc":
        return cls.from_dict(json.loads(data.decode("utf-8")))

    def fingerprint(self) -> str:
        return hashlib.sha256(self.serialize_to_string()).hexdigest()
