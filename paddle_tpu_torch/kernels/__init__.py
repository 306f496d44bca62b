"""Kernels of the port.  ``flash_attention.ragged_decode_attention`` is
the serving path's paged attention: a CUDA C++ kernel for ``sm_90a``
(``csrc/ragged_paged_attention.cu``, built by ``_build``) on CUDA tensors,
its plain PyTorch version on CPU tensors.

Each wrapper counts its launches on a plain attribute of its function.
``launch_counts`` reads them all as one flat dict and ``add_launches``
adds such a dict back: the executor uses the pair to take the launches
that a CUDA graph capture records (and does not run) out of the counts,
and to add them at every replay of the graph."""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

__all__ = ["launch_counts", "add_launches"]

# (module, wrapper, attribute) of every launch counter: an int, or a dict
# of ints, or a dict of such dicts
_COUNTERS = (("flash_attention", "flash_attention", "launches"),
             ("flash_attention", "flash_attention", "launches_by_dtype"),
             ("flash_attention", "ragged_decode_attention", "launches"),
             ("lstm", "lstm_forward", "launches"))


def _owner(mod: str, fn: str):
    return getattr(importlib.import_module(f"{__name__}.{mod}"), fn)


def launch_counts() -> Dict[Tuple, int]:
    """Every launch counter now, keyed by its path (module, wrapper,
    attribute, dict keys...)."""
    out: Dict[Tuple, int] = {}

    def walk(path, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(path + (k,), x)
        else:
            out[path] = int(v)

    for mod, fn, attr in _COUNTERS:
        walk((mod, fn, attr), getattr(_owner(mod, fn), attr))
    return out


def add_launches(delta: Dict[Tuple, int]) -> None:
    """Add ``delta`` (a ``launch_counts``-shaped dict) to the counters."""
    for (mod, fn, attr, *keys), n in delta.items():
        if not n:
            continue
        owner = _owner(mod, fn)
        if not keys:
            setattr(owner, attr, getattr(owner, attr) + n)
            continue
        d = getattr(owner, attr)
        for k in keys[:-1]:
            d = d[k]
        d[keys[-1]] += n
