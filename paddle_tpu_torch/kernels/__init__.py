"""Kernels of the port.  ``flash_attention.ragged_decode_attention`` is
the serving path's paged attention: a CUDA C++ kernel for ``sm_90a``
(``csrc/ragged_paged_attention.cu``, built by ``_build``) on CUDA tensors,
its plain PyTorch version on CPU tensors.

Each wrapper counts its launches on a plain attribute of its function.
``launch_counts`` reads them all as one flat dict and ``add_launches``
adds such a dict back: the executor uses the pair to take the launches
that a CUDA graph capture records (and does not run) out of the counts,
and to add them at every replay of the graph.  ``libraries_of`` names
the built libraries (``_build``) behind the counters that such a dict
moves: the compile cache stores those beside a step's record.  The
counters are also a scrape-time series, ``paddle_kernel_launches_total``
by kernel, so a process serving over HTTP (a fleet replica) reports its
launches on ``/metrics``."""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

from ..observability.metrics import Sample, registry

__all__ = ["launch_counts", "add_launches", "libraries_of"]

# (module, wrapper, attribute) of every launch counter: an int, or a dict
# of ints, or a dict of such dicts
_COUNTERS = (("flash_attention", "flash_attention", "launches"),
             ("flash_attention", "flash_attention", "launches_by_dtype"),
             ("flash_attention", "ragged_decode_attention", "launches"),
             ("lstm", "lstm_forward", "launches"),
             ("lstm", "lstm_forward", "launches_by_dtype"))


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


def libraries_of(delta: Dict[Tuple, int]) -> Tuple[str, ...]:
    """The kernel libraries whose launches ``delta`` (a
    ``launch_counts``-shaped dict of differences) counts, sorted."""
    fa = importlib.import_module(f"{__name__}.flash_attention")
    lk = importlib.import_module(f"{__name__}.lstm")
    # (module, wrapper) -> the library its launches run, or, for a
    # counter keyed by kernel, {key: library}
    library = {("flash_attention", "ragged_decode_attention"):
               fa.KERNEL_NAME,
               ("flash_attention", "flash_attention"): fa.FLASH_KERNELS,
               ("lstm", "lstm_forward"): lk.KERNEL_NAME}
    out = set()
    for (mod, fn, attr, *keys), n in delta.items():
        lib = library.get((mod, fn))
        if not n or lib is None or attr != "launches":
            continue
        out.add(lib[keys[0]] if isinstance(lib, dict) else lib)
    return tuple(sorted(out))


def _collect_launches():
    """The ``launches`` counters as ``paddle_kernel_launches_total``
    samples, one a kernel (``ragged_decode_attention``,
    ``flash_attention_fwd`` / ``_dq`` / ``_dkv``, ``lstm_forward``)."""
    for (mod, fn, attr, *keys), n in launch_counts().items():
        if attr != "launches":
            continue
        kernel = "_".join([fn] + [str(k) for k in keys])
        yield Sample("paddle_kernel_launches_total", "counter",
                     (("kernel", kernel),), float(n),
                     "Launches of this repo's CUDA kernels (CUDA path)")


registry().register_collector(_collect_launches)
