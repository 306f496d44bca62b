"""Build and load the port's CUDA kernels.

Each kernel source under ``kernels/csrc/`` (with the ``*.cuh`` headers
beside it) is compiled by ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
build happens at first use, from the sources in the checkout, into
``kernels/build/`` (listed in ``.gitignore``); the library's file name
carries a hash of the source, the headers and the flags, so an edited source is never
served a stale library.  Nothing is built or imported when this module
is imported: the CPU tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["NVCC_FLAGS", "build_all", "load_library", "nvcc_path"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# route (b) of the port's kernel guide: sm_90a keeps wgmma/setmaxnreg
# available to later versions; -Xptxas -v reports registers, shared
# memory and spills into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def _target(name: str) -> Path:
    # the shared headers count too: an edited header rebuilds every source
    parts = [(CSRC_DIR / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library yet,
    one ``nvcc`` per source, all started together.  Raises RuntimeError
    with the compiler's output when a build fails.  Returns
    ``{name: library path}``; each build's log (ptxas register and
    shared-memory report) sits beside its library as ``<lib>.log``."""
    names = list(names)
    out = {n: _target(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        lib = todo[n]
        lib.with_name(lib.name + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)          # atomic: a reader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _libs[name] = lib
        return lib
