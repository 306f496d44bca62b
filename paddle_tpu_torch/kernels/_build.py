"""Build and load the port's CUDA kernels.

Each kernel source under ``kernels/csrc/`` (with the ``*.cuh`` headers
beside it) is compiled by ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
build happens at first use, from the sources in the checkout, into
``kernels/build/`` (listed in ``.gitignore``); the library's file name
carries a hash of the source, the headers and the flags, so an edited source is never
served a stale library.  Nothing is built or imported when this module
is imported: the CPU tests import every module of the package.

The nvcc build is the port's one true compile, so the built libraries are
what a model artifact ships (``fluid/compile_cache.py``): a compile
cache's directory holds checksummed copies (``lib<name>-<digest>.so``
framed as ``<file>.klib``), and ``mount`` adds such a directory to the
places ``load_library`` looks before it runs ``nvcc``.  Which path a
library takes is the plain function ``library_plan``: already built
(``"built"``), restored from a mounted cache (``"cache"``), or compiled
(``"nvcc"``).  A copy whose checksum, size or name does not match is
never loaded: the library is built and the copy overwritten by the next
store.  ``stats`` counts nvcc builds and cache restores in this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from ..utils.sync import RANK_NATIVE_BUILD, OrderedLock

__all__ = ["NVCC_FLAGS", "build_all", "load_library", "nvcc_path",
           "library_plan", "mount", "has_library", "store_library",
           "restore_library", "source_digests", "atomic_write", "stats"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# route (b) of the port's kernel guide: sm_90a keeps wgmma/setmaxnreg
# available to later versions; -Xptxas -v reports registers, shared
# memory and spills into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# a library copy in a compile cache: magic, one JSON header line, the
# library's bytes
LIB_MAGIC = b"PDLKLIB1\n"
LIB_SUFFIX = ".klib"

_lock = OrderedLock("native.build", RANK_NATIVE_BUILD)
_libs: Dict[str, ctypes.CDLL] = {}
_mounts: List[str] = []
# this process's library builds and restores (chip_smoke's warm-start
# check reads them: a warm restart builds nothing)
stats = {"nvcc_builds": 0, "cache_restores": 0, "cache_rejects": 0}


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


def _digest(name: str) -> str:
    # the shared headers count too: an edited header rebuilds every source
    parts = [(CSRC_DIR / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh"))]
    return hashlib.sha256(b"".join(parts)
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def source_digests() -> Dict[str, str]:
    """``{kernel name: digest}`` of every source under ``csrc/`` (the
    digest in its library's file name): the compile cache salts its
    keys with them."""
    return {p.stem: _digest(p.stem) for p in sorted(CSRC_DIR.glob("*.cu"))}


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
        stats["nvcc_builds"] += 1
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


# -- library copies in compile caches ----------------------------------------
def mount(dirname: str) -> None:
    """Add a compile cache's directory to the places ``load_library``
    looks for a library before it runs ``nvcc`` (idempotent; the first
    mounted is searched first)."""
    d = str(dirname)
    with _lock:
        if d not in _mounts:
            _mounts.append(d)


def library_plan(name: str, caches: Iterable[str] = ()
                 ) -> Tuple[str, Path]:
    """Where kernel ``name``'s library comes from: ``("built", path)``
    when ``kernels/build/`` holds it, else ``("cache", copy)`` for the
    first of ``caches`` that holds a copy of the same digest, else
    ``("nvcc", path)``: it must be compiled."""
    target = _target(name)
    if target.exists():
        return "built", target
    for d in caches:
        copy = Path(d) / (target.name + LIB_SUFFIX)
        if copy.is_file():
            return "cache", copy
    return "nvcc", target


def _checked_library(raw: bytes, file_name: str) -> Optional[bytes]:
    """The library bytes of one copy, or None when its magic, header,
    name, size or checksum do not match."""
    if not raw.startswith(LIB_MAGIC):
        return None
    try:
        end = raw.index(b"\n", len(LIB_MAGIC))
        header = json.loads(raw[len(LIB_MAGIC):end].decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None
    blob = raw[end + 1:]
    if header.get("file") != file_name or \
            header.get("bytes") != len(blob) or \
            header.get("sha256") != hashlib.sha256(blob).hexdigest():
        return None
    return blob


def atomic_write(path: Path, data: bytes) -> None:
    """tmp file in the same directory (named by process AND thread: two
    writers of one path never share a tmp file), fsync, atomic rename:
    a reader sees the old file or the new one, never a torn one."""
    path = Path(path)
    tmp = path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        tmp.unlink(missing_ok=True)
        raise


def restore_library(name: str, copy: Path) -> bool:
    """Verify the cached ``copy`` of kernel ``name``'s library and write
    it into ``kernels/build/`` under its own name; False (nothing
    written) when the copy is unreadable or fails its check."""
    target = _target(name)
    try:
        raw = Path(copy).read_bytes()
    except OSError:
        return False
    blob = _checked_library(raw, target.name)
    if blob is None:
        stats["cache_rejects"] += 1
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    atomic_write(target, blob)
    stats["cache_restores"] += 1
    return True


def has_library(name: str, dirname: str) -> bool:
    """True when ``dirname`` holds a sound copy of ``name``'s library
    (the digest of the sources in this checkout)."""
    target = _target(name)
    try:
        raw = (Path(dirname) / (target.name + LIB_SUFFIX)).read_bytes()
    except OSError:
        return False
    return _checked_library(raw, target.name) is not None


def store_library(name: str, dirname: str) -> int:
    """Copy kernel ``name``'s built library into the cache directory
    ``dirname`` (checksummed, atomically renamed); returns the bytes
    written, 0 when a sound copy is already there or nothing is built."""
    target = _target(name)
    if not target.exists() or has_library(name, dirname):
        return 0
    blob = target.read_bytes()
    header = json.dumps({"file": target.name, "bytes": len(blob),
                         "sha256": hashlib.sha256(blob).hexdigest()},
                        sort_keys=True, separators=(",", ":")).encode()
    raw = LIB_MAGIC + header + b"\n" + blob
    os.makedirs(dirname, exist_ok=True)
    atomic_write(Path(dirname) / (target.name + LIB_SUFFIX), raw)
    return len(raw)


def _resolve(name: str, caches: Iterable[str]) -> Path:
    """The built library of ``name``: as it is, restored from the first
    of ``caches`` whose copy passes its check, or compiled."""
    target = _target(name)
    if target.exists():
        return target
    for d in caches:
        copy = Path(d) / (target.name + LIB_SUFFIX)
        if copy.is_file() and restore_library(name, copy):
            return target
    return build_all([name])[name]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``: from ``kernels/build/``,
    restored from a mounted compile cache, or built first."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_resolve(name, tuple(_mounts))))
            _libs[name] = lib
        return lib
