"""Checkpoint / inference-model IO — the port of ``paddle_tpu/fluid/io.py``.

Analog of python/paddle/v2/fluid/io.py (save_vars:66, save_params:129,
save_persistables:142, load_*:156-232, save_inference_model:297,
load_inference_model:370) and the C++ stream serialization in
operators/save_op.cc / load_op.cc.

The files are the reference's, byte for byte, so an artifact written by
either package loads in the other.  Tensor wire format: a JSON header
line {dtype, shape, lod} followed by the raw little-endian bytes (the
int32 lengths appended for a SeqArray); combine files stack entries
behind a manifest; ``frame_bytes`` puts a magic before and a CRC32 of
the payload after.  A scope value is read by its bits: a tensor on the
card is copied to the host (after the step that wrote it: the copy
waits for the card's stream), a bfloat16 tensor is written as its
16-bit patterns under a ``"bfloat16"`` header, and a ``"bfloat16"`` file
loads as a CPU ``torch.bfloat16`` tensor (an ``ml_dtypes`` array, as
the reference writes it, is taken by its bits too), so no ``ml_dtypes``
is needed either way.  Every other dtype loads as a numpy array, which
the executor uploads at the first step that reads it.

Durability (reference go/pserver/service.go:119-175): every file is
written to a temp name, fsynced, then ``os.replace``d, and its directory
fsynced; a torn or corrupted file fails its CRC (``CheckpointCorrupt``).

``export_stablehlo`` (the reference's StableHLO export for a native
PJRT runner) has no counterpart here and raises: ``torch.export`` cannot
capture a program whose ``While`` reads its condition on the host each
iteration (ROADMAP A10).
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from .core.desc import OpDesc
from .core.lod import SeqArray
from .executor import Executor, Scope, global_scope
from .framework import Parameter, Program, Variable, default_main_program

__all__ = ["save_tensor", "load_tensor", "save_tensors", "load_tensors",
           "save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_inference_model",
           "load_inference_model", "merge_inference_model",
           "get_inference_program", "device_put_persistables",
           "model_version_dir", "list_model_versions",
           "publish_model_version", "save_versioned_inference_model",
           "set_current_version", "current_model_version",
           "CheckpointCorrupt", "prune_program", "frame_bytes",
           "unframe_bytes", "tensor_to_bytes", "tensor_from_bytes",
           "export_stablehlo"]

_MAGIC = b"PDTPU\x01"      # legacy: no checksum
_MAGIC2 = b"PDTPU\x02"     # payload followed by crc32 trailer


class CheckpointCorrupt(Exception):
    """A tensor file failed its CRC32 check (torn/partial write)."""


def _fsync_dir(dirname: str) -> None:
    """Persist the rename itself: without fsyncing the directory entry a
    power loss can roll back os.replace after the caller saw success."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:  # platforms/filesystems without dir fsync
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: str, payload: bytes) -> None:
    """tmp + fsync + os.replace + dir fsync (service.go:119-175 writes
    .tmp then renames)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(d)


def _read_checked(path: str) -> bytes:
    """Read a tensor/combine file, verify magic + CRC; returns payload
    (the bytes after the magic, without the crc trailer)."""
    with open(path, "rb") as f:
        buf = f.read()
    return unframe_bytes(buf, path)


def _host_array(value):
    """A value's bits on the host -> (dtype name, shape, raw bytes): a
    tensor (on the card: copied over) as its elements, a bfloat16 one as
    its 16-bit patterns; a numpy array as it lies (an ``ml_dtypes``
    bfloat16 one by its bits)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return ("bfloat16", list(t.shape),
                    t.view(torch.int16).numpy().tobytes())
        value = t.numpy()
    data = np.asarray(value)
    return data.dtype.name, list(data.shape), data.tobytes()


def _array_from(raw: bytes, dtype: str, shape):
    """``_host_array``'s inverse: a numpy array of its own, or for
    ``"bfloat16"`` a CPU ``torch.bfloat16`` tensor of its own."""
    if dtype == "bfloat16":
        bits = np.frombuffer(raw, np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def _tensor_bytes(value) -> bytes:
    if isinstance(value, SeqArray):
        dtype, shape, raw = _host_array(value.data)
        lengths = value.lengths
        if isinstance(lengths, torch.Tensor):
            lengths = lengths.detach().cpu().numpy()
        lengths = np.asarray(lengths, np.int32)
        header = {"dtype": dtype, "shape": shape,
                  "lod": True, "batch": int(lengths.shape[0])}
        hb = json.dumps(header).encode()
        return struct.pack("<I", len(hb)) + hb + raw + lengths.tobytes()
    dtype, shape, raw = _host_array(value)
    header = {"dtype": dtype, "shape": shape, "lod": False}
    hb = json.dumps(header).encode()
    return struct.pack("<I", len(hb)) + hb + raw


def _tensor_from(buf: bytes, offset: int = 0):
    (hlen,) = struct.unpack_from("<I", buf, offset)
    offset += 4
    header = json.loads(buf[offset: offset + hlen].decode())
    offset += hlen
    shape, dtype = header["shape"], header["dtype"]
    n = int(np.prod(shape)) * (2 if dtype == "bfloat16"
                               else np.dtype(dtype).itemsize)
    data = _array_from(buf[offset: offset + n], dtype, shape)
    offset += n
    if header.get("lod"):
        ln = header["batch"] * 4
        lengths = np.frombuffer(buf[offset: offset + ln],
                                dtype=np.int32).copy()
        offset += ln
        return SeqArray(data, lengths), offset
    return data, offset


def frame_bytes(payload: bytes) -> bytes:
    """MAGIC2 + payload + crc32 trailer — the checkpoint wire framing."""
    crc = struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF)
    return _MAGIC2 + payload + crc


def unframe_bytes(data: bytes, what: str = "<bytes>") -> bytes:
    """Inverse of frame_bytes; raises CheckpointCorrupt on bad magic or
    CRC (legacy MAGIC1 passes through unchecked)."""
    if data[: len(_MAGIC2)] == _MAGIC2:
        payload, trailer = data[len(_MAGIC2): -4], data[-4:]
        (want,) = struct.unpack("<I", trailer)
        got = zlib.crc32(payload) & 0xFFFFFFFF
        if got != want:
            raise CheckpointCorrupt(
                f"{what}: crc mismatch (file {want:#x}, computed {got:#x})")
        return payload
    if data[: len(_MAGIC)] == _MAGIC:
        return data[len(_MAGIC):]
    raise CheckpointCorrupt(f"bad tensor data {what} (unknown magic)")


def tensor_to_bytes(value) -> bytes:
    """One tensor/SeqArray as a framed byte string."""
    return frame_bytes(_tensor_bytes(value))


def tensor_from_bytes(data: bytes, what: str = "<bytes>"):
    value, _ = _tensor_from(unframe_bytes(data, what), 0)
    return value


def save_tensor(value, path: str) -> None:
    _atomic_write(path, tensor_to_bytes(value))


def load_tensor(path: str):
    value, _ = _tensor_from(_read_checked(path), 0)
    return value


def save_tensors(named: Dict[str, object], path: str) -> None:
    """Combine-file variant (save_combine_op.cc)."""
    names = sorted(named)
    manifest = json.dumps(names).encode()
    payload = struct.pack("<I", len(manifest)) + manifest + b"".join(
        _tensor_bytes(named[n]) for n in names)
    _atomic_write(path, frame_bytes(payload))


def load_tensors(path: str) -> Dict[str, object]:
    buf = _read_checked(path)
    off = 0
    (mlen,) = struct.unpack_from("<I", buf, off)
    off += 4
    names = json.loads(buf[off: off + mlen].decode())
    off += mlen
    out = {}
    for n in names:
        out[n], off = _tensor_from(buf, off)
    return out


# -- program-level save/load (reference io.py:66-232) -----------------------

def _default_predicate(var: Variable) -> bool:
    return var.persistable


def save_vars(executor: Executor, dirname: str,
              main_program: Optional[Program] = None, vars=None,
              predicate=None, scope: Optional[Scope] = None) -> None:
    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        vars = [v for v in program.list_vars()
                if (predicate or _default_predicate)(v)]
    os.makedirs(dirname, exist_ok=True)
    for v in vars:
        val = scope.find_var(v.name)
        if val is None:
            continue
        save_tensor(val, os.path.join(dirname, v.name))


def save_params(executor, dirname, main_program=None, **kw):
    return save_vars(executor, dirname, main_program,
                     predicate=lambda v: isinstance(v, Parameter), **kw)


def save_persistables(executor, dirname, main_program=None, **kw):
    return save_vars(executor, dirname, main_program,
                     predicate=_default_predicate, **kw)


def load_vars(executor: Executor, dirname: str,
              main_program: Optional[Program] = None, vars=None,
              predicate=None, scope: Optional[Scope] = None) -> None:
    """Set each var's value from its file in ``dirname`` (host values:
    the executor uploads each at the next step that reads it, into the
    captured graph's buffer where there is one)."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        vars = [v for v in program.list_vars()
                if (predicate or _default_predicate)(v)]
    for v in vars:
        path = os.path.join(dirname, v.name)
        if os.path.exists(path):
            scope.set_var(v.name, load_tensor(path))


def load_params(executor, dirname, main_program=None, **kw):
    return load_vars(executor, dirname, main_program,
                     predicate=lambda v: isinstance(v, Parameter), **kw)


def load_persistables(executor, dirname, main_program=None, **kw):
    return load_vars(executor, dirname, main_program,
                     predicate=_default_predicate, **kw)


# -- inference packaging (reference io.py:297,370) --------------------------

def prune_program(program: Program, targets: List[Variable]) -> Program:
    """A copy of ``program`` (``clone(for_test=True)``) whose global
    block keeps only the ops ``targets`` need, as the reference's
    ``Program.prune`` slices it.  Training-only ops (those that touch an
    ``@GRAD`` var: every grad op and optimizer update) go first, unless
    a target is itself a gradient; then a backward walk keeps each op
    that writes a needed var and marks its inputs needed."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    needed = {t.name if isinstance(t, Variable) else str(t) for t in targets}
    want_grads = any(n.endswith("@GRAD") for n in needed)

    def touches_grad(od) -> bool:
        return any(n and n.endswith("@GRAD")
                   for ns in list(od.inputs.values())
                   + list(od.outputs.values()) for n in ns)

    descs = (block.desc.ops if want_grads else
             [od for od in block.desc.ops if not touches_grad(od)])
    keep = []
    for od in reversed(descs):
        outs = {n for ns in od.outputs.values() for n in ns}
        if outs & needed:
            keep.append(od)
            needed |= {n for ns in od.inputs.values() for n in ns if n}
    kept = {id(od) for od in keep}
    block.desc.ops = [od for od in block.desc.ops if id(od) in kept]
    block.ops = [op for op in block.ops if id(op.desc) in kept]
    pruned._bump_version()
    return pruned


def save_inference_model(dirname: str, feeded_var_names: List[str],
                         target_vars: List[Variable], executor: Executor,
                         main_program: Optional[Program] = None,
                         scope: Optional[Scope] = None,
                         export_stablehlo_module: bool = False,
                         stablehlo_batch_size: int = 1,
                         stablehlo_seq_len: int = 32) -> None:
    """reference io.py:297: prune to the inference slice, record feed /
    fetch ops, persist the program (``__model__``) and its parameters.
    ``export_stablehlo_module=True`` raises (``export_stablehlo``)."""
    if export_stablehlo_module:
        export_stablehlo(dirname, None, feeded_var_names,
                         [v.name for v in target_vars], scope=scope,
                         batch_size=stablehlo_batch_size,
                         seq_len=stablehlo_seq_len)
    program = main_program or default_main_program()
    pruned = prune_program(program, target_vars)
    block = pruned.global_block()
    for i, name in enumerate(feeded_var_names):
        block.desc.prepend_op(OpDesc("feed", {"X": [name]}, {"Out": [name]},
                                     {"col": i}))
    for i, v in enumerate(target_vars):
        block.desc.append_op(OpDesc("fetch", {"X": [v.name]},
                                    {"Out": [v.name]}, {"col": i}))
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "__model__"), "wb") as f:
        f.write(pruned.serialize_to_string())
    save_persistables(executor, dirname, program, scope=scope)


_MERGED_MAGIC = b"PTPUMRG1"


def merge_inference_model(dirname: str, out_path: str) -> None:
    """Pack a save_inference_model directory into one file (the
    reference's merged-model container, trainer/MergeModel.cpp): magic,
    u64 entry count, then per entry [u32 name_len][name][u64
    data_len][data]; an entry's bytes are the file's bytes as they lie
    on disk (tensor entries keep their CRC framing)."""
    names = sorted(n for n in os.listdir(dirname)
                   if os.path.isfile(os.path.join(dirname, n))
                   and not n.startswith("model.stablehlo"))
    if "__model__" not in names:
        raise ValueError(f"{dirname} is not a save_inference_model "
                         f"directory (no __model__)")
    payload = [_MERGED_MAGIC, struct.pack("<Q", len(names))]
    for name in names:
        with open(os.path.join(dirname, name), "rb") as f:
            data = f.read()
        nb = name.encode()
        payload += [struct.pack("<I", len(nb)), nb,
                    struct.pack("<Q", len(data)), data]
    _atomic_write(out_path, b"".join(payload))


def load_inference_model(dirname: str, executor: Executor,
                         scope: Optional[Scope] = None,
                         to_device: bool = False):
    """reference io.py:370 -> (program, feed_names, fetch_targets).
    ``to_device=True`` puts every loaded persistable on ``executor``'s
    device now (``device_put_persistables``), so no request pays the
    upload."""
    with open(os.path.join(dirname, "__model__"), "rb") as f:
        program = Program.parse_from_string(f.read())
    block = program.global_block()
    feed_names = [op.input("X")[0] for op in block.desc.ops
                  if op.type == "feed"]
    fetch_names = [op.output("Out")[0] for op in block.desc.ops
                   if op.type == "fetch"]
    load_persistables(executor, dirname, program, scope=scope)
    if to_device:
        device_put_persistables(scope or global_scope(), program,
                                device=executor.device)
    fetch_vars = [block.vars[n] for n in fetch_names]
    return program, feed_names, fetch_vars


def device_put_persistables(scope: Scope,
                            program: Optional[Program] = None,
                            device=None) -> int:
    """Put every host value in ``scope`` (a numpy array, a CPU tensor, a
    SeqArray of them) on ``device`` (the card by default) — restricted
    to ``program``'s persistables when one is given.  The one
    implementation behind ``load_inference_model(to_device=True)`` and
    ``serving.InferenceEngine.place_weights``; returns the number of
    values put.  On the CPU a CPU tensor stays as it is and counts
    nothing."""
    from ..device import resolve_device
    from .executor import _on_host, _to_device

    device = resolve_device(device)
    if program is not None:
        names = [v.name for v in program.list_vars() if v.persistable]
    else:
        names = list(scope.vars)
    n = 0
    for name in names:
        val = scope.find_var(name)
        if val is not None and _on_host(val, device):
            scope.set_var(name, _to_device(val, device))
            n += 1
    return n


# -- versioned artifact layout (the gateway's model store) ------------------

# staging dirs end with this suffix so an unpublished (possibly torn)
# artifact can never be mistaken for a version by list_model_versions
_STAGING_SUFFIX = ".staging.tmp"

# on-disk deploy marker: the last promoted version of a model, so a
# restart serves the last good version, not merely the newest on disk
CURRENT_MARKER = "CURRENT"


def model_version_dir(root: str, model_name: str, version: str) -> str:
    """``<root>/<model>/<version>/`` — one artifact per version."""
    return os.path.join(root, str(model_name), str(version))


def list_model_versions(root: str, model_name: str) -> List[str]:
    """Published versions on disk for ``model_name``, sorted (numeric
    versions numerically: v2 < v10); staging dirs (``*.tmp``) skipped."""
    base = os.path.join(root, str(model_name))
    if not os.path.isdir(base):
        return []

    def key(v: str):
        digits = "".join(c for c in v if c.isdigit())
        return (int(digits) if digits else 0, v)

    return sorted((d for d in os.listdir(base)
                   if os.path.isdir(os.path.join(base, d))
                   and not d.endswith(".tmp")), key=key)


def set_current_version(root: str, model_name: str, version: str) -> None:
    """Atomically mark ``version`` as the deployed one."""
    _atomic_write(os.path.join(root, str(model_name), CURRENT_MARKER),
                  str(version).encode())


def current_model_version(root: str, model_name: str) -> Optional[str]:
    """The marked deployed version, or None when no marker exists or it
    points at a version no longer on disk."""
    path = os.path.join(root, str(model_name), CURRENT_MARKER)
    try:
        with open(path, "r", encoding="utf-8") as f:
            version = f.read().strip()
    except OSError:
        return None
    if not version or not os.path.isdir(
            model_version_dir(root, model_name, version)):
        return None
    return version


def publish_model_version(root: str, model_name: str, version: str,
                          writer) -> str:
    """Crash-safe publish: ``writer(staging_dir)`` builds the artifact in
    an unpublished staging dir, every file is fsynced, then one atomic
    rename makes the version visible.  Stale staging dirs of crashed
    publishes are swept first; a re-publish moves the old version aside
    before the rename, never deleting it first.  Returns the published
    directory."""
    final = model_version_dir(root, model_name, version)
    base = os.path.dirname(final)
    os.makedirs(base, exist_ok=True)
    for name in os.listdir(base):
        if name.endswith(_STAGING_SUFFIX):
            shutil.rmtree(os.path.join(base, name), ignore_errors=True)
    staging = f"{final}.{os.getpid()}{_STAGING_SUFFIX}"
    os.makedirs(staging)
    try:
        writer(staging)
        for name in os.listdir(staging):
            path = os.path.join(staging, name)
            if not os.path.isfile(path):
                continue
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        _fsync_dir(staging)
        # chaos point: a seeded crash after the artifact is staged, before
        # it is published
        from ..resilience.chaos import injector

        injector().maybe_fail("io.publish")
        replaced = None
        if os.path.exists(final):
            replaced = f"{final}.{os.getpid()}.replaced{_STAGING_SUFFIX}"
            os.rename(final, replaced)
        os.rename(staging, final)          # atomic publish
        if replaced is not None:
            shutil.rmtree(replaced, ignore_errors=True)
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise
    _fsync_dir(base)
    return final


def save_versioned_inference_model(root: str, model_name: str,
                                   version: str,
                                   feeded_var_names: List[str],
                                   target_vars: List[Variable],
                                   executor: Executor,
                                   main_program: Optional[Program] = None,
                                   scope: Optional[Scope] = None,
                                   manifest: Optional[Dict] = None) -> str:
    """``save_inference_model`` into the versioned layout through the
    staged publish; ``manifest`` (``gateway.json``) rides inside the same
    publish.  Returns the artifact directory."""

    def writer(staging: str) -> None:
        save_inference_model(staging, feeded_var_names, target_vars,
                             executor, main_program=main_program,
                             scope=scope)
        if manifest is not None:
            with open(os.path.join(staging, "gateway.json"), "w",
                      encoding="utf-8") as f:
                json.dump(manifest, f, indent=1)

    return publish_model_version(root, model_name, version, writer)


def get_inference_program(target_vars, main_program=None):
    program = main_program or default_main_program()
    if not isinstance(target_vars, (list, tuple)):
        target_vars = [target_vars]
    return prune_program(program, target_vars)


def export_stablehlo(dirname: str, program, feed_names, fetch_names,
                     scope=None, batch_size: int = 1,
                     seq_len: int = 32) -> None:
    """The reference's StableHLO export for its native PJRT runner: no
    counterpart on the card (``torch.export`` cannot capture a program
    whose ``While`` reads the host every iteration; ROADMAP A10)."""
    raise NotImplementedError(
        "io.export_stablehlo (a StableHLO module for the reference's "
        "native PJRT runner) has no counterpart in paddle_tpu_torch "
        "(ROADMAP Queue A10)")
