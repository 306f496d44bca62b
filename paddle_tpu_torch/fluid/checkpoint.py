"""Periodic training checkpoints with crash recovery — the port of
``paddle_tpu/fluid/checkpoint.py``, host logic line for line.

Analog of the reference's fault-tolerance checkpointing:
go/pserver/service.go:119-175 (periodic parameter checkpoint: write tmp
file, CRC, atomic rename, LoadCheckpoint on restart) and
go/master/service.go:166-207 (snapshot/recover).  The meta record is a
`latest` marker file updated by atomic rename, and recovery scans
backward through retained checkpoints until one passes its checks.

META records a per-tensor sha256 of every file's on-disk bytes, and
restore verifies them before loading anything.  This is not redundant
with the framed per-file CRC: legacy MAGIC1 tensor files pass through
``unframe_bytes`` unchecked, and a corruption that rewrites a whole
file consistently yields a self-consistent frame with wrong bytes —
only a checksum recorded elsewhere at save time catches either.  A
mismatch falls back to the previous snapshot.

Two managers share the same durable state-dir format
(``_write_state_dir`` / ``_load_state_dir``), whose files are the
reference's (``io.tensor_to_bytes``), so either package restores the
other's checkpoints:

* ``CheckpointManager`` — single-process: persistables of a Program
  published per step by atomic dir rename.
* ``PodCheckpointManager`` — every rank stages its state under one
  step-stamped manifest (``pod-<step>/rank-<r>/``), a ``COMMIT`` marker
  is written only after all ranks staged, and recovery restores the
  newest committed manifest; a torn manifest never commits.

A scope tensor on the card is copied to the host after the step that
wrote it (``io``); a restored value is a host value that replaces the
scope's var (``set_var``), so the executor's next step uploads it into
the captured graph's buffer.  As in the reference, no RNG state is
saved: a resumed program with a random op draws from the scope's own
step counter.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Dict, Optional, Tuple

from . import io as fio
from .executor import Scope, global_scope
from .framework import Program

__all__ = ["CheckpointManager", "PodCheckpointManager"]

_CKPT_PREFIX = "ckpt-"
_POD_PREFIX = "pod-"


# -- the shared durable state-dir format --------------------------------------

def _write_durable(path: str, payload: bytes) -> None:
    # plain write + explicit fsync: inside an unpublished tmp dir the
    # per-file tmp+rename dance of _atomic_write buys nothing (nobody
    # reads tmp), but the fsync is load-bearing — the publish rename
    # must never land before the tensor bytes it names are on the
    # platter, or a crash right after publish leaves a "complete"
    # checkpoint whose files are torn (the CRC catches it, but the
    # previous checkpoint may already be pruned)
    with open(path, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())


def _write_state_dir(tmp: str, items, extra_meta: Optional[dict] = None
                     ) -> dict:
    """Serialize ``items`` ((name, tensor/ndarray) pairs) into ``tmp``
    with durable writes, then write META.json recording names AND a
    sha256 of each file's exact on-disk bytes.  (NOT crc32 of the
    framed file: a frame ends with the crc of its own payload, and
    crc32(payload + crc32(payload)) is a fixed residue — the same
    value for EVERY framed file, which would verify nothing.)  Returns
    the meta dict; the caller owns the publish (atomic rename) of
    ``tmp``."""
    names, checksums = [], {}
    for name, value in items:
        payload = fio.tensor_to_bytes(value)
        _write_durable(os.path.join(tmp, name), payload)
        names.append(name)
        checksums[name] = hashlib.sha256(payload).hexdigest()
    meta = {"names": names, "checksums": checksums, "time": time.time()}
    meta.update(extra_meta or {})
    _write_durable(os.path.join(tmp, "META.json"),
                   json.dumps(meta).encode())
    # every file is fsynced; now persist their directory ENTRIES before
    # any rename makes them reachable under a published name
    fio._fsync_dir(tmp)
    return meta


def _load_state_dir(d: str) -> Optional[Tuple[dict, Dict[str, object]]]:
    """Load a state dir written by ``_write_state_dir``: returns
    ``(meta, {name: value})`` or None when anything is missing, fails
    its framed CRC, or fails the META-recorded checksum (the bugfix: a
    bit-flipped or consistently-rewritten tensor file must force the
    caller to an older snapshot, not load silently)."""
    meta_path = os.path.join(d, "META.json")
    try:
        with open(meta_path, "rb") as f:
            meta = json.loads(f.read())
    except (OSError, ValueError):
        return None
    checksums = meta.get("checksums") or {}
    loaded = {}
    try:
        for name in meta["names"]:
            with open(os.path.join(d, name), "rb") as f:
                payload = f.read()
            want = checksums.get(name)
            if want is not None \
                    and hashlib.sha256(payload).hexdigest() != want:
                raise fio.CheckpointCorrupt(
                    f"{d}/{name}: META checksum mismatch")
            loaded[name] = fio.tensor_from_bytes(payload,
                                                 what=f"{d}/{name}")
    except (fio.CheckpointCorrupt, OSError, KeyError):
        return None
    return meta, loaded


class CheckpointManager:
    """Save/restore the persistable state of a training program.

    save(step) every `save_interval_steps` (or unconditionally via
    force=True); keeps the newest `max_to_keep` checkpoints; `restore()`
    loads the newest valid one (CRC + META checksums verified) and
    returns its step, or None when no usable checkpoint exists.
    """

    def __init__(self, dirname: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self.dirname = dirname
        self.max_to_keep = max(1, int(max_to_keep))
        self.save_interval_steps = max(1, int(save_interval_steps))
        os.makedirs(dirname, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _ckpt_dir(self, step: int) -> str:
        return os.path.join(self.dirname, f"{_CKPT_PREFIX}{step}")

    def _steps_on_disk(self):
        steps = []
        for name in os.listdir(self.dirname):
            if name.startswith(_CKPT_PREFIX) and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[len(_CKPT_PREFIX):]))
                except ValueError:
                    continue
        return sorted(steps)

    # -- save ----------------------------------------------------------------
    def should_save(self, step: int) -> bool:
        return step % self.save_interval_steps == 0

    def save(self, step: int, program: Optional[Program] = None,
             scope: Optional[Scope] = None, force: bool = False) -> bool:
        """Checkpoint persistables at `step`; returns True if written."""
        if not force and not self.should_save(step):
            return False
        from .framework import default_main_program

        program = program or default_main_program()
        scope = scope or global_scope()
        final = self._ckpt_dir(step)
        tmp = f"{final}.{os.getpid()}.tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        def persistables():
            for v in program.list_vars():
                if not v.persistable:
                    continue
                val = scope.find_var(v.name)
                if val is not None:
                    yield v.name, val

        meta = _write_state_dir(tmp, persistables(),
                                extra_meta={"step": int(step)})
        names = meta["names"]
        if os.path.exists(final):          # re-checkpoint of same step
            shutil.rmtree(final)
        os.rename(tmp, final)              # atomic publish
        fio._fsync_dir(self.dirname)
        if names:
            # chaos harness: an injected torn write right after publish
            # (inert unless configured) — restore() must fall back to
            # the previous CRC-valid checkpoint
            from ..resilience.chaos import injector

            injector().maybe_truncate(os.path.join(final, names[0]))
        # marker makes restore O(1) in the common case
        fio._atomic_write(os.path.join(self.dirname, "latest"),
                          str(int(step)).encode())
        self._prune()
        return True

    def _prune(self):
        steps = self._steps_on_disk()
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(self._ckpt_dir(s), ignore_errors=True)
        # GC tmp dirs orphaned by crashed saves (any pid — a dead writer
        # never comes back for them; a live concurrent writer would be
        # mid-rename, but concurrent savers are unsupported anyway)
        for name in os.listdir(self.dirname):
            if name.endswith(".tmp") and name.startswith(_CKPT_PREFIX):
                shutil.rmtree(os.path.join(self.dirname, name),
                              ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def _try_restore(self, step: int, program: Program,
                     scope: Scope) -> bool:
        out = _load_state_dir(self._ckpt_dir(step))
        if out is None:
            return False
        _, loaded = out
        for name, val in loaded.items():
            scope.set_var(name, val)
        return True

    def latest_step(self) -> Optional[int]:
        marker = os.path.join(self.dirname, "latest")
        if os.path.exists(marker):
            try:
                return int(open(marker).read().strip())
            except ValueError:
                pass
        steps = self._steps_on_disk()
        return steps[-1] if steps else None

    def restore(self, program: Optional[Program] = None,
                scope: Optional[Scope] = None) -> Optional[int]:
        """Load the newest valid checkpoint (skipping corrupt ones, like
        pserver's LoadCheckpoint CRC check); returns its step or None."""
        from .framework import default_main_program

        program = program or default_main_program()
        scope = scope or global_scope()
        # newest first — a fully-published checkpoint beats a stale
        # `latest` marker (save() can crash between publish and marker)
        for step in sorted(self._steps_on_disk(), reverse=True):
            if self._try_restore(step, program, scope):
                return step
        return None


class PodCheckpointManager:
    """Coordinated multi-rank pod snapshots on a shared directory.

    Layout (one manifest per step)::

        <dirname>/pod-<step>/rank-0/       (META.json + tensor files)
        <dirname>/pod-<step>/rank-1/
        <dirname>/pod-<step>/COMMIT        (only when ALL ranks staged)

    Protocol (the barrier lives in parallel/coordinator.py):
    every rank calls :meth:`stage` (durable write into a tmp dir, then
    atomic rename to ``rank-<r>``), reports through the coordinator's
    staged barrier, and rank 0 calls :meth:`commit` only once the
    barrier says all ranks fsynced.  :meth:`restore` considers ONLY
    committed manifests, newest first, and checksum-verifies the rank
    dir before handing anything back — a torn manifest (a rank
    SIGKILLed mid-stage) never commits and is skipped whole.

    Deals in plain state dicts (name -> ndarray); the trainer adapts
    Program/Scope to and from them.  Params are replicated across the
    dp pod, so a re-rendezvoused world of a different size restores any
    committed rank copy (rank r reads ``rank-(r % committed_world)``).
    """

    def __init__(self, dirname: str, max_to_keep: int = 3):
        self.dirname = dirname
        self.max_to_keep = max(1, int(max_to_keep))
        os.makedirs(dirname, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _manifest_dir(self, step: int) -> str:
        return os.path.join(self.dirname, f"{_POD_PREFIX}{step}")

    def _steps_on_disk(self):
        steps = []
        for name in os.listdir(self.dirname):
            if name.startswith(_POD_PREFIX) and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[len(_POD_PREFIX):]))
                except ValueError:
                    continue
        return sorted(steps)

    def _is_committed(self, step: int) -> bool:
        return os.path.exists(
            os.path.join(self._manifest_dir(step), "COMMIT"))

    def committed_steps(self):
        return [s for s in self._steps_on_disk() if self._is_committed(s)]

    # -- stage / commit ------------------------------------------------------
    def stage(self, step: int, rank: int, world: int,
              items: Dict[str, object]) -> str:
        """Durably write this rank's state under the step's manifest.
        Returns the published rank-dir path.  Safe to re-stage (a rank
        retrying after a transport hiccup just replaces its dir); the
        manifest stays uncommitted until :meth:`commit`."""
        manifest = self._manifest_dir(step)
        os.makedirs(manifest, exist_ok=True)
        final = os.path.join(manifest, f"rank-{int(rank)}")
        tmp = f"{final}.{os.getpid()}.tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        _write_state_dir(tmp, sorted(items.items()),
                         extra_meta={"step": int(step),
                                     "rank": int(rank),
                                     "world": int(world)})
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        fio._fsync_dir(manifest)
        # chaos: a torn post-publish write — commit-time verification
        # and restore-time checksums must both route around it
        from ..resilience.chaos import injector

        meta = json.load(open(os.path.join(final, "META.json")))
        if meta["names"]:
            injector().maybe_truncate(
                os.path.join(final, meta["names"][0]),
                point="ckpt.truncate")
        return final

    def commit(self, step: int, world: int) -> bool:
        """Write the COMMIT marker — call ONLY after the coordinator's
        staged barrier confirmed every rank fsynced.  Re-verifies that
        rank dirs 0..world-1 exist with META before marking; idempotent
        (any rank may call; identical content).  Returns True when the
        marker is (now) present."""
        manifest = self._manifest_dir(step)
        if self._is_committed(step):
            return True
        for r in range(int(world)):
            if not os.path.exists(os.path.join(manifest, f"rank-{r}",
                                               "META.json")):
                return False
        fio._atomic_write(
            os.path.join(manifest, "COMMIT"),
            json.dumps({"step": int(step), "world": int(world),
                        "time": time.time()}).encode())
        fio._fsync_dir(manifest)
        self._prune()
        return True

    def latest_committed(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def _prune(self):
        committed = self.committed_steps()
        for s in committed[: -self.max_to_keep]:
            shutil.rmtree(self._manifest_dir(s), ignore_errors=True)
        if committed:
            # uncommitted manifests older than the newest committed one
            # are abandoned stages (their epoch is gone); newer ones may
            # still be mid-barrier — leave them alone
            for s in self._steps_on_disk():
                if s < committed[-1] and not self._is_committed(s):
                    shutil.rmtree(self._manifest_dir(s),
                                  ignore_errors=True)
        for name in os.listdir(self.dirname):
            d = os.path.join(self.dirname, name)
            if not os.path.isdir(d):
                continue
            for sub in os.listdir(d):
                if sub.endswith(".tmp") and sub.startswith("rank-"):
                    shutil.rmtree(os.path.join(d, sub),
                                  ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, rank: int
                ) -> Optional[Tuple[int, Dict[str, object]]]:
        """Load this rank's state from the newest committed manifest
        whose copy verifies; falls back to older committed manifests on
        checksum failure.  Returns ``(step, state_dict)`` or None.
        Uncommitted (torn) manifests are never considered."""
        for step in sorted(self.committed_steps(), reverse=True):
            manifest = self._manifest_dir(step)
            try:
                commit = json.load(
                    open(os.path.join(manifest, "COMMIT")))
                world = int(commit["world"])
            except (OSError, ValueError, KeyError):
                continue
            # params are replicated: any committed rank copy is valid
            # for any new rank, so try our modulo copy then the rest
            order = [int(rank) % world] + [r for r in range(world)
                                           if r != int(rank) % world]
            for r in order:
                out = _load_state_dir(
                    os.path.join(manifest, f"rank-{r}"))
                if out is not None:
                    return step, out[1]
        return None
