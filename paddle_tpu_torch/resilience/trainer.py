"""ResilientTrainer — the crash-safe training driver; the port of
``paddle_tpu/resilience/trainer.py``.

Composes the two state halves the repo already had into the *behavior*
the reference got from its Go master + pserver loop: `CheckpointManager`
(CRC'd parameter checkpoints, fluid/checkpoint.py) for model state and
the TaskQueue worker protocol (parallel/master.py, served cross-process
by MasterServer/MasterClient) for data position.  A SIGKILLed run,
restarted with the same checkpoint dir and master address, resumes from
the newest *valid* checkpoint while the master re-dispatches its expired
leases — no coordination beyond the two artifacts that already exist.

run() drives the lease loop itself (rather than through master_reader)
because lease settlement must distinguish three exits with different
accounting:

  * chunk exhausted           -> force-checkpoint, then task_finished
                                 (once the master records a chunk done
                                 its records never re-deliver, so the
                                 steps they trained must be durable
                                 FIRST or a crash in the gap loses them)
  * read_chunk or train_step  -> task_failed + re-raise (failure charged,
    raised                       so a poison chunk hits failure_max and
                                 is eventually discarded instead of
                                 crash-looping the worker forever)
  * max_steps reached         -> task_returned          (uncharged: a
    mid-chunk                    deliberate stop is not a failure and
                                 must not erode the budget)

Delivery is at-least-once (see master_reader): records of a chunk whose
lease expired mid-read are re-delivered on restart, and optimizer steps
since the last checkpoint re-run.  Keep `save_interval_steps` small
relative to chunk size if duplicated steps matter.

Pod (multi-host) mode
---------------------
The reference's ``coordinator=PodClient(...)`` switches run() to an
elastic multi-host loop over ``parallel/coordinator.py``, which is not
ported (ROADMAP A16): passing ``coordinator=`` raises
``NotImplementedError``.  ``fluid.checkpoint.PodCheckpointManager``,
the pod loop's snapshot store, is ported on its own.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

from ..fluid.checkpoint import CheckpointManager
from ..parallel.master import master_reader

__all__ = ["ResilientTrainer"]


class ResilientTrainer:
    """Drive `train_step` over an elastic task queue with periodic
    checkpoints and restart-time recovery.

    Parameters
    ----------
    checkpoint_dir: CheckpointManager directory (shared across restarts).
    queue: a TaskQueue or MasterClient — anything speaking the worker
        protocol (get_task/task_finished/task_failed/task_returned/
        all_done).
    read_chunk: chunk -> iterable of records (same contract as
        master_reader).
    program / scope: what to checkpoint; default main program and global
        scope when None (resolved at save/restore time).
    prefetch: when > 0, read each chunk's records on a background
        thread that many records ahead of train_step (the input half of
        the async pipeline; read errors still surface at the consuming
        next() and settle the lease as task_failed).
    guard / guard_executor: pass the GuardPolicy the train_step runs
        under (``exe.run(..., guard=policy)``) plus that Executor, and
        the trainer closes the recovery loop: a NonFiniteEscalation
        (``escalate_after`` consecutive bad steps) is answered with
        ``CheckpointManager.restore()`` instead of crashing the worker
        (when no checkpoint exists yet the escalation propagates — a
        storm from step 0 must fail loudly, not drain the queue
        training on nothing), and every skip/rollback/escalation is
        appended to
        ``<checkpoint_dir>/guard.journal`` (JSON lines) — the durable
        record of which batches the run dropped.  Lease settlement is
        untouched: a skipped batch still advances the chunk, a raising
        policy still charges task_failed through the normal path.
    publisher / publish_every_steps: close the training half of the
        release loop: every ``publish_every_steps`` steps —
        and once more at the final step — ``publisher.publish(step,
        program, scope)`` emits the live parameters as a versioned
        candidate artifact (``lifecycle.CandidatePublisher`` /
        ``GeneratorPublisher``: save_versioned_inference_model under
        the crash-safe staged publish, optionally with an int8 PTQ
        manifest).  Publication is advisory — the release controller
        gates what serves — so a failed publish logs and training
        continues; the torn-artifact case is impossible by
        construction (the staged publish never exposes a partial
        version).
    coordinator / apply_update / state_get / state_set /
    rendezvous_deadline / step_deadline / heartbeat_interval: the
        reference's pod mode; ``coordinator=`` raises (module
        docstring), the others are accepted and unused.
    """

    def __init__(self, checkpoint_dir: str, queue=None, read_chunk=None,
                 *, program=None, scope=None, worker: str = "worker-0",
                 save_interval_steps: int = 1, max_to_keep: int = 3,
                 poll_interval: float = 0.05, prefetch: int = 0,
                 guard=None, guard_executor=None,
                 publisher=None, publish_every_steps: int = 0,
                 coordinator=None, apply_update=None,
                 state_get=None, state_set=None,
                 rendezvous_deadline: float = 120.0,
                 step_deadline: float = 120.0,
                 heartbeat_interval: float = 1.0):
        if coordinator is not None:
            raise NotImplementedError(
                "ResilientTrainer(coordinator=...): pod mode runs over "
                "parallel/coordinator.py, which is not ported to "
                "paddle_tpu_torch (ROADMAP A16); use lease mode (queue=)")
        self.manager = CheckpointManager(
            checkpoint_dir, max_to_keep=max_to_keep,
            save_interval_steps=save_interval_steps)
        if queue is None:
            raise ValueError("need a queue (lease mode)")
        self.queue = queue
        self.read_chunk = read_chunk
        self.program = program
        self.scope = scope
        self.worker = worker
        self.poll_interval = poll_interval
        # records-ahead depth for the background chunk reader (0 = read
        # inline).  Prefetch keeps lease settlement exact: a read error
        # surfaces at the consuming next() (utils.reader propagation)
        # and still charges task_failed, never a short chunk.
        self.prefetch = prefetch
        self.guard = guard
        self.guard_executor = guard_executor
        self.publisher = publisher
        self.publish_every_steps = int(publish_every_steps)
        self._last_published_step: Optional[int] = None
        self._last_published_version: Optional[str] = None
        # telemetry: live progress for /statusz (attach the
        # trainer to an ObservabilityServer) + a counter per durable
        # journal event next to the guardrail series
        self._last_step: Optional[int] = None
        self._last_saved_step: Optional[int] = None
        from ..observability.metrics import registry as _obs_registry

        self._m_journal = _obs_registry().counter(
            "paddle_guard_journal_events_total",
            "Guard-journal records written (skip/rollback/"
            "escalate-restore)", labels=("event",))
        self._m_published = _obs_registry().counter(
            "paddle_lifecycle_candidates_published_total",
            "Versioned candidate artifacts emitted by the trainer",
            labels=("outcome",))

    def status(self) -> dict:
        """JSON-able progress rollup — the ObservabilityServer /statusz
        source for a training worker (duck-typed via ``status``)."""
        out = {"worker": self.worker,
               "checkpoint_dir": self.manager.dirname,
               "last_step": self._last_step,
               "last_saved_step": self._last_saved_step,
               "guarded": self.guard is not None}
        if self.publisher is not None:
            out["last_published_step"] = self._last_published_step
            out["last_published_version"] = self._last_published_version
        if self.guard_executor is not None:
            out["health"] = self.guard_executor.health_stats()
        return out

    def resume(self) -> Optional[int]:
        """Restore the newest CRC-valid checkpoint into the scope;
        returns its step, or None when starting fresh (corrupt/missing
        checkpoints are skipped, like pserver's LoadCheckpoint)."""
        return self.manager.restore(self.program, self.scope)

    def records(self):
        """The elastic record stream (a fresh generator per call) — for
        callers that want the raw reader; run() uses its own loop for
        exact lease settlement (see module docstring)."""
        return master_reader(self.queue, self.read_chunk,
                             worker=self.worker,
                             poll_interval=self.poll_interval)()

    def _save(self, step: int, force: bool = False) -> bool:
        return self.manager.save(step, self.program, self.scope,
                                 force=force)

    def _maybe_publish(self, step: int, force: bool = False) -> None:
        """Emit a versioned candidate artifact from the live scope.
        Advisory by design: a failed publish is counted + logged, never
        raised — the release controller decides what serves, and a full
        artifact disk must not take training down with it."""
        if self.publisher is None or step <= 0:
            return
        if self._last_published_step == step:
            return
        if not force and (self.publish_every_steps <= 0
                          or step % self.publish_every_steps != 0):
            return
        try:
            version = self.publisher.publish(step, self.program,
                                             self.scope)
        except Exception as e:
            self._m_published.labels(outcome="failed").inc()
            import sys

            print(f"[paddle_tpu_torch] candidate publish failed at step "
                  f"{step}: {e}", file=sys.stderr)
            return
        self._last_published_step = step
        self._last_published_version = (str(version)
                                        if version is not None else None)
        self._m_published.labels(outcome="published").inc()

    # -- guardrail wiring ----------------------------------------------------
    def guard_journal_path(self) -> str:
        return os.path.join(self.manager.dirname, "guard.journal")

    def _journal_guard(self, step: int, event: str, **extra) -> None:
        rec = {"step": int(step), "event": event}
        rec.update(extra)
        self._m_journal.labels(event=event).inc()
        try:
            with open(self.guard_journal_path(), "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            # the journal is telemetry: a full disk during a NaN storm
            # must not mask the in-flight recovery (this runs inside a
            # finally) or abort an otherwise-successful step
            import sys

            print(f"[paddle_tpu_torch] guard journal write failed at step "
                  f"{step} ({event})", file=sys.stderr)

    def _wrap_guarded(self, train_step: Callable) -> Callable:
        """Close the guardrail recovery loop around train_step: journal
        the executor's skip/rollback deltas per step, and answer a
        NonFiniteEscalation with CheckpointManager.restore() (the
        device-side recovery gave up; fall back to durable state) — the
        batch is dropped, the lease keeps advancing."""
        from .guardrails import NonFiniteEscalation

        exe = self.guard_executor

        def guarded(record, step):
            before = exe.health_stats() if exe is not None else None
            try:
                train_step(record, step)
            except NonFiniteEscalation:
                restored = self.manager.restore(self.program, self.scope)
                self._journal_guard(step, "escalate-restore",
                                    restored_step=restored)
                if restored is None:
                    # nothing durable to fall back on (a storm before
                    # the first save): swallowing here would drain the
                    # whole queue while training on nothing — surface
                    # the escalation; _drive_chunk charges the lease
                    raise
                return
            finally:
                if before is not None:
                    after = exe.health_stats()
                    for kind in ("skips", "rollbacks"):
                        n = after[kind] - before[kind]
                        if n > 0:
                            self._journal_guard(step, kind[:-1], count=n)
        return guarded

    def run(self, train_step: Callable, init_fn: Optional[Callable] = None,
            max_steps: Optional[int] = None) -> int:
        """resume() -> lease chunks -> train_step(record, step) ->
        checkpoint every save_interval_steps.  `init_fn` runs only when
        no checkpoint exists (startup-program initialization); a crash
        anywhere re-enters through resume() on the next run().  Returns
        the final step (the queue drained, or `max_steps` reached)."""
        from .chaos import injector

        if self.guard is not None:
            train_step = self._wrap_guarded(train_step)
        restored = self.resume()
        if restored is None:
            if init_fn is not None:
                init_fn()
            step = 0
        else:
            step = restored
        last_saved = restored
        self._last_step, self._last_saved_step = step, last_saved
        stopping = False
        while not stopping:
            if max_steps is not None and step >= max_steps:
                # a resume at/past the bound must not lease and train an
                # overshoot step per incarnation
                break
            task = self.queue.get_task(self.worker)
            if task is None:
                if self.queue.all_done():
                    break
                time.sleep(self.poll_interval)  # leases pending elsewhere
                continue
            injector().note_lease()     # chaos kill-after-N hook
            try:
                src = self.read_chunk(task.chunk)
                if self.prefetch:
                    from ..utils.reader import PrefetchIterator

                    src = PrefetchIterator(src, self.prefetch)
                it = iter(src)
            except Exception:
                self.queue.task_failed(task.task_id)
                continue
            try:
                step, last_saved, stopping = self._drive_chunk(
                    task, it, train_step, max_steps, step, last_saved)
                self._last_step, self._last_saved_step = step, last_saved
            finally:
                # unblock a prefetching producer on EVERY exit path
                # (chunk done, failure break, train_step raise)
                close = getattr(src, "close", None)
                if close is not None:
                    close()
        # the final step always persists, whatever the interval (but
        # never rewrite a checkpoint the loop just finished writing)
        if step > 0 and last_saved != step:
            self._save(step, force=True)
            last_saved = step
        # ... and the final state always publishes as a candidate, so
        # the release controller sees the run's end product even when
        # the step count is not a multiple of the publish interval
        self._maybe_publish(step, force=True)
        self._last_step, self._last_saved_step = step, last_saved
        return step

    def _drive_chunk(self, task, it, train_step, max_steps, step,
                     last_saved):
        """Consume one leased chunk's records; returns (step, last_saved,
        stopping).  train_step exceptions propagate after the lease is
        settled (see run's accounting table in the module docstring)."""
        while True:
            try:
                record = next(it)
            except StopIteration:
                # checkpoint BEFORE reporting the chunk done: once
                # the master durably records it finished, its
                # records are never re-delivered — so the steps they
                # trained must already be durable too, or a crash in
                # this gap silently loses them (at-most-once)
                if step > 0 and last_saved != step:
                    self._save(step, force=True)
                    last_saved = step
                self.queue.task_finished(task.task_id)
                return step, last_saved, False
            except Exception:
                self.queue.task_failed(task.task_id)
                return step, last_saved, False
            step += 1
            try:
                train_step(record, step)
            except Exception:
                # charge the failure BEFORE propagating: a poison
                # record must burn failure budget on every crash so
                # failure_max eventually discards its chunk instead
                # of the worker crash-looping forever
                self.queue.task_failed(task.task_id)
                raise
            except BaseException:
                # KeyboardInterrupt / SystemExit: a deliberate stop
                # is not a failure — hand the lease back uncharged
                # (best-effort, as in the max_steps stop below)
                try:
                    self.queue.task_returned(task.task_id,
                                             self.worker)
                except Exception:
                    pass
                raise
            if self._save(step):
                last_saved = step
            self._maybe_publish(step)
            if max_steps is not None and step >= max_steps:
                # deliberate stop mid-chunk: hand the lease back
                # uncharged (best-effort — if the master is away,
                # the lease simply expires as a crash would)
                try:
                    self.queue.task_returned(task.task_id,
                                             self.worker)
                except Exception:
                    pass
                return step, last_saved, True
