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
Passing ``coordinator=PodClient(...)`` switches run() to the elastic
multi-host loop: rendezvous into a generation, lockstep
per-step agreement barriers through the coordinator (a local NaN
becomes an agreed pod-wide skip/rollback — applied by all hosts or
none), coordinator-reduced gradients applied via ``apply_update``
(identical bytes on every host), and coordinated pod snapshots through
``PodCheckpointManager`` (all-ranks staged barrier before the COMMIT
marker).  On host loss the survivors' generation goes stale; they
re-rendezvous at the smaller world, restore the newest committed
manifest, and replay from there — steps past the last commit re-run
(at-least-once), but the journal's resync records make the effective
trajectory exact.  Pod-mode contracts (all deterministic per rank):

  * ``read_chunk(step, rank, world) -> record``  (equal shards, so the
    coordinator's mean of host-means is the global mean)
  * ``train_step(record, step) -> (healthy, grads_dict)``  — gradients
    are FETCHED, not applied; the trainer additionally verifies
    finiteness and proposes skip/rollback per the guard policy
  * ``apply_update(reduced_grads, step)``  — apply the agreed update
  * ``state_get() / state_set(dict)``  — snapshot state as a plain
    name->ndarray dict (defaults adapt program persistables + scope)

Every host must construct identical initial params in ``init_fn``
(seed it); after that, agreement + coordinator-side reduction keep the
replicas bitwise identical by construction.

In the port a host's ``train_step`` fetches its gradients from the card
(numpy), the coordinator reduces them on the host, and ``apply_update``
writes the agreed update back (a replaced scope var is copied into the
captured step's buffer at the next replay: one graph, a hit a step).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

from ..fluid.checkpoint import CheckpointManager, PodCheckpointManager
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
    rendezvous_deadline / step_deadline / heartbeat_interval: pod mode
        (module docstring): a ``PodClient`` and the update, state and
        deadline hooks of the lockstep loop.
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
        self.manager = CheckpointManager(
            checkpoint_dir, max_to_keep=max_to_keep,
            save_interval_steps=save_interval_steps)
        self.coordinator = coordinator
        self.apply_update = apply_update
        self.state_get = state_get
        self.state_set = state_set
        self.rendezvous_deadline = float(rendezvous_deadline)
        self.step_deadline = float(step_deadline)
        self.heartbeat_interval = float(heartbeat_interval)
        self.pod: Optional[PodCheckpointManager] = None
        if coordinator is not None:
            if apply_update is None:
                raise ValueError("pod mode (coordinator=) needs "
                                 "apply_update=")
            self.pod = PodCheckpointManager(checkpoint_dir,
                                            max_to_keep=max_to_keep)
        elif queue is None:
            raise ValueError("need a queue (lease mode) or a "
                             "coordinator (pod mode)")
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
        if self.coordinator is not None:
            v = getattr(self.coordinator, "view", None)
            out["pod"] = None if v is None else {
                "generation": v.generation, "rank": v.rank,
                "world": v.world}
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
        the final step (the queue drained, or `max_steps` reached).

        In pod mode (coordinator=) the loop is the lockstep multi-host
        one instead — see the module docstring for the contracts."""
        from .chaos import injector

        if self.coordinator is not None:
            return self._run_pod(train_step, init_fn, max_steps)
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

    # -- pod (multi-host) mode -----------------------------------------------
    def _pod_state_get(self):
        if self.state_get is not None:
            return self.state_get()
        from ..fluid.executor import global_scope, scope_to_numpy
        from ..fluid.framework import default_main_program

        program = self.program or default_main_program()
        scope = self.scope or global_scope()
        # the program's persistables as host arrays (a card's tensors
        # are fetched)
        return scope_to_numpy(scope, [
            v.name for v in program.list_vars()
            if v.persistable and scope.find_var(v.name) is not None])

    def _pod_state_set(self, items) -> None:
        if self.state_set is not None:
            self.state_set(items)
            return
        from ..fluid.executor import global_scope

        scope = self.scope or global_scope()
        for name, val in items.items():
            scope.set_var(name, val)

    def _pod_proposal(self) -> str:
        """Map a locally-unhealthy step to this host's vote, per the
        guard policy (skip unless the policy escalates to rollback;
        'raise' would kill just this host and diverge the pod, so it
        too proposes the agreed skip)."""
        if self.guard is not None and getattr(
                self.guard, "on_nonfinite", "skip") == "rollback":
            return "rollback"
        return "skip"

    def _pod_save(self, step: int, view, client) -> None:
        """One coordinated snapshot: stage (durable) -> all-ranks
        barrier -> rank 0 writes COMMIT -> rank 0 records the pod's
        resume point.  Only AFTER the marker is on disk may the step
        count as committed — a crash anywhere earlier leaves a torn,
        never-restored manifest."""
        self.pod.stage(step, view.rank, view.world,
                       self._pod_state_get())
        client.snapshot_barrier(step, deadline=self.step_deadline)
        if view.rank == 0 and self.pod.commit(step, view.world):
            client.committed(step)

    def _pod_resync(self, client):
        """The elastic shrink/regrow edge: re-rendezvous into the new
        generation, restore the newest committed manifest, and rewind
        to its step (no manifest -> step 0 with current params — every
        host rewinds identically, so lockstep holds)."""
        view = client.resync(deadline=self.rendezvous_deadline)
        restored = self.pod.restore(view.rank)
        if restored is None:
            step, last_saved = 0, None
        else:
            step, items = restored
            self._pod_state_set(items)
            last_saved = step
        self._journal_guard(step, "pod-resync", host=client.host,
                            generation=view.generation,
                            world=view.world)
        self._last_step = step
        self._last_saved_step = last_saved
        return view, step, last_saved

    def _run_pod(self, train_step, init_fn, max_steps) -> int:
        """The lockstep elastic loop: every step is one agreement
        barrier; every agreed verdict is journaled on every host (the
        cross-host audit trail — hosts MUST journal identical verdicts
        per (generation, step)); saves are coordinated manifests."""
        import numpy as np

        from ..parallel.coordinator import StaleGeneration

        client = self.coordinator
        view = client.join(deadline=self.rendezvous_deadline)
        client.start_heartbeats(self.heartbeat_interval)
        try:
            restored = self.pod.restore(view.rank)
            if restored is None:
                if init_fn is not None:
                    init_fn()
                step, last_saved = 0, None
            else:
                step, items = restored
                self._pod_state_set(items)
                last_saved = step
            self._last_step, self._last_saved_step = step, last_saved
            while max_steps is None or step < max_steps:
                nxt = step + 1
                try:
                    record = self.read_chunk(nxt, view.rank, view.world)
                    healthy, grads = train_step(record, nxt)
                    verdict = "continue"
                    if not healthy or grads is None or not all(
                            np.all(np.isfinite(np.asarray(g)))
                            for g in grads.values()):
                        verdict = self._pod_proposal()
                    agreed, reduced = client.step_sync(
                        nxt, verdict,
                        grads if verdict == "continue" else None,
                        deadline=self.step_deadline)
                except StaleGeneration:
                    view, step, last_saved = self._pod_resync(client)
                    continue
                self._journal_guard(nxt, f"pod-{agreed}",
                                    host=client.host,
                                    generation=view.generation,
                                    world=view.world)
                if agreed == "rollback":
                    rolled = self.pod.restore(view.rank)
                    if rolled is not None:
                        step, items = rolled
                        self._pod_state_set(items)
                        self._journal_guard(step, "pod-rollback-restore",
                                            host=client.host,
                                            generation=view.generation)
                        self._last_step = step
                        continue
                    # nothing durable to roll back to: the agreed
                    # outcome degrades to the same all-hosts skip
                elif agreed == "continue" and reduced is not None:
                    self.apply_update(reduced, nxt)
                step = nxt
                self._last_step = step
                try:
                    if self.manager.should_save(step):
                        self._pod_save(step, view, client)
                        last_saved = step
                        self._last_saved_step = step
                except StaleGeneration:
                    view, step, last_saved = self._pod_resync(client)
            # the final state always persists (same rule as lease mode)
            if step > 0 and last_saved != step:
                try:
                    self._pod_save(step, view, client)
                    self._last_saved_step = step
                except StaleGeneration:
                    # the pod moved on at the finish line; the newest
                    # committed manifest stands as the durable result
                    pass
            return step
        finally:
            client.stop_heartbeats()

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
