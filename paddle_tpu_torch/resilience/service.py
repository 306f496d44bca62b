"""Supervised long-running services — the port of
``paddle_tpu/resilience/service.py``.

The reference ran pservers and the master as externally supervised
processes: a wedged or crashed service was restarted by its supervisor
and recovered its state from a journal/snapshot.  This module packages
that for SERVICES — a single process that must stay up, restart in
place when it exits non-zero, and recover its queue from a journal on
the way back up (the gateway's ``RequestJournal.pending()`` +
``Gateway.recover()``).

``run_supervised`` is deliberately thin: the service itself owns its
durability (journal, artifact store); supervision only guarantees the
process comes back.  A service that wants restart-on-wedge exits
non-zero from its own health watchdog (``Gateway.wedged`` +
``tools.gateway serve --exit-on-wedge``) and rides the same budget.
``run_supervised`` is the elastic launcher's single-rank case
(``launch.py``: ``launch(1, argv, max_restarts=...)``), as the
reference has it."""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ..utils.sync import RANK_SERVICE, OrderedLock

__all__ = ["run_supervised", "SupervisedService"]


def run_supervised(argv: List[str], max_restarts: int = 2,
                   log_dir: Optional[str] = None) -> int:
    """Run ``python <argv...>`` as a supervised single-rank service:
    non-zero exits respawn the process (same argv, same env) while the
    restart budget lasts.  Returns the final exit code (0 = clean
    exit).  Built on the elastic launcher, so logs land per-rank under
    ``log_dir`` and SIGTERM->SIGKILL escalation applies."""
    from ..launch import launch

    return launch(1, list(argv), max_restarts=int(max_restarts),
                  log_dir=log_dir)


class SupervisedService:
    """``run_supervised`` as an object: one long-running
    child process with in-place respawn, owned by a caller that manages
    SEVERAL of them — the fleet supervisor runs one per replica.

    ``start()`` spawns ``python <argv...>`` plus a monitor thread that
    respawns the child on non-zero exit while the restart budget lasts
    (a clean exit 0 ends supervision — a drained replica that chose to
    leave stays gone).  ``stop()`` escalates SIGTERM -> SIGKILL;
    ``kill()`` SIGKILLs without stopping supervision, so the monitor
    treats it as a crash and respawns — the chaos drill the fleet CLI's
    ``kill`` verb performs.  The child owns its own durability (journal
    + recover()); supervision only guarantees the process comes back."""

    def __init__(self, argv: List[str], max_restarts: int = 2,
                 log_path: Optional[str] = None,
                 env_extra: Optional[Dict[str, str]] = None,
                 name: str = "service", kill_grace: float = 5.0):
        self.argv = [sys.executable] + list(argv)
        self.max_restarts = int(max_restarts)
        self.log_path = log_path
        self.env_extra = dict(env_extra or {})
        self.name = str(name)
        self.kill_grace = float(kill_grace)
        self._lock = OrderedLock("resilience.service", RANK_SERVICE)
        self._proc: Optional[subprocess.Popen] = None
        self._monitor: Optional[threading.Thread] = None
        self._stopping = False
        self._restarts = 0
        self._last_rc: Optional[int] = None

    # -- spawning (I/O outside the lock; the lock only guards handles) ------
    def _spawn(self) -> subprocess.Popen:
        env = dict(os.environ)
        env.update(self.env_extra)
        if self.log_path:
            d = os.path.dirname(self.log_path)
            if d:
                os.makedirs(d, exist_ok=True)
            out = open(self.log_path, "ab")
        else:
            out = None
        try:
            return subprocess.Popen(self.argv, stdout=out, stderr=out,
                                    env=env)
        finally:
            if out is not None:
                out.close()     # the child holds its own fd now

    def start(self) -> "SupervisedService":
        with self._lock:
            if self._monitor is not None:
                raise RuntimeError(f"service {self.name}: already "
                                   "started")
            self._stopping = False
        proc = self._spawn()
        with self._lock:
            self._proc = proc
            self._monitor = threading.Thread(
                target=self._watch, daemon=True,
                name=f"supervise-{self.name}")
            self._monitor.start()
        return self

    def _watch(self) -> None:
        while True:
            with self._lock:
                proc = self._proc
            if proc is None:
                return
            rc = proc.wait()
            with self._lock:
                self._last_rc = rc
                if self._stopping:
                    return
                if rc == 0 or self._restarts >= self.max_restarts:
                    self._proc = None
                    return
                self._restarts += 1
            respawned = self._spawn()
            with self._lock:
                if self._stopping:
                    break
                self._proc = respawned
        # raced with stop(): tear the straggler down ourselves, with
        # the same SIGTERM -> grace -> SIGKILL escalation stop() uses,
        # and REAP it — a bare terminate() leaves a zombie and lets
        # stop() (which joins this thread) return mid-teardown
        respawned.terminate()
        try:
            respawned.wait(self.kill_grace)
        except subprocess.TimeoutExpired:
            respawned.kill()
            respawned.wait()

    def stop(self) -> Optional[int]:
        """End supervision and the child: SIGTERM, grace, SIGKILL.
        Returns the child's final exit code (None if never started)."""
        with self._lock:
            self._stopping = True
            proc, monitor = self._proc, self._monitor
            self._proc, self._monitor = None, None
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(self.kill_grace)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        if monitor is not None:
            monitor.join(timeout=self.kill_grace + 5)
        with self._lock:
            return self._last_rc if proc is None else proc.returncode

    def kill(self) -> Optional[int]:
        """SIGKILL the current child WITHOUT stopping supervision — the
        monitor sees a non-zero exit and respawns (budget permitting).
        Returns the pid killed, or None when no child is running."""
        with self._lock:
            proc = self._proc
        if proc is None or proc.poll() is not None:
            return None
        pid = proc.pid
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            return None
        return pid

    @property
    def pid(self) -> Optional[int]:
        with self._lock:
            proc = self._proc
        return proc.pid if proc is not None and proc.poll() is None \
            else None

    @property
    def restarts(self) -> int:
        with self._lock:
            return self._restarts

    def running(self) -> bool:
        with self._lock:
            proc = self._proc
        return proc is not None and proc.poll() is None

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until supervision ends (clean exit or budget spent).
        True when it did; False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                monitor = self._monitor
            if monitor is None or not monitor.is_alive():
                return True
            remaining = None if deadline is None \
                else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return False
            monitor.join(timeout=0.1 if remaining is None
                         else min(0.1, remaining))
