"""Deterministic fault injection — the port's copy of
``paddle_tpu/resilience/chaos.py``.

A ``FaultInjector`` owns named injection points, all no-ops unless
configured.  Every probabilistic decision is a pure function of (seed,
point, draw index) — ``FaultInjector.decision``, crc32-based — so the
same spec and seed fire the same draws on every run, across processes,
and in both packages.  An optional journal logs each draw for post-hoc
replay checks.

The port's code reaches one point so far:

  * ``kv.spill_corrupt`` — tear a suspended session's artifact as it is
                        read (serving/sessions.py): the checksum must
                        turn it into a miss (the resume degrades to a
                        fresh prefill), never into wrong KV bytes.

The reference threads its other points (``master.*``, ``ckpt.truncate``,
``guard.*``, ``io.publish``, ``registry.load``, ``gateway.swap``,
``aot.corrupt``, ``net.*``, ``coord.crash``, ``sync.preempt``) through
modules the port has not taken on; the injector's actions for them are
kept, so one spec configures both packages alike.

Configuration (environment, all off by default), the reference's:

  PADDLE_TPU_CHAOS="kv.spill_corrupt=0.5"
  PADDLE_TPU_CHAOS_SEED=7
  PADDLE_TPU_CHAOS_KILL_AFTER=3     # SIGKILL self on leasing task #3
  PADDLE_TPU_CHAOS_LOG=/path/chaos.journal
  PADDLE_TPU_CHAOS_HANG_SECONDS=5   # guard.hang stall length
"""

from __future__ import annotations

import itertools
import os
import signal
import time
import zlib
from typing import Dict, Optional

from ..utils.sync import RANK_CHAOS, OrderedLock

__all__ = ["ChaosError", "FaultInjector", "injector", "install"]


class ChaosError(ConnectionError):
    """Injected transient fault.  Subclasses ConnectionError so the
    retry layer treats an injected network fault like a real one."""


def _parse_spec(spec: str) -> Dict[str, float]:
    probs = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"chaos spec entry {part!r}: want point=prob")
        point, prob = part.split("=", 1)
        probs[point.strip()] = float(prob)
    return probs


class FaultInjector:
    """Seeded injection points; a default-constructed one is inert."""

    def __init__(self, spec: str = "", seed: int = 0,
                 kill_after: int = 0, log_path: Optional[str] = None,
                 hang_seconds: float = 5.0):
        self.probs = _parse_spec(spec)
        self.seed = int(seed)
        self.kill_after = int(kill_after)
        self.log_path = log_path
        self.hang_seconds = float(hang_seconds)
        self._lock = OrderedLock("chaos.injector", RANK_CHAOS)
        self._draws: Dict[str, int] = {}
        self._leases = 0
        # sync.preempt draws are LOCK-FREE (itertools.count.next is
        # atomic under the GIL): maybe_preempt runs inside the sync
        # layer's own acquire path, and taking self._lock there would
        # recurse straight back into it
        self._preempt_draws = itertools.count()

    @classmethod
    def from_env(cls, environ=None) -> "FaultInjector":
        env = os.environ if environ is None else environ
        return cls(spec=env.get("PADDLE_TPU_CHAOS", ""),
                   seed=int(env.get("PADDLE_TPU_CHAOS_SEED", "0")),
                   kill_after=int(env.get("PADDLE_TPU_CHAOS_KILL_AFTER",
                                          "0")),
                   log_path=env.get("PADDLE_TPU_CHAOS_LOG"),
                   hang_seconds=float(
                       env.get("PADDLE_TPU_CHAOS_HANG_SECONDS", "5")))

    def enabled(self) -> bool:
        return bool(self.probs) or self.kill_after > 0

    # -- deterministic draws -------------------------------------------------
    @staticmethod
    def decision(seed: int, point: str, index: int) -> float:
        """Uniform [0,1) value for draw `index` at `point` — a pure
        function of its arguments (crc32-based, stable across processes
        and platforms, unlike Python's salted hash())."""
        key = f"{seed}|{point}|{index}".encode()
        return (zlib.crc32(key) & 0xFFFFFFFF) / 2**32

    def should(self, point: str) -> bool:
        """Deterministically decide whether draw #k at `point` fires;
        points with no configured probability consume no draws (adding a
        new point never perturbs another point's schedule)."""
        prob = self.probs.get(point, 0.0)
        if prob <= 0.0:
            return False
        with self._lock:
            index = self._draws.get(point, 0)
            self._draws[point] = index + 1
        value = self.decision(self.seed, point, index)
        fired = value < prob
        self._log(f"{point} {index} {value:.9f} {int(fired)}")
        return fired

    def _log(self, line: str) -> None:
        # NOT under self._lock (no I/O under a lock):
        # the lock's job is draw-index atomicity; holding it across a
        # file append serialized every injection point behind the disk.
        # One whole line per O_APPEND write keeps concurrent entries
        # from interleaving mid-line.
        if not self.log_path:
            return
        with open(self.log_path, "a") as f:
            f.write(line + "\n")

    def maybe_preempt(self, point: str = "sync.preempt",
                      max_sleep: float = 0.001) -> bool:
        """The race-harness perturbation: consume one seeded
        draw for `point`; when it fires, either yield the GIL
        (``sleep(0)``) or sleep a small deterministic-length interval —
        both derived from the same draw value, so a seed maps to one
        fixed perturbation schedule.  Lock-free (called from inside
        lock acquire/release paths); returns True when it perturbed."""
        prob = self.probs.get(point, 0.0)
        if prob <= 0.0:
            return False
        index = next(self._preempt_draws)
        value = self.decision(self.seed, point, index)
        if value >= prob:
            return False
        frac = value / prob          # uniform [0,1) given the fire
        time.sleep(0.0 if frac < 0.5 else frac * max_sleep)
        return True

    # -- injection actions ---------------------------------------------------
    def maybe_fail(self, point: str) -> None:
        """Raise a transient ChaosError when `point` fires."""
        if self.should(point):
            raise ChaosError(f"chaos[{point}]: injected fault")

    def maybe_delay(self, point: str = "net.delay",
                    max_delay: float = 0.05) -> bool:
        """Sleep a seeded deterministic interval when `point` fires — a
        laggy link rather than a lost packet (same indexed draw stream
        as ``should``, so delay and partition schedules never perturb
        each other); returns True if it slept."""
        prob = self.probs.get(point, 0.0)
        if prob <= 0.0:
            return False
        with self._lock:
            index = self._draws.get(point, 0)
            self._draws[point] = index + 1
        value = self.decision(self.seed, point, index)
        fired = value < prob
        self._log(f"{point} {index} {value:.9f} {int(fired)}")
        if not fired:
            return False
        time.sleep((value / prob) * max_delay)   # uniform [0, max_delay)
        return True

    def maybe_truncate(self, path: str, point: str = "ckpt.truncate") -> bool:
        """Truncate `path` to half its size when `point` fires — a torn
        write the CRC layer must catch; returns True if truncated."""
        if not self.should(point):
            return False
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        self._log(f"# truncated {path} {size}->{size // 2}")
        return True

    def maybe_hang(self, point: str = "guard.hang") -> bool:
        """Stall the calling thread ``hang_seconds`` when `point` fires —
        a wedged device dispatch the step watchdog must detect (the
        sleep runs on the guarded dispatch's worker thread, so a fired
        watchdog abandons it exactly like a real device hang); returns
        True if it hung."""
        if not self.should(point):
            return False
        self._log(f"# hang {self.hang_seconds}s at {point}")
        time.sleep(self.hang_seconds)
        return True

    def note_lease(self) -> None:
        """Count task leases; SIGKILL self upon acquiring lease number
        `kill_after` (the process dies MID-CHUNK, holding the lease, so
        re-dispatch after timeout is what keeps the job correct)."""
        if self.kill_after <= 0:
            return
        with self._lock:
            self._leases += 1
            fatal = self._leases >= self.kill_after
        if fatal:
            self._log(f"# kill-self at lease {self.kill_after} "
                      f"pid={os.getpid()}")
            os.kill(os.getpid(), signal.SIGKILL)


_global: Optional[FaultInjector] = None
# own name: sharing "chaos.injector" with the per-instance draw locks
# would merge two different locks into one paddle_sync_* series and
# read any future nesting as a same-name cycle
_global_lock = OrderedLock("chaos.global", RANK_CHAOS)


def injector() -> FaultInjector:
    """Process-global injector, built from the environment on first use
    (inert unless PADDLE_TPU_CHAOS* is set)."""
    global _global
    if _global is None:
        with _global_lock:
            if _global is None:
                _global = FaultInjector.from_env()
    return _global


def install(inj: Optional[FaultInjector]) -> Optional[FaultInjector]:
    """Swap the process-global injector (tests); returns the previous
    one.  Pass None to fall back to env-based construction on next use."""
    global _global
    with _global_lock:
        prev, _global = _global, inj
    return prev
