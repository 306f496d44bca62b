"""Bounded retries: exponential backoff with decorrelated jitter — the
port's copy of ``paddle_tpu/resilience/retry.py``.

The analog of the reference Go master client's backoff loop
(go/master/client.go: the client redials a restarting master instead of
failing the trainer).  A `RetryPolicy` owns the *shape* of the loop —
which exceptions are transient, how long to back off, when to give up —
so callers wrap one line (`policy.call(fn, ...)`) instead of re-writing
the loop at every RPC site.

Backoff is "decorrelated jitter" (each delay drawn uniformly from
[base, prev*3], capped): it spreads a thundering herd of workers
re-polling a restarted master without the lockstep of plain exponential
backoff.  The jitter RNG can be seeded, so tests (and the chaos harness)
get byte-identical retry schedules.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Sequence, Type

__all__ = ["RetryPolicy"]


class RetryPolicy:
    """Retry transient failures with decorrelated-jitter backoff.

    Parameters
    ----------
    max_attempts: total tries including the first (None = unbounded,
        the deadline alone limits the loop).
    deadline: overall wall-clock budget in seconds measured from the
        first attempt; once spent, the last exception re-raises (None =
        no deadline).
    base_delay / max_delay: backoff bounds in seconds.
    retryable: exception classes considered transient.
    retry_if: optional predicate refining `retryable` — called with the
        exception; return False to re-raise immediately (e.g. an HTTP
        4xx is an HTTPError like a 503, but must not retry).
    seed: seed for the jitter RNG (None = nondeterministic).
    sleep / clock: injectable for tests (fake time).
    """

    def __init__(self, max_attempts: Optional[int] = 8,
                 deadline: Optional[float] = 30.0,
                 base_delay: float = 0.05, max_delay: float = 2.0,
                 retryable: Sequence[Type[BaseException]] = (
                     ConnectionError, TimeoutError),
                 retry_if: Optional[Callable[[BaseException], bool]] = None,
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        if max_attempts is None and deadline is None:
            raise ValueError("RetryPolicy needs max_attempts or deadline "
                             "(both None would retry forever)")
        self.max_attempts = max_attempts
        self.deadline = deadline
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.retryable = tuple(retryable)
        self.retry_if = retry_if
        self._seed = seed
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._clock = clock

    def _is_transient(self, exc: BaseException) -> bool:
        if not isinstance(exc, self.retryable):
            return False
        return self.retry_if(exc) if self.retry_if is not None else True

    def delays(self):
        """The backoff schedule as an iterator (consumes the jitter RNG —
        two policies with the same seed yield the same schedule)."""
        prev = self.base_delay
        while True:
            prev = min(self.max_delay,
                       self._rng.uniform(self.base_delay, prev * 3))
            yield prev

    def call(self, fn: Callable, *args, **kwargs):
        """Run fn(*args, **kwargs), retrying transient failures until it
        succeeds, attempts run out, or the deadline passes; the last
        exception re-raises unchanged so callers keep their handling."""
        start = self._clock()
        delays = self.delays()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except Exception as exc:
                if not self._is_transient(exc):
                    raise
                if (self.max_attempts is not None
                        and attempt >= self.max_attempts):
                    raise
                delay = next(delays)
                if self.deadline is not None:
                    remaining = self.deadline - (self._clock() - start)
                    if remaining <= 0:
                        raise
                    delay = min(delay, remaining)
                self._sleep(delay)

    def __call__(self, fn: Callable) -> Callable:
        """Decorator form: ``@policy`` wraps fn in call()."""
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        return wrapped
