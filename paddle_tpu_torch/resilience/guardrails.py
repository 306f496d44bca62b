"""Training guardrails — the port of ``paddle_tpu/resilience/guardrails.py``:
a finiteness sentinel and a gated state publish captured in the step's
CUDA graph, rollback-and-skip recovery, and a hung-step watchdog.

The reference defends a training step in three disconnected places: a
host-side post-hoc scan of every op output (CheckTensorNANOrInf,
paddle/framework/executor.cc:64,129), per-var error clipping appended by
backward (python/paddle/v2/fluid/clip.py ErrorClipByValue), and the
pserver's rule that a bad update must never be published.  This module
puts that self-defense INTO the step and gives it a recovery policy:

* **Sentinel** — ``build_guarded_step_fn`` gives the executor a guard
  for one step signature: whether every element of the checked values
  (loss fetches, parameter gradients, post-update parameters) is
  finite, a 0-d bool on the device (the AMP's multi-tensor check: a
  launch per chunk of tensors).  It runs in the step's body, so
  on the card it is captured in the same CUDA graph and replays with
  it; the host reads the one flag after the replay, its only read of
  the step.

* **Gated state publish** — the reference publishes every carried entry
  as ``jnp.where(healthy, new, old)``, its ``old`` still live beside the
  step's donated outputs.  Here the step updates parameters and
  optimizer moments in place, so the guard keeps a pre-step copy of
  every state entry the step writes (``save``, the body's first work,
  multi-tensor copies)
  and publishes ``torch.where(healthy, new, pre)`` into it after the
  ops (``gate``): a healthy step is bitwise the unguarded step
  (select-on-true is the identity), an unhealthy one leaves the state
  exactly pre-step.  One extra read and write of the written state a
  step, and one select over it.

* **Rollback** — ``GuardPolicy(on_nonfinite="rollback")`` keeps a "last
  good" copy of the state on the device every ``snapshot_every``
  guarded steps (``device_snapshot``: fresh tensors no step writes) and
  republishes it when a step goes bad.  After ``escalate_after``
  consecutive bad steps the executor raises :class:`NonFiniteEscalation`;
  ``ResilientTrainer`` answers it with ``CheckpointManager.restore()``.

* **Step watchdog** — ``dispatch_guarded`` runs the dispatch on a
  worker thread while the calling thread monitors a wall-clock deadline
  (``step_timeout``); a wedged step surfaces as a structured
  :class:`StepTimeout` instead of hanging the trainer forever.  A CUDA
  graph replay is asynchronous and cannot be cancelled, so on the card
  a hang surfaces at the flag's read.  Transient faults (injected chaos,
  connection and timeout errors, timeouts themselves) are retried
  through the policy's ``resilience.retry.RetryPolicy`` before a
  :class:`StepFault` surfaces.

Entry point: ``Executor.run(..., guard=GuardPolicy(...))`` — counters
in ``Executor.health_stats()``.

When a failed dispatch may be retried: the reference asks whether its
donated buffers are still alive.  The port donates nothing; its
counterpart is whether the step ever launched on the state
(``mark_launched`` / ``state_buffers_live``).  A fault before the launch
(a chaos fault, a stall in host-side staging) leaves the state live and
retryable.  A fault after it may have written part of the state: the
dispatch is retryable only once the state is restored from the guard's
pre-step copy, which needs that copy complete (known on the CPU, where
the body runs eagerly; never known mid-replay on the card) and every
written entry gated.  Otherwise the fault surfaces structured, with the
rollback snapshot republished into the scope when there is one.
Variable-length (SeqArray) state entries pass through ungated, as in
the reference.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.sync import RANK_GUARD, OrderedLock
from .retry import RetryPolicy

__all__ = ["GuardPolicy", "NonFiniteError", "NonFiniteEscalation",
           "StepFault", "StepTimeout", "classify_step_error",
           "build_guarded_step_fn", "device_snapshot", "poison_feed",
           "dispatch_guarded", "state_buffers_live"]

_ON_NONFINITE = ("raise", "skip", "rollback")
_CHECKS = ("loss", "grads", "params")


class NonFiniteError(FloatingPointError):
    """A guarded step produced NaN/Inf and the policy is ``raise``.
    The scope still holds the PRE-step state (the gated publish ran
    before this raised) — unlike the reference's CheckTensorNANOrInf,
    which leaves the corrupted tensors behind."""


class NonFiniteEscalation(RuntimeError):
    """``escalate_after`` consecutive non-finite steps under a
    skip/rollback policy: recovery is not converging.
    ``ResilientTrainer`` answers this with ``CheckpointManager.restore``."""


class StepFault(RuntimeError):
    """A step dispatch failed with a non-recoverable (or retry-exhausted)
    runtime error; the original exception is chained as ``__cause__``."""


class StepTimeout(StepFault, TimeoutError):
    """The watchdog's wall-clock deadline expired before the dispatch
    (and its health-flag read) completed.  Subclasses TimeoutError so
    stock ``RetryPolicy`` transient classes cover it.

    ``retry_safe`` records whether the timed-out attempt had launched on
    the state: once it did, the (still running) hung dispatch owns the
    state, and re-dispatching would race it — such a timeout classifies
    NON-transient and surfaces immediately.  A timeout before the launch
    (an injected chaos hang, a stall in host-side staging) is safely
    retryable."""

    def __init__(self, msg: str, retry_safe: bool = True):
        super().__init__(msg)
        self.retry_safe = retry_safe


class _DispatchControl:
    """Shared state between the watchdog (monitor thread) and one
    dispatch attempt (worker thread): ``cancelled`` is set when the
    deadline fires so an abandoned attempt must NOT go on to launch on
    the state a retry may be re-using; ``consumed`` is set by the
    attempt just before the launch, deciding StepTimeout's
    ``retry_safe``.  Both transitions go through one lock —
    ``begin_consume``/``cancel`` are atomic, so the monitor can never
    read consumed=False while the worker slips past the cancellation
    check into the launch."""

    __slots__ = ("cancelled", "consumed", "_lock")

    def __init__(self):
        self.cancelled = threading.Event()
        self.consumed = False
        self._lock = OrderedLock("guardrails.dispatch", RANK_GUARD)

    def begin_consume(self) -> bool:
        """Worker side: claim the state for the launch.  Returns False
        when the watchdog already abandoned this attempt (the worker
        must not touch the device)."""
        with self._lock:
            if self.cancelled.is_set():
                return False
            self.consumed = True
            return True

    def unconsume(self) -> None:
        """Worker side: the launch failed but the state is verifiably
        live again (``state_buffers_live``) — release the claim so the
        failure stays retryable.  No-op once the watchdog cancelled
        (the monitor already read the flag)."""
        with self._lock:
            if not self.cancelled.is_set():
                self.consumed = False

    def cancel(self) -> bool:
        """Monitor side: abandon the attempt; returns True when the
        attempt never claimed the state (safe to retry)."""
        with self._lock:
            self.cancelled.set()
            return not self.consumed


class GuardPolicy:
    """Recovery policy for guarded execution.

    Parameters
    ----------
    on_nonfinite: ``"raise"`` (surface :class:`NonFiniteError`; state
        stays pre-step), ``"skip"`` (drop the update — params
        byte-identical to pre-step) or ``"rollback"`` (republish the
        last-good snapshot, DELIBERATELY rewinding up to
        ``snapshot_every - 1`` healthy steps: rollback distrusts the
        recent trajectory — loss-scale blowups and optimizer-state
        poisoning precede the first non-finite value — where ``skip``
        trusts everything up to the bad batch).
    check: which value classes feed the sentinel — any subset of
        ``("loss", "grads", "params")``.  ``loss`` = the float fetches,
        ``grads`` = every parameter's ``@GRAD``, ``params`` = the
        post-update parameters.
    snapshot_every: rollback snapshot cadence in guarded steps (K).
    escalate_after: consecutive bad steps before
        :class:`NonFiniteEscalation` (M; 0 = never escalate).
    step_timeout: wall-clock seconds per dispatch before the watchdog
        fires ``StepTimeout`` (None or <= 0 = no watchdog; 0 is
        accepted as the conventional "off" so a config plumbing a
        numeric field through never arms an instant-fire deadline).
    retry: a ``RetryPolicy`` whose schedule/bounds govern re-dispatch
        of transient faults (classification is this module's
        ``classify_step_error``, not the policy's ``retryable`` set);
        None = no retries, transients surface structured.
    """

    def __init__(self, on_nonfinite: str = "raise",
                 check: Sequence[str] = _CHECKS,
                 snapshot_every: int = 10, escalate_after: int = 0,
                 step_timeout: Optional[float] = None,
                 retry: Optional[RetryPolicy] = None):
        if on_nonfinite not in _ON_NONFINITE:
            raise ValueError(f"on_nonfinite must be one of {_ON_NONFINITE}, "
                             f"got {on_nonfinite!r}")
        check = tuple(check)
        bad = [c for c in check if c not in _CHECKS]
        if bad or not check:
            raise ValueError(f"check must be a non-empty subset of "
                             f"{_CHECKS}, got {check!r}")
        self.on_nonfinite = on_nonfinite
        self.check = check
        self.snapshot_every = max(1, int(snapshot_every))
        self.escalate_after = max(0, int(escalate_after))
        if step_timeout is not None:
            step_timeout = float(step_timeout)
            if step_timeout <= 0:
                step_timeout = None
        self.step_timeout = step_timeout
        self.retry = retry
        # the guard-classified twin of `retry` is pure config — derive
        # it once, not per dispatch in the hot loop
        self._retry_effective = (None if retry is None
                                 else _effective_retry(retry))

    def __repr__(self):
        return (f"GuardPolicy(on_nonfinite={self.on_nonfinite!r}, "
                f"check={self.check}, snapshot_every={self.snapshot_every}, "
                f"escalate_after={self.escalate_after}, "
                f"step_timeout={self.step_timeout})")


# -- sentinel and gate ---------------------------------------------------------

class GuardedStep:
    """The guard of one step signature (``build_guarded_step_fn``): the
    pre-step copies of the state entries the step writes (``pre``), the
    0-d bool health flag on the device (``flag``), and the two halves
    the step's body runs around its ops:

    * ``save(state)`` — before the ops: copy each gated entry's value
      into its pre-step buffer (made at the first call, on the state's
      device, then reused at one address, so a captured graph replays
      the copies);
    * ``gate(env)`` — after the ops: ``flag`` = the sentinel over the
      checked values of ``env``, and each gated entry's new value in
      ``env`` becomes ``torch.where(flag, new, pre)``, in place.

    ``gated`` are the names of ``state_out`` with a pre-step twin in
    ``state_in``, neither a SeqArray; the rest of ``state_out`` (a
    write-only persistable, SeqArray state) passes through ungated, as
    in the reference.  ``saved`` is True once the pre-step copies of
    the current dispatch are complete (the executor's retry decision
    reads it; only an eagerly run body sets it)."""

    def __init__(self, state_in: Sequence[str], state_out: Sequence[str],
                 check_names: Sequence[str]):
        self.state_in = tuple(state_in)
        self.state_out = tuple(state_out)
        self.check_names = tuple(check_names)
        sin = set(self.state_in)
        self.gated = tuple(n for n in self.state_out if n in sin)
        self.pre: Dict[str, torch.Tensor] = {}
        self.flag: Optional[torch.Tensor] = None
        self.saved = False

    def save(self, state: Dict[str, Any]) -> None:
        self.saved = False
        dst, src = [], []
        for n in self.gated:
            v = state.get(n)
            if not isinstance(v, torch.Tensor):
                continue
            buf = self.pre.get(n)
            if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                self.pre[n] = v.clone()
            else:
                dst.append(buf)
                src.append(v)
        if dst:
            # multi-tensor copies: a launch per chunk of tensors, not one
            # a tensor
            torch._foreach_copy_(dst, src)
        self.saved = True

    def gate(self, env: Dict[str, Any]) -> torch.Tensor:
        healthy = _all_finite([env[n] for n in self.check_names
                               if n in env])
        if self.flag is None:
            self.flag = torch.ones((), dtype=torch.bool,
                                   device=healthy.device)
        self.flag.copy_(healthy)
        for n, pre in self.pre.items():
            v = env.get(n)
            if isinstance(v, torch.Tensor) and v.shape == pre.shape \
                    and v.dtype == pre.dtype:
                torch.where(self.flag, v, pre, out=v)
        return self.flag

    def restore(self, state: Dict[str, Any]) -> bool:
        """Put the pre-step copies back into ``state``'s tensors after a
        fault that came after the launch.  True when that makes the
        state exactly pre-step: the copies were complete and every entry
        the step writes in ``state`` is gated."""
        if not self.saved or any(
                n in state and (n not in self.pre
                                or not isinstance(state[n], torch.Tensor))
                for n in self.state_out):
            return False
        for n, pre in self.pre.items():
            if n in state:
                state[n].copy_(pre)
        return True

    def read(self) -> bool:
        """The health flag on the host: one wait for the card (a copy
        through pinned memory and one stream synchronize), none on the
        CPU."""
        flag = self.flag
        if flag.is_cuda:
            host = torch.empty((), dtype=torch.bool, pin_memory=True)
            host.copy_(flag, non_blocking=True)
            torch.cuda.current_stream(flag.device).synchronize()
            return bool(host)
        return bool(flag)


def _all_finite(values) -> torch.Tensor:
    """``misc_ops.all_finite`` for the sentinel, in few launches: the
    contiguous float tensors go through the AMP's multi-tensor check
    (``_amp_foreach_non_finite_check_and_unscale_`` with a scale of 1,
    which writes each value back unchanged: a launch per chunk of
    tensors of one dtype), the rest through ``isfinite().all()``.  It
    writes its inputs, so it runs only after the step's last op."""
    from ..fluid.core.lod import SeqArray
    from ..fluid.ops.misc_ops import all_finite

    by_dtype: Dict[Any, list] = {}
    rest = []
    for v in values:
        data = v.data if isinstance(v, SeqArray) else v
        if not (isinstance(data, torch.Tensor)
                and data.dtype.is_floating_point):
            continue                    # vacuously finite
        if data.dtype in _MULTI_TENSOR_DTYPES and data.is_contiguous() \
                and data.numel() > 0:
            by_dtype.setdefault(data.dtype, []).append(data)
        else:
            rest.append(data)
    flag = None
    if by_dtype:
        dev = next(iter(by_dtype.values()))[0].device
        found = torch.zeros(1, dtype=torch.float32, device=dev)
        one = torch.ones(1, dtype=torch.float32, device=dev)
        for group in by_dtype.values():
            torch._amp_foreach_non_finite_check_and_unscale_(group, found,
                                                             one)
        flag = found[0] == 0
    if rest:
        ok = all_finite(rest)
        flag = ok if flag is None else torch.logical_and(flag, ok)
    return all_finite(values) if flag is None else flag


_MULTI_TENSOR_DTYPES = (torch.float32, torch.float64, torch.float16,
                        torch.bfloat16)


def build_guarded_step_fn(desc=None, block_idx: int = 0,
                          feed_names: Sequence[str] = (),
                          state_in: Sequence[str] = (),
                          state_out: Sequence[str] = (),
                          fetch_names: Sequence[str] = (),
                          mode: str = "train",
                          check_names: Sequence[str] = ()) -> GuardedStep:
    """The guarded variant of a step, for the executor: a
    :class:`GuardedStep` whose ``save`` and ``gate`` the step's body runs
    before and after its ops.  ``flag`` — the AND of
    ``torch.isfinite(x).all()`` over every float value named in
    ``check_names`` — is computed in the body itself, so on the card the
    sentinel is part of the step's captured graph.  Every carried state
    entry is published through ``torch.where(flag, new, pre)``: a
    healthy step is bitwise-identical to the unguarded step, an
    unhealthy one leaves the state exactly pre-step.

    The reference builds a pure traced function ``(feeds, state, rng) ->
    (fetches, new_state, healthy)`` from ``desc``'s block ``block_idx``
    at ``feed_names`` / ``fetch_names`` / ``mode``.  The port's steps run
    in place on their buffers, inside the executor's captured body, so
    the guard is the two halves around that body's ops and takes only
    ``state_in``, ``state_out`` and ``check_names``: a step description
    (any of the other five parameters) raises NotImplementedError —
    guard a step through ``Executor.run(guard=...)``."""
    if desc is not None or block_idx != 0 or tuple(feed_names) \
            or tuple(fetch_names) or mode != "train":
        raise NotImplementedError(
            "build_guarded_step_fn builds no step function from a desc "
            "here: the guard wraps the executor's in-place step; use "
            "Executor.run(guard=GuardPolicy(...))")
    return GuardedStep(state_in, state_out, check_names)


# -- device-side snapshots ---------------------------------------------------

def device_snapshot(state: Dict[str, Any]) -> Dict[str, Any]:
    """Copy every state value into fresh tensors (on the value's device —
    no disk, no host round-trip).  No step writes the copies, so the
    snapshot stays restorable after any number of steps."""
    from ..fluid.core.lod import SeqArray

    def copy_one(v):
        if isinstance(v, SeqArray):
            return SeqArray(copy_one(v.data), copy_one(v.lengths))
        if isinstance(v, torch.Tensor):
            return v.detach().clone()
        if isinstance(v, np.ndarray):
            return v.copy()
        return v
    return {n: copy_one(v) for n, v in state.items()}


_LAUNCHED_ATTR = "_paddle_guard_launched"


def _state_tensors(state: Dict[str, Any]):
    from ..fluid.core.lod import SeqArray

    for v in state.values():
        for d in ((v.data, v.lengths) if isinstance(v, SeqArray) else (v,)):
            if isinstance(d, torch.Tensor):
                yield d


def mark_launched(state: Dict[str, Any], launched: bool = True) -> None:
    """Mark (or clear) the state's tensors as written by a launched
    dispatch that has not completed: the port's counterpart of the
    reference's donated-and-deleted buffers."""
    for t in _state_tensors(state):
        if launched:
            setattr(t, _LAUNCHED_ATTR, True)
        elif getattr(t, _LAUNCHED_ATTR, False):
            delattr(t, _LAUNCHED_ATTR)


def state_buffers_live(state: Dict[str, Any]) -> bool:
    """True when no state tensor was written by a launched dispatch that
    neither completed nor had its state restored (``mark_launched``):
    the retry may run on it as it stands.  The reference answers the
    same question with ``jax.Array.is_deleted`` over its donated
    buffers.  Host values (numpy) count live."""
    return not any(getattr(t, _LAUNCHED_ATTR, False)
                   for t in _state_tensors(state))


# -- chaos poisoning ---------------------------------------------------------

def poison_feed(feed: Dict[str, Any], inj) -> Dict[str, Any]:
    """Apply the ``guard.nan`` / ``guard.inf_grad`` injection points:
    when one fires, the first element of the first float feed (sorted
    by name, for a deterministic target) is replaced by NaN/Inf — the
    seeded stand-in for a corrupt batch or an exploding gradient.
    Returns a new feed dict; the caller's arrays and tensors are never
    mutated."""
    from ..fluid.core.lod import SeqArray

    for point, bad in (("guard.nan", np.nan), ("guard.inf_grad", np.inf)):
        if not inj.should(point):
            continue
        for name in sorted(feed):
            v = feed[name]
            data = v.data if isinstance(v, SeqArray) else v
            if isinstance(data, torch.Tensor):
                if not data.dtype.is_floating_point or data.numel() == 0:
                    continue
                arr = data.clone()
                arr.view(-1)[0] = bad
            else:
                arr = np.asarray(data)
                if not np.issubdtype(arr.dtype, np.floating) \
                        or arr.size == 0:
                    continue
                arr = arr.copy()
                arr.flat[0] = bad
            feed = dict(feed)
            feed[name] = (SeqArray(arr, v.lengths)
                          if isinstance(v, SeqArray) else arr)
            break
    return feed


# -- watchdog + transient retry ----------------------------------------------

# attribute stamped on an exception raised AFTER the attempt launched on
# the state: retrying would run a second step over a partly written
# state, so even transient-shaped errors classify fatal
_CONSUMED_ATTR = "_guardrail_buffers_consumed"


def _transient_shaped(exc: BaseException) -> bool:
    """The error CLASS looks transient (ignoring the launch)."""
    if isinstance(exc, StepTimeout):
        return exc.retry_safe
    return isinstance(exc, (ConnectionError, TimeoutError))


def classify_step_error(exc: BaseException) -> bool:
    """True when a dispatch failure is worth re-dispatching: injected
    chaos (ChaosError is a ConnectionError), watchdog timeouts whose
    attempt never launched (``retry_safe``), and plain transport
    errors.  Shape/user errors, CUDA errors (a device fault poisons the
    context: nothing in-process re-runs on it) — and ANY error raised
    after the attempt launched on a state it could not restore —
    classify fatal."""
    if getattr(exc, _CONSUMED_ATTR, False):
        return False
    return _transient_shaped(exc)


def _effective_retry(retry: RetryPolicy) -> RetryPolicy:
    """The caller's policy owns the schedule and bounds; the guard owns
    transiency classification (``classify_step_error``)."""
    return RetryPolicy(max_attempts=retry.max_attempts,
                       deadline=retry.deadline,
                       base_delay=retry.base_delay,
                       max_delay=retry.max_delay,
                       retryable=(Exception,),
                       retry_if=classify_step_error,
                       seed=retry._seed, sleep=retry._sleep,
                       clock=retry._clock)


def _run_with_deadline(thunk, deadline: Optional[float], stats: Dict[str, int]):
    """Run ``thunk(ctl)`` under a wall-clock deadline: the dispatch
    executes on a worker thread while this (monitor) thread waits.  On
    expiry the attempt is cancelled (so an abandoned pre-launch stall
    cannot later launch on the state a retry re-uses) and a
    :class:`StepTimeout` surfaces immediately — a replay already queued
    on the card cannot be interrupted from Python; surfacing the hang is
    the watchdog's whole job."""
    ctl = _DispatchControl()

    def call():
        try:
            return thunk(ctl)
        except StepFault:
            raise
        except Exception as e:
            if ctl.consumed:
                # raised from inside (or after) the launch, on a state
                # that was not restored: poison any retry decision
                setattr(e, _CONSUMED_ATTR, True)
            raise

    if deadline is None:
        return call()
    box: Dict[str, Any] = {}
    done = threading.Event()

    def work():
        try:
            box["value"] = call()
        except BaseException as e:      # noqa: B036 — relayed to caller
            box["error"] = e
        finally:
            done.set()

    worker = threading.Thread(target=work, daemon=True,
                              name="guardrail-dispatch")
    worker.start()
    if not done.wait(deadline):
        retry_safe = ctl.cancel()       # atomic with begin_consume
        stats["watchdog_fires"] += 1
        raise StepTimeout(
            f"step dispatch exceeded the {deadline:.3f}s watchdog deadline "
            f"(device hung, or the step is still building and capturing — "
            f"warm up or raise GuardPolicy.step_timeout)",
            retry_safe=retry_safe)
    if "error" in box:
        raise box["error"]
    return box["value"]


def dispatch_guarded(thunk, policy: GuardPolicy,
                     stats: Dict[str, int]) -> Tuple:
    """Run one step dispatch under the policy's watchdog deadline,
    retrying transient faults through its RetryPolicy.  ``thunk`` is
    called as ``thunk(ctl)`` with a fresh :class:`_DispatchControl` per
    attempt — it must honor ``ctl.cancelled`` (abort without touching
    the device) and set ``ctl.consumed`` just before the launch.
    Counts ``watchdog_fires`` and ``retries`` into ``stats``; surfaces
    :class:`StepTimeout` / :class:`StepFault` when recovery runs out."""
    attempts = {"n": 0}

    def attempt():
        attempts["n"] += 1
        return _run_with_deadline(thunk, policy.step_timeout, stats)

    try:
        if policy._retry_effective is not None:
            return policy._retry_effective.call(attempt)
        return attempt()
    except (StepFault, NonFiniteError, NonFiniteEscalation):
        raise
    except Exception as exc:
        # structure (a) transient-shaped faults that ran out of retries
        # and (b) ANY error raised after the launch — the executor's
        # StepFault handler republishes the rollback snapshot precisely
        # because such a scope may hold a partly written state
        if _transient_shaped(exc) or getattr(exc, _CONSUMED_ATTR, False):
            raise StepFault(
                f"step fault not recovered "
                f"({type(exc).__name__}: {exc})") from exc
        raise
    finally:
        stats["retries"] += max(0, attempts["n"] - 1)
