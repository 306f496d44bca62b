"""ReleaseController — the supervised train→evaluate→deploy loop; the
port of ``paddle_tpu/lifecycle/controller.py``.

The reference's deployment story was the full cycle — trainers push
parameters, servers pick them up, operators roll back bad pushes
(PAPERS.md "TensorFlow: a system for large-scale ML"); every subsystem
of that cycle now exists in this repo and this module is what connects
them.  One controller owns one model alias and drives each published
candidate through a gated pipeline:

    discover -> evaluate (offline quality gate)
             -> canary   (deterministic slice of live traffic)
             -> observe  (live paddle_gateway_* series)
             -> promote | rollback

* **discover** — versions appear in the model store (the trainer's
  ``CandidatePublisher``/``GeneratorPublisher`` staged publishes) or
  are offered in-process via ``offer()``.  Rejected and rolled-back
  versions are never reconsidered.
* **evaluate** — ``eval_fn(instance) -> score`` (the quality
  harness shape: mnist top-1, NMT BLEU) gated against ``min_eval`` and
  against the last good version's score minus ``max_eval_delta``.  A
  candidate that fails never touches traffic.
* **canary** — the survivor takes a seeded, deterministic
  ``canary_fraction`` of the alias's admissions through the
  scheduler's pluggable ``admission_policy`` hook
  (``lifecycle.CanarySlice`` wrapping the TenantRouter policy); the
  stable version keeps the rest.  Engine artifacts (no decode lanes)
  skip the canary — the offline gate is their whole pipeline.
* **observe** — the verdict reads the LIVE telemetry the gateway
  already exports: per-version finished/failed deltas from
  ``paddle_gateway_requests_total``, windowed p95 from
  ``paddle_gateway_version_latency_seconds`` (cumulative-bucket
  differencing via ``observability.metrics.bucket_percentile``), the
  ``paddle_serving_queue_depth`` gauge, plus live per-version quality
  probes (pinned ``name@version`` submissions scored by
  ``quality_fn``).
* **promote** — atomic alias flip (``ModelRegistry.set_alias``), drain
  + unload the old version, durable ``CURRENT`` marker in the store.
  **rollback** — uninstall the canary policy FIRST (queued
  canary-pinned requests fall back to the alias — zero lost), then
  drain + unload the candidate.

Every transition is journaled (``ReleaseJournal``, fsynced jsonl with
torn-tail-tolerant replay): ``resume()`` after a crash/restart reloads
the stable version, re-arms a mid-flight canary with the journaled
fraction+seed, and continues observing — it never re-promotes blind.
Operator ``promote``/``rollback`` directives appended by the lifecycle
CLI ride the same journal and are applied at the next ``step()``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

from ..fluid import io as fio
from ..observability import metrics as _obs_metrics
from ..observability.metrics import bucket_percentile
from ..utils.sync import RANK_LIFECYCLE, OrderedLock
from .canary import CanarySlice
from .journal import ReleaseJournal, ReleaseState

__all__ = ["ReleaseConfig", "ReleaseController"]

_REQ_SERIES = "paddle_gateway_requests_total"
_LAT_SERIES = "paddle_gateway_version_latency_seconds"
_DEPTH_SERIES = "paddle_serving_queue_depth"


class ReleaseConfig:
    """Knobs for one model's release pipeline (plain data — everything
    here is journal-able; callables live on the controller)."""

    def __init__(self, model: str, *, n_slots: Optional[int] = None,
                 canary_fraction: float = 0.25,
                 canary_requests: int = 8,
                 canary_timeout_s: float = 600.0,
                 max_error_rate: float = 0.0,
                 p95_ratio: float = 3.0, p95_floor_s: float = 0.05,
                 max_queue_depth: Optional[int] = None,
                 min_eval: Optional[float] = None,
                 max_eval_delta: float = 0.0,
                 min_quality: Optional[float] = None,
                 max_quality_delta: float = 0.0,
                 probe_prompts: Optional[List] = None,
                 probe_max_new: Optional[int] = None,
                 probe_tenant: str = "release-probe",
                 probe_timeout_s: float = 30.0, seed: int = 0):
        if not 0.0 < float(canary_fraction) <= 1.0:
            raise ValueError(
                f"canary_fraction={canary_fraction}: want (0, 1]")
        self.model = str(model)
        self.n_slots = n_slots
        self.canary_fraction = float(canary_fraction)
        # successful candidate completions required before a verdict
        self.canary_requests = int(canary_requests)
        # no verdict by then (e.g. no traffic) -> rollback, not limbo
        self.canary_timeout_s = float(canary_timeout_s)
        # candidate failed/total above this -> immediate rollback
        self.max_error_rate = float(max_error_rate)
        # candidate windowed p95 must stay under
        # max(p95_floor_s, stable_p95 * p95_ratio); the floor keeps a
        # near-zero stable p95 from making the ratio gate vacuous
        self.p95_ratio = float(p95_ratio)
        self.p95_floor_s = float(p95_floor_s)
        self.max_queue_depth = (None if max_queue_depth is None
                                else int(max_queue_depth))
        # offline eval gate (eval_fn score)
        self.min_eval = None if min_eval is None else float(min_eval)
        self.max_eval_delta = float(max_eval_delta)
        # live probe gate (quality_fn score over probe_prompts)
        self.min_quality = (None if min_quality is None
                            else float(min_quality))
        self.max_quality_delta = float(max_quality_delta)
        self.probe_prompts = list(probe_prompts or [])
        # decode cap for probe submissions — MUST match whatever the
        # quality_fn's reference outputs were generated with, or the
        # comparison is over different-length sequences
        self.probe_max_new = (None if probe_max_new is None
                              else int(probe_max_new))
        self.probe_tenant = str(probe_tenant)
        self.probe_timeout_s = float(probe_timeout_s)
        self.seed = int(seed)

    def to_dict(self) -> Dict:
        out = dict(self.__dict__)
        out["probe_prompts"] = len(self.probe_prompts)
        return out


class ReleaseController:
    """Drive one model alias through candidate → canary → promote/
    rollback against a live ``Gateway``.  ``step()`` advances the state
    machine one transition (tests and the CLI drive it directly);
    ``run()`` polls it in a loop."""

    def __init__(self, gateway, config: ReleaseConfig, *,
                 journal_path: str, root: Optional[str] = None,
                 eval_fn: Optional[Callable] = None,
                 quality_fn: Optional[Callable] = None,
                 loader: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.gw = gateway
        self.cfg = config
        self.root = root if root is not None else gateway.registry.root
        self.eval_fn = eval_fn
        # quality_fn(prompt, tokens) -> score for the live probes
        self.quality_fn = quality_fn
        # loader(version) -> instance for stores without artifact dirs
        # (tests, in-process candidates); None loads from self.root
        self.loader = loader
        self._clock = clock
        # guards the mutable pipeline state (state sets/canary dict,
        # the offer queue) against concurrent readers: status() runs on
        # ObservabilityServer HTTP threads and offer() on the trainer's
        # publish thread, while step() mutates — sorted() over a set
        # being mutated mid-step raised).  Ranked
        # at the very top of the order: step() acquires scheduler /
        # registry / journal locks while holding it.
        self._lock = OrderedLock("lifecycle.controller", RANK_LIFECYCLE)
        self.journal = ReleaseJournal(journal_path)
        self.state: ReleaseState = self.journal.state()
        self._canary: Optional[CanarySlice] = None
        self._marks: Optional[Dict] = None
        self._deadline: Optional[float] = None
        self._offers: List[Tuple[str, object]] = []
        self._last_window: Dict = {}
        reg = _obs_metrics.registry()
        self._m_transitions = reg.counter(
            "paddle_lifecycle_transitions_total",
            "Release-pipeline transitions by event",
            labels=("event",))
        self._g_in_canary = reg.gauge(
            "paddle_lifecycle_in_canary",
            "1 while a canary slice is installed")
        self._g_in_canary.set(0.0)
        if self.state.last_good is None:
            cur = gateway.registry.current_key(self.cfg.model)
            if cur is not None:
                # adopt what is already serving as the initial good
                # version, durably — rollback needs a floor to land on
                version = cur.split("@", 1)[-1]
                self.journal.append("init", model=self.cfg.model,
                                    last_good=version)
                self.state = self.journal.state()

    # -- candidate intake ----------------------------------------------------
    def offer(self, version: str, instance=None) -> None:
        """Queue an in-process candidate (takes precedence over disk
        discovery; duplicates of seen/bad versions are dropped at
        consideration time).  Thread-safe: the trainer's publish hook
        calls this from its own thread."""
        with self._lock:
            self._offers.append((str(version), instance))

    def _next_candidate(self) -> Optional[Tuple[str, object]]:
        while True:
            with self._lock:
                if not self._offers:
                    break
                version, instance = self._offers.pop(0)
            if not self._considered(version):
                return version, instance
        if self.root is not None:
            for version in fio.list_model_versions(self.root,
                                                   self.cfg.model):
                if not self._considered(version):
                    return version, None
        return None

    def _considered(self, version: str) -> bool:
        return (version in self.state.seen or version in self.state.bad
                or version == self.state.last_good)

    # -- the state machine ---------------------------------------------------
    def step(self) -> str:
        """Advance one transition; returns what happened:
        ``idle`` / ``rejected`` / ``promoted`` / ``canary-started`` /
        ``canary`` (still observing) / ``rollback`` /
        ``directive-*``."""
        self._refresh_directives()
        did = self._apply_directive()
        if did is not None:
            return did
        if self._canary is not None:
            return self._observe()
        if self.state.canary is not None:
            # the journal says mid-canary but nothing is armed (a fresh
            # controller that skipped resume()): re-arm, never
            # re-promote blind
            self._rearm_from_state()
            return "canary-armed"
        nxt = self._next_candidate()
        if nxt is None:
            return "idle"
        return self._consider(*nxt)

    def run(self, poll_interval: float = 0.5,
            max_steps: Optional[int] = None) -> int:
        """Poll ``step()`` until ``max_steps`` transitions (None = run
        until interrupted); returns the number of steps taken."""
        steps = 0
        try:
            while max_steps is None or steps < max_steps:
                self.step()
                steps += 1
                time.sleep(poll_interval)
        except KeyboardInterrupt:
            pass
        return steps

    # -- loading -------------------------------------------------------------
    def _load(self, version: str, instance=None) -> str:
        if instance is None and self.loader is not None:
            instance = self.loader(version)
        return self.gw.load_model(self.cfg.model, version,
                                  instance=instance,
                                  n_slots=self.cfg.n_slots)

    def _unload(self, key: str) -> None:
        try:
            self.gw.unload_model(key)
        except KeyError:
            # engine artifacts own no lane group: registry-only unload
            self.gw.registry.unload(key)

    # -- evaluate ------------------------------------------------------------
    def _eval_gate(self, key: str) -> Tuple[bool, Optional[float], str]:
        if self.eval_fn is None:
            return True, None, ""
        try:
            score = float(self.eval_fn(self.gw.registry.instance(key)))
        except Exception as e:
            return False, None, f"eval_error:{type(e).__name__}"
        if self.cfg.min_eval is not None and score < self.cfg.min_eval:
            return False, score, "eval_below_min"
        if self.state.last_good_score is not None and \
                score < self.state.last_good_score \
                - self.cfg.max_eval_delta:
            return False, score, "eval_regression"
        return True, score, ""

    def _consider(self, version: str, instance=None) -> str:
        # journal FIRST (its own rank-52 file lock; fsync must never
        # run under the controller lock — the exact stall class this
        # PR's lint exists to catch), then commit the in-memory state
        # under the lock.  A crash in the gap loses nothing: the state
        # is a fold of the journal and rebuilds on resume.
        name = self.cfg.model
        self.journal.append("candidate", version=version)
        with self._lock:
            self.state.seen.add(version)
        self._m_transitions.labels(event="candidate").inc()
        first = self.gw.registry.current_key(name) is None
        try:
            key = self._load(version, instance)
        except Exception as e:
            self.journal.append(
                "rejected", version=version, reason="load_failed",
                error=f"{type(e).__name__}: {e}"[:200])
            with self._lock:
                self.state.bad.add(version)
            self._m_transitions.labels(event="rejected").inc()
            return "rejected"
        ok, score, reason = self._eval_gate(key)
        if not ok:
            try:
                self._unload(key)
            except Exception:
                pass
            self.journal.append("rejected", version=version,
                                reason=reason, score=score)
            with self._lock:
                self.state.bad.add(version)
            self._m_transitions.labels(event="rejected").inc()
            return "rejected"
        inst = self.gw.registry.instance(key)
        laned = callable(getattr(inst, "open_slots", None))
        if first or not laned:
            # nothing serving yet (no traffic to split) or an engine
            # artifact (no decode lanes to canary on): the offline gate
            # is the whole pipeline — promote directly
            return self._promote_direct(version, score, first=first)
        self._arm_canary(version, self.cfg.canary_fraction,
                         self.cfg.seed, score)
        return "canary-started"

    # -- canary --------------------------------------------------------------
    def _arm_canary(self, version: str, fraction: float, seed: int,
                    score: Optional[float], journal: bool = True) -> None:
        name = self.cfg.model
        stable_key = self.gw.registry.current_key(name)
        stable_version = stable_key.split("@", 1)[-1]
        # chain onto whatever policy is installed RIGHT NOW — another
        # controller's canary for a different alias may already be in
        # place, and clobbering it would starve that canary to a
        # timeout rollback.  Slices compose: each routes only its own
        # alias and delegates the pick down the chain.
        slc = CanarySlice(name, stable_key, f"{name}@{version}",
                          fraction, seed=seed,
                          inner=self.gw.sched.admission_policy)
        self.gw.sched.admission_policy = slc.admission_policy
        # the in-memory handle is set BEFORE the (fallible, fsynced)
        # journal append: if the append raises, _uninstall_canary can
        # still splice the installed slice back out — an orphaned
        # policy routing live traffic with no handle would be
        # unremovable.  The append itself stays outside the controller
        # lock (see _consider).
        with self._lock:
            self._canary = slc
            self._marks = self._take_marks(version, stable_version)
            self._deadline = self._clock() + self.cfg.canary_timeout_s
            self._last_window = {}
            self.state.canary = {"version": version,
                                 "fraction": fraction,
                                 "seed": seed, "score": score}
        if journal:
            self.journal.append("canary-start", version=version,
                                fraction=fraction, seed=seed,
                                score=score, stable=stable_version)
        self._g_in_canary.set(1.0)
        if journal:
            self._m_transitions.labels(event="canary_start").inc()

    def _uninstall_canary(self) -> None:
        """Splice OUR slice out of the admission-policy chain — another
        controller may have chained its own slice on top since we
        armed, and it must survive our verdict."""
        slc = self._canary
        if slc is not None:
            mine = slc.admission_policy
            cur = self.gw.sched.admission_policy
            if cur == mine:
                self.gw.sched.admission_policy = slc.inner
            else:
                p = cur
                while p is not None and isinstance(
                        getattr(p, "__self__", None), CanarySlice):
                    outer = p.__self__
                    if outer.inner == mine:
                        outer.inner = slc.inner
                        break
                    p = outer.inner
        with self._lock:
            self._canary = None
            self._marks = None
            self._deadline = None
        self._g_in_canary.set(0.0)

    def _rearm_from_state(self) -> None:
        c = self.state.canary
        name = self.cfg.model
        if self.gw.registry.current_key(name) is None \
                and self.state.last_good is not None:
            self._load(self.state.last_good)
        try:
            self.gw.registry.instance(f"{name}@{c['version']}")
        except KeyError:
            self._load(c["version"])
        self._arm_canary(c["version"], c["fraction"], c["seed"],
                         c.get("score"), journal=False)

    def _observe(self) -> str:
        """One verdict check against the live series; promotes, rolls
        back, or keeps observing."""
        cand = self.state.canary["version"]
        counts = self._window_requests()
        finished = counts.get((cand, "finished"), 0)
        failed = counts.get((cand, "failed"), 0)
        total = finished + failed
        self._last_window = {"finished": finished, "failed": failed}
        if failed > 0 and failed / max(1, total) > self.cfg.max_error_rate:
            return self._rollback("error_rate",
                                  {"failed": failed, "total": total})
        depth = self._queue_depth()
        if self.cfg.max_queue_depth is not None and depth is not None \
                and depth > self.cfg.max_queue_depth:
            return self._rollback("queue_depth", {"depth": depth})
        if finished < self.cfg.canary_requests:
            if self._deadline is not None \
                    and self._clock() > self._deadline:
                return self._rollback("timeout",
                                      {"finished": finished,
                                       "needed":
                                       self.cfg.canary_requests})
            return "canary"
        # window complete: price the candidate's tail latency against
        # the stable version's over the SAME window
        stable = self.state.last_good
        cand_p95 = self._window_p95(cand)
        stable_p95 = self._window_p95(stable)
        if cand_p95 is not None:
            bound = max(self.cfg.p95_floor_s,
                        (stable_p95 or 0.0) * self.cfg.p95_ratio)
            if cand_p95 > bound:
                return self._rollback(
                    "p95", {"cand_p95_s": round(cand_p95, 4),
                            "stable_p95_s":
                            None if stable_p95 is None
                            else round(stable_p95, 4),
                            "bound_s": round(bound, 4)})
        probes = self._probe_scores(stable, cand)
        if probes is not None:
            cand_q, stable_q = probes["canary"], probes["stable"]
            if (self.cfg.min_quality is not None
                    and cand_q < self.cfg.min_quality) or \
                    cand_q < stable_q - self.cfg.max_quality_delta:
                return self._rollback(
                    "quality", {"cand_quality": round(cand_q, 4),
                                "stable_quality": round(stable_q, 4)})
        return self._promote()

    # -- verdict actions -----------------------------------------------------
    def _promote_direct(self, version: str, score: Optional[float],
                        first: bool) -> str:
        """Promote without a canary (first version, or an engine
        artifact with no lanes to slice traffic on)."""
        name = self.cfg.model
        old_key = self.gw.registry.current_key(name)
        if old_key == f"{name}@{version}":
            old_key = None          # first version: it IS the alias
        self.gw.registry.set_alias(name, version)
        if old_key is not None:
            self._drain_old(old_key)
        self._finish_promote(version, score,
                             old_key.split("@", 1)[-1]
                             if old_key else None,
                             canary=False)
        return "promoted"

    def _promote(self, operator: bool = False) -> str:
        cand = self.state.canary["version"]
        score = self.state.canary.get("score")
        name = self.cfg.model
        self._uninstall_canary()
        old_key = self.gw.registry.current_key(name)
        self.gw.registry.set_alias(name, cand)
        if old_key is not None and old_key != f"{name}@{cand}":
            self._drain_old(old_key)
        self._finish_promote(cand, score,
                             old_key.split("@", 1)[-1]
                             if old_key else None,
                             canary=True, operator=operator)
        return "promoted"

    def _drain_old(self, old_key: str) -> None:
        try:
            self.gw.sched.remove_model(old_key, drain=True)
        except KeyError:
            pass                    # engine artifact: no lane group
        self.gw.registry.unload(old_key)
        name, _, version = old_key.partition("@")
        if version:
            self.gw.drop_version_series(name, version)

    def _finish_promote(self, version: str, score: Optional[float],
                        from_version: Optional[str], canary: bool,
                        operator: bool = False) -> None:
        if self.root is not None:
            fio.set_current_version(self.root, self.cfg.model, version)
        entry = {"version": version, "from": from_version,
                 "canary": canary}
        if score is not None:
            entry["score"] = score
        if operator:
            entry["operator"] = True
        self.journal.append("promoted", **entry)
        with self._lock:
            self.state.last_good = version
            if score is not None:
                self.state.last_good_score = score
            self.state.seen.add(version)
            self.state.canary = None
        self._m_transitions.labels(event="promoted").inc()

    def _rollback(self, reason: str, detail: Optional[Dict] = None,
                  operator: bool = False) -> str:
        cand = self.state.canary["version"]
        name = self.cfg.model
        # uninstall FIRST: queued canary-pinned requests must fall back
        # to the alias when the group drains away, and no NEW pins may
        # be handed out while it does
        self._uninstall_canary()
        cand_key = f"{name}@{cand}"
        try:
            self.gw.sched.remove_model(cand_key, drain=True)
        except KeyError:
            pass
        try:
            self.gw.registry.unload(cand_key)
        except KeyError:
            pass
        # the rolled-back version never serves again: retire its
        # per-version series so the continual loop's label space stays
        # bounded by LOADED versions, not versions ever canaried
        self.gw.drop_version_series(name, cand)
        entry = {"version": cand, "to": self.state.last_good,
                 "reason": reason}
        if detail:
            entry["detail"] = detail
        if operator:
            entry["operator"] = True
        self.journal.append("rollback", **entry)
        with self._lock:
            self.state.bad.add(cand)
            self.state.canary = None
        self._m_transitions.labels(event="rollback").inc()
        return "rollback"

    # -- live-series reads ---------------------------------------------------
    def _requests_series(self) -> Dict[Tuple[str, str], float]:
        """{(version, event): count} for this model from the gateway's
        request-lifecycle counter (pinned ``name@ver`` submissions fold
        into the same base name)."""
        fam = _obs_metrics.registry().get(_REQ_SERIES)
        out: Dict[Tuple[str, str], float] = {}
        if fam is None:
            return out
        for vals, child in fam.children():
            labels = dict(zip(fam.label_names, vals))
            if labels.get("model", "").split("@", 1)[0] != self.cfg.model:
                continue
            key = (labels.get("version", "?"), labels.get("event", "?"))
            out[key] = out.get(key, 0.0) + child.value
        return out

    def _latency_cum(self, version: Optional[str]):
        """(bucket edges, cumulative counts) for one version's latency
        histogram, summed across label children; None when absent."""
        if version is None:
            return None
        fam = _obs_metrics.registry().get(_LAT_SERIES)
        if fam is None:
            return None
        edges, total = None, None
        for vals, child in fam.children():
            labels = dict(zip(fam.label_names, vals))
            if labels.get("model") != self.cfg.model \
                    or labels.get("version") != str(version):
                continue
            cum, _, _ = child.snapshot()
            if total is None:
                edges, total = child.buckets, list(cum)
            else:
                total = [a + b for a, b in zip(total, cum)]
        return None if total is None else (edges, total)

    def _take_marks(self, cand: str, stable: Optional[str]) -> Dict:
        return {"requests": self._requests_series(),
                "latency": {v: self._latency_cum(v)
                            for v in (cand, stable) if v is not None}}

    def _window_requests(self) -> Dict[Tuple[str, str], float]:
        now = self._requests_series()
        base = (self._marks or {}).get("requests", {})
        return {k: v - base.get(k, 0.0) for k, v in now.items()
                if v - base.get(k, 0.0) > 0}

    def _window_p95(self, version: Optional[str]) -> Optional[float]:
        now = self._latency_cum(version)
        if now is None:
            return None
        edges, cum = now
        mark = (self._marks or {}).get("latency", {}).get(version)
        if mark is not None:
            _, mcum = mark
            cum = [a - b for a, b in zip(cum, mcum)]
        return bucket_percentile(edges, cum, 95)

    def _queue_depth(self) -> Optional[float]:
        """The live scheduler queue-depth gauge (a collector series —
        read through the snapshot)."""
        snap = _obs_metrics.registry().snapshot()
        for fam in snap["metrics"]:
            if fam["name"] == _DEPTH_SERIES and fam["samples"]:
                return float(fam["samples"][0]["value"])
        return None

    # -- live quality probes -------------------------------------------------
    def _probe_scores(self, stable: Optional[str],
                      cand: str) -> Optional[Dict[str, float]]:
        """Mean quality_fn score per version over pinned probe
        submissions (``name@version`` bypasses the canary slice and the
        alias); None when probes are not configured."""
        if not self.cfg.probe_prompts or self.quality_fn is None \
                or stable is None:
            return None
        out = {}
        for tag, version in (("stable", stable), ("canary", cand)):
            key = f"{self.cfg.model}@{version}"
            reqs = []
            for p in self.cfg.probe_prompts:
                try:
                    reqs.append((p, self.gw.submit(
                        key, p, tenant=self.cfg.probe_tenant,
                        max_new=self.cfg.probe_max_new)))
                except Exception:
                    reqs.append((p, None))
            if self.gw.sched._thread is None:
                self.gw.run_until_idle()
            scores = []
            for p, r in reqs:
                score = 0.0
                if r is not None and r.wait(self.cfg.probe_timeout_s) \
                        and r.error is None:
                    try:
                        score = float(self.quality_fn(p, list(r.tokens)))
                    except Exception:
                        score = 0.0
                scores.append(score)
            out[tag] = sum(scores) / max(1, len(scores))
        return out

    # -- operator directives -------------------------------------------------
    def _refresh_directives(self) -> None:
        """Directives are appended by the lifecycle CLI — usually from
        another process — so each step re-reads the journal for new,
        unacknowledged ones (the journal is tiny; the fold is cheap)."""
        fresh = self.journal.state().directives
        with self._lock:
            known = {d.get("_seq") for d in self.state.directives}
            for d in fresh:
                if d.get("_seq") not in known:
                    self.state.directives.append(d)

    def _apply_directive(self) -> Optional[str]:
        """Apply (at most) the oldest pending operator directive from
        the journal; returns None when there is none."""
        with self._lock:
            if not self.state.directives:
                return None
            d = self.state.directives.pop(0)
        seq = d.get("_seq")
        action = d.get("action")
        version = d.get("version")
        try:
            if d.get("model") not in (None, self.cfg.model):
                # a directive journaled for another model (wrong
                # --journal path): refusing loudly beats promoting an
                # unvetted version under the wrong alias
                raise ValueError(
                    f"directive names model {d.get('model')!r}; this "
                    f"controller owns {self.cfg.model!r}")
            if action == "promote":
                self._directive_promote(version)
            elif action == "rollback":
                self._directive_rollback(version)
            else:
                raise ValueError(f"unknown directive action {action!r}")
        except Exception as e:
            self.journal.append("directive-done", seq=seq, ok=False,
                                error=f"{type(e).__name__}: {e}"[:200])
            self._m_transitions.labels(event="directive").inc()
            return "directive-failed"
        self.journal.append("directive-done", seq=seq, ok=True)
        self._m_transitions.labels(event="directive").inc()
        return f"directive-{action}"

    def _directive_promote(self, version: Optional[str]) -> None:
        if version is None:
            raise ValueError("promote directive needs a version")
        version = str(version)
        name = self.cfg.model
        if self._canary is not None:
            if self.state.canary["version"] != version:
                raise ValueError(
                    f"mid-canary of {self.state.canary['version']}; "
                    f"only that version can be operator-promoted")
            self._promote(operator=True)
            return
        if version == self.state.last_good:
            return                               # already serving
        old_key = self.gw.registry.current_key(name)
        try:
            self.gw.registry.instance(f"{name}@{version}")
        except KeyError:
            self._load(version)
        self.gw.registry.set_alias(name, version)
        if old_key is not None and old_key != f"{name}@{version}":
            self._drain_old(old_key)
        self._finish_promote(version, None,
                             old_key.split("@", 1)[-1]
                             if old_key else None,
                             canary=False, operator=True)

    def _directive_rollback(self, version: Optional[str]) -> None:
        if self._canary is not None:
            self._rollback("operator", operator=True)
            return
        if version is None:
            raise ValueError("rollback directive outside a canary "
                             "needs a target version")
        version = str(version)
        name = self.cfg.model
        old_key = self.gw.registry.current_key(name)
        old_version = (old_key.split("@", 1)[-1]
                       if old_key is not None else None)
        if version == old_version:
            return                               # already serving
        try:
            self.gw.registry.instance(f"{name}@{version}")
        except KeyError:
            self._load(version)
        self.gw.registry.set_alias(name, version)
        if old_key is not None:
            self._drain_old(old_key)
        if self.root is not None:
            fio.set_current_version(self.root, name, version)
        self.journal.append("rollback", version=old_version,
                            to=version, reason="operator",
                            operator=True)
        with self._lock:
            if old_version is not None:
                self.state.bad.add(old_version)
            self.state.last_good = version
            self.state.canary = None
        self._m_transitions.labels(event="rollback").inc()

    # -- recovery ------------------------------------------------------------
    def resume(self) -> Dict:
        """After a restart: rebuild the serving state the journal
        describes — load + alias the last good version, and when the
        journal says mid-canary, reload the candidate and re-arm the
        canary with the journaled fraction+seed (a fresh observation
        window) instead of re-promoting blind.  Call AFTER the gateway
        exists (and after ``Gateway.recover()`` if a request journal is
        in play — replayed requests must find the stable alias)."""
        # fold the journal OUTSIDE the lock (file read + JSON parse —
        # the _refresh_directives shape); only the swap is locked
        st = self.journal.state()
        with self._lock:
            self.state = st
        name = self.cfg.model
        actions = []
        if self.state.last_good is not None:
            want = f"{name}@{self.state.last_good}"
            cur = self.gw.registry.current_key(name)
            if cur is None:
                self._load(self.state.last_good)
                actions.append(f"loaded stable {self.state.last_good}")
            elif cur != want:
                try:
                    self.gw.registry.instance(want)
                except KeyError:
                    self._load(self.state.last_good)
                self.gw.registry.set_alias(name, self.state.last_good)
                actions.append(f"re-aliased to {self.state.last_good}")
        if self.state.canary is not None:
            self._rearm_from_state()
            actions.append(
                f"re-armed canary {self.state.canary['version']}")
        self.journal.append("resume",
                            canary=self.state.canary is not None,
                            actions=actions)
        self._m_transitions.labels(event="resume").inc()
        return {"actions": actions,
                "canary": self.state.canary is not None}

    # -- accounting ----------------------------------------------------------
    def status(self) -> Dict:
        """JSON-able rollup — a duck-typed ObservabilityServer /statusz
        source.  Snapshots the mutable state under the controller lock
        (an HTTP thread sorting a set that step() is mutating raised);
        the file-system reads below run outside it."""
        with self._lock:
            out = {"model": self.cfg.model,
                   "last_good": self.state.last_good,
                   "last_good_score": self.state.last_good_score,
                   "bad_versions": sorted(self.state.bad),
                   "pending_directives": len(self.state.directives),
                   "config": self.cfg.to_dict()}
            canary, state_canary = self._canary, self.state.canary
            last_window = dict(self._last_window)
        if canary is not None:
            out["canary"] = canary.stats()
            out["canary"]["window"] = last_window
        elif state_canary is not None:
            out["canary"] = dict(state_canary)
        depth = self._queue_depth()
        if depth is not None:
            out["queue_depth"] = depth
        if self.root is not None:
            out["versions_on_disk"] = fio.list_model_versions(
                self.root, self.cfg.model)
            out["current_marker"] = fio.current_model_version(
                self.root, self.cfg.model)
        return out
