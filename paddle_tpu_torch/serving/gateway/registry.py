"""ModelRegistry: versioned model artifacts, HBM budgeting, alias flips —
the port's copy of ``paddle_tpu/serving/gateway/registry.py``.

The registry makes models data, not processes:

* **versioned artifact layout** (fluid/io.py helpers): each version of
  a model lives at ``<root>/<name>/<version>/`` — either a standard
  ``save_inference_model`` directory (served by an ``InferenceEngine``,
  fp32 or int8 via the PTQ flag) or a *generator artifact*
  (``save_generator_artifact``: the paged decoder's weights plus a
  ``gateway.json`` manifest of its constructor config) served by a
  ``PagedTransformerGenerator``.  The files are the reference's, byte
  for byte, so either package loads the other's artifacts.
* **HBM budget**: every load is costed BEFORE construction by the
  static peak-HBM planner (``fluid/analysis/cost.plan_program``) — a
  paged generator's program desc is built from the manifest config
  alone (params + KV pool + int8 scale sidecar are persistable vars
  with recorded shapes, activations priced at the planner's assumed
  lane count), an engine's saved ``__model__`` program is planned at
  its largest batch bucket — and a load that would exceed
  ``hbm_budget_bytes`` is refused with ``HBMBudgetError`` carrying the
  per-component breakdown, before a byte is allocated on the card.
  An artifact load mounts a compile cache and is priced without
  donation, exactly as the reference prices it, so the two registries
  admit and refuse at the same budgets.  The port's captured step
  writes its state in place either way, so with a cache mounted the
  estimate over-prices the card by the state's write-back (the pool's
  bytes, for a generator).
* **atomic alias flip**: ``resolve("name")`` maps the model alias to
  the key ``name@version`` of the CURRENT version; ``set_alias`` flips
  it under the lock.  The scheduler resolves aliases at ADMISSION, so
  queued requests follow the flip to the new version — the hot-swap
  zero-loss contract.  Unloading a version drops the registry's
  reference; its scope (and the paged KV pool inside it) is freed with
  the instance.

Models load on the card unless the registry is given ``CPUPlace``.  A
manifest with ``mesh_axes`` (a sharded generator) raises
``NotImplementedError``: the serving mesh is ROADMAP A15.
"""

from __future__ import annotations

import json
import os
import time
import weakref
from typing import Dict, List, Optional

from ... import fluid
from ...utils.sync import (RANK_COLLECTOR_INIT, RANK_MODEL_REGISTRY,
                           OrderedLock)
from ..engine import DEFAULT_BATCH_BUCKETS, InferenceEngine
from ..paged_decoder import (PagedTransformerGenerator, _CACHE_MARKERS,
                             estimate_generator_hbm)
from ..scheduler import HBMBudgetError, suggest_model_axis
from ..speculative import SpeculativeGenerator, estimate_speculative_hbm

__all__ = ["HBMBudgetError", "ModelRegistry", "MANIFEST_NAME",
           "COMPILED_SUBDIR"]

MANIFEST_NAME = "gateway.json"
# per-version persistent compile cache (fluid/compile_cache.py): a
# published version ships its signatures' plans and kernel libraries
# here (tools/aot_compile pre-warms it offline; serving processes also
# store back what they do build, so even an un-prewarmed version pays
# its nvcc builds once per artifact, not once per process/restart/swap)
COMPILED_SUBDIR = "compiled"

# the paged generator's constructor surface a manifest may carry — kept
# explicit so a stale manifest key fails loudly at load, not deep in the
# program construction
_GENERATOR_KEYS = (
    "src_vocab_size", "trg_vocab_size", "n_layer", "n_head", "d_key",
    "d_value", "d_model", "d_inner_hid", "max_length", "src_len",
    "max_out_len", "param_prefix", "start_id", "end_id", "page_size",
    "num_pages", "chunk_size", "prefix_sharing", "topk_size", "kv_dtype",
    "mesh_axes")

_LIVE_REGISTRIES: "weakref.WeakSet[ModelRegistry]" = weakref.WeakSet()
_collector_lock = OrderedLock("obs.collector_init", RANK_COLLECTOR_INIT)
_collector_registered = False


def _collect_registry_metrics():
    from ...observability.metrics import Sample

    for reg in list(_LIVE_REGISTRIES):
        try:
            entries = reg.entries()
            budget = reg.hbm_budget_bytes
            used = reg.hbm_used()
        except Exception:
            continue
        for e in entries:
            yield Sample(
                "paddle_gateway_model_hbm_bytes", "gauge",
                (("model", e["name"]), ("version", e["version"]),
                 ("kind", e["kind"])),
                float(e["hbm_bytes"]),
                "Budgeted HBM bytes per loaded model version")
            yield Sample(
                "paddle_gateway_model_current", "gauge",
                (("model", e["name"]), ("version", e["version"])),
                1.0 if e["current"] else 0.0,
                "1 when this version is the model alias target")
        yield Sample("paddle_gateway_hbm_bytes", "gauge",
                     (("kind", "used"),), float(used),
                     "Registry HBM accounting (budget vs used)")
        if budget is not None:
            yield Sample("paddle_gateway_hbm_bytes", "gauge",
                         (("kind", "budget"),), float(budget),
                         "Registry HBM accounting (budget vs used)")


def _register_registry_collector() -> None:
    global _collector_registered
    with _collector_lock:
        if _collector_registered:
            return
        from ...observability.metrics import registry as _m

        _m().register_collector(_collect_registry_metrics)
        _collector_registered = True


def _artifact_cache(dirname: str):
    """The artifact's ``compiled/`` compile cache, or None when the
    tier is disabled (``PADDLE_TPU_AOT_DISABLE=1``).  Always mounted
    read-write: loads consume the shipped bucket set, and anything the
    serving process does compile is published back for the next
    restart."""
    if os.environ.get("PADDLE_TPU_AOT_DISABLE", "") == "1":
        return None
    from ...fluid.compile_cache import CompileCache

    return CompileCache(os.path.join(dirname, COMPILED_SUBDIR))


def _artifact_bytes(dirname: str) -> int:
    total = 0
    for n in os.listdir(dirname):
        p = os.path.join(dirname, n)
        if os.path.isfile(p) and n != MANIFEST_NAME:
            total += os.path.getsize(p)
    return total


class _Entry:
    __slots__ = ("key", "name", "version", "kind", "instance",
                 "hbm_bytes", "loaded_at", "dirname")

    def __init__(self, key, name, version, kind, instance, hbm_bytes,
                 dirname=None):
        self.key = key
        self.name = name
        self.version = version
        self.kind = kind
        self.instance = instance
        self.hbm_bytes = int(hbm_bytes)
        self.dirname = dirname
        self.loaded_at = time.time()


class ModelRegistry:
    """Loaded model versions + the alias map the scheduler resolves."""

    def __init__(self, root: Optional[str] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 place=None):
        self.root = root
        self.hbm_budget_bytes = (None if hbm_budget_bytes is None
                                 else int(hbm_budget_bytes))
        self.place = place
        # acquired under the scheduler lock (resolve at admission)
        self._lock = OrderedLock("gateway.registry",
                                 RANK_MODEL_REGISTRY)
        self._entries: Dict[str, _Entry] = {}
        self._alias: Dict[str, str] = {}        # name -> version
        self._loading: set = set()   # keys reserved by in-flight loads
        _LIVE_REGISTRIES.add(self)
        _register_registry_collector()

    # -- artifact store ------------------------------------------------------
    @staticmethod
    def save_generator_artifact(generator: PagedTransformerGenerator,
                                root: str, name: str, version: str) -> str:
        """Persist a paged generator as a versioned artifact: every
        persistable of its unified program EXCEPT cache state (the KV
        pool/sidecar are decode-time state, rebuilt empty at load), plus
        a manifest of the constructor config.  The artifact is exactly
        what ``load`` needs to rebuild a byte-equivalent server."""
        cfg = {
            "src_vocab_size": generator.cfg.src_vocab_size,
            "trg_vocab_size": generator.cfg.trg_vocab_size,
            "n_layer": generator.cfg.n_layer,
            "n_head": generator.cfg.n_head,
            "d_key": generator.cfg.d_key,
            "d_value": generator.cfg.d_value,
            "d_model": generator.cfg.d_model,
            "d_inner_hid": generator.cfg.d_inner_hid,
            "max_length": generator.cfg.max_length,
            "src_len": generator.src_len,
            "max_out_len": generator.max_out_len,
            "param_prefix": generator.prefix,
            "start_id": generator.start_id,
            "end_id": generator.end_id,
            "page_size": generator.page_size,
            "num_pages": generator.num_pages,
            "chunk_size": generator.chunk,
            "prefix_sharing": generator.prefix_sharing,
            "topk_size": generator.topk_size,
            "kv_dtype": generator.kv_dtype,
        }
        prog = generator._unified[0]

        def writer(staging: str) -> None:
            for v in prog.list_vars():
                if not v.persistable or \
                        any(m in v.name for m in _CACHE_MARKERS):
                    continue
                val = generator.scope.find_var(v.name)
                if val is None:
                    continue
                fluid.io.save_tensor(val, os.path.join(staging, v.name))
            with open(os.path.join(staging, MANIFEST_NAME), "w",
                      encoding="utf-8") as f:
                json.dump({"kind": "generator", "config": cfg}, f,
                          indent=1)

        # staged + fsynced + rename-published: a trainer
        # SIGKILLed mid-publish must never leave a half-written version
        # for the next registry load to trip over
        return fluid.io.publish_model_version(root, name, version, writer)

    def _manifest(self, dirname: str) -> Dict:
        path = os.path.join(dirname, MANIFEST_NAME)
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                return json.load(f)
        # a bare save_inference_model directory serves through the
        # bucketed engine by default
        return {"kind": "engine"}

    # -- budgeting -----------------------------------------------------------
    def hbm_used(self) -> int:
        with self._lock:
            return sum(e.hbm_bytes for e in self._entries.values())

    def _charge(self, cost: int, what: str,
                components: Optional[Dict] = None) -> None:
        if self.hbm_budget_bytes is None:
            return
        used = self.hbm_used()
        if used + cost > self.hbm_budget_bytes:
            detail = ""
            if components:
                detail = " (" + ", ".join(
                    f"{k}={v}" for k, v in components.items() if v) + ")"
            avail = self.hbm_budget_bytes - used
            ax = suggest_model_axis(components, avail)
            hint = ("" if ax is None else
                    f", or shard it: a mesh model-axis of {ax} fits "
                    f"per-shard — load with mesh_axes={{'model': {ax}}}")
            raise HBMBudgetError(
                f"loading {what} needs {cost} static peak-HBM bytes"
                f"{detail} but only {avail} of "
                f"{self.hbm_budget_bytes} remain "
                f"({used} in use) — unload a version first{hint}",
                suggested_model_axis=ax)

    @staticmethod
    def _estimate_cost_detail(kind: str, dirname: Optional[str],
                              config: Dict):
        """(static peak bytes, per-component breakdown) BEFORE any
        device allocation, from the analyzer's peak-HBM planner a generator's unified program desc is built straight from
        the manifest config (the KV pool and its int8 scale sidecar are
        persistable vars with recorded shapes — no separate
        kv_page_bytes term), an engine's saved ``__model__`` program is
        planned at its largest declared batch bucket.  Artifact loads
        that will mount a ``compiled/`` AOT cache are priced
        WITHOUT donation aliasing — their executables really dispatch
        with write-back copies, and a budget computed from the donating
        ideal would admit models that OOM the chip mid-traffic."""
        donation = not dirname or \
            os.environ.get("PADDLE_TPU_AOT_DISABLE", "") == "1"
        if kind == "generator":
            plan = estimate_generator_hbm(config,
                                          assume_donation=donation)
            return int(plan.peak_bytes), dict(plan.components)
        if kind == "engine" and dirname:
            model_path = os.path.join(dirname, "__model__")
            if os.path.isfile(model_path):
                from ...fluid.analysis.cost import plan_program
                from ...fluid.framework import Program

                with open(model_path, "rb") as f:
                    prog = Program.parse_from_string(f.read())
                buckets = config.get("batch_buckets") \
                    or DEFAULT_BATCH_BUCKETS
                plan = plan_program(prog,
                                    assume_batch=int(max(buckets)),
                                    assume_donation=donation)
                return int(plan.peak_bytes), dict(plan.components)
        # no program to plan (adopted instance, bare artifact dir):
        # artifact bytes are the only static signal left
        cost = _artifact_bytes(dirname) if dirname else 0
        return cost, {"artifact": cost}

    @staticmethod
    def _shard_preflight(kind: str, config: Dict) -> None:
        """The reference refuses here a ``mesh_axes`` generator artifact
        whose manifest-built program fails whole-program sharding
        inference.  The port has no serving mesh: any ``mesh_axes``
        raises, at admission, before any HBM is charged or weights are
        mounted."""
        if kind == "generator" and config.get("mesh_axes"):
            raise NotImplementedError(
                "ModelRegistry: a generator manifest with mesh_axes (the "
                "sharded serving mesh and its sharding preflight) is not "
                "ported to paddle_tpu_torch (ROADMAP A15)")

    @staticmethod
    def _estimate_cost(kind: str, dirname: Optional[str],
                       config: Dict) -> int:
        cost, _ = ModelRegistry._estimate_cost_detail(kind, dirname,
                                                      config)
        return cost

    # -- loading -------------------------------------------------------------
    def load(self, name: str, version: str,
             dirname: Optional[str] = None, **overrides) -> str:
        """Load ``<name>/<version>`` from the artifact store (or an
        explicit ``dirname``) into a live serving instance; returns the
        lane-group key ``name@version``.  The first loaded version of a
        model becomes its alias target."""
        name, version = str(name), str(version)
        key = f"{name}@{version}"
        self._reserve_load(key)
        try:
            if dirname is None:
                if self.root is None:
                    raise ValueError(
                        "registry has no root; pass dirname=")
                dirname = fluid.io.model_version_dir(self.root, name,
                                                     version)
            if not os.path.isdir(dirname):
                raise FileNotFoundError(f"no artifact at {dirname}")
            # chaos point: a seeded load failure —
            # unreadable artifact store, bad deserialize — injectable
            # so the release controller's reject-and-keep-serving path
            # is testable
            from ...resilience.chaos import injector

            injector().maybe_fail("registry.load")
            manifest = self._manifest(dirname)
            kind = manifest.get("kind", "engine")
            config = dict(manifest.get("config", {}))
            config.update(overrides)
            self._shard_preflight(kind, config)
            cost, components = self._estimate_cost_detail(kind, dirname,
                                                          config)
            self._charge(cost, key, components)
            if kind == "generator":
                instance = self._build_generator(dirname, config)
            elif kind == "engine":
                exe = fluid.Executor(
                    self.place, compile_cache=_artifact_cache(dirname))
                instance = InferenceEngine(
                    dirname=dirname, place=self.place, executor=exe,
                    quantize=config.pop("quantize", "off"), **config)
            else:
                raise ValueError(f"{dirname}: unknown artifact kind "
                                 f"{kind!r} (engine or generator)")
            with self._lock:
                self._entries[key] = _Entry(key, name, version, kind,
                                            instance, cost, dirname)
                self._alias.setdefault(name, version)
        finally:
            with self._lock:
                self._loading.discard(key)
        return key

    def _reserve_load(self, key: str) -> None:
        """Reserve ``key`` for an in-flight load: a concurrent load of
        the same name@version fails FAST here instead of both passing
        the duplicate check, both building full instances on device
        (transient double HBM residency), and the second silently
        replacing the first's entry.  The caller clears the
        reservation in a ``finally``."""
        with self._lock:
            if key in self._entries or key in self._loading:
                raise ValueError(f"{key} already loaded")
            self._loading.add(key)

    def load_speculative(self, name: str, version: str, draft_name: str,
                         draft_version: str, k: int = 4,
                         dirname: Optional[str] = None,
                         draft_dirname: Optional[str] = None) -> str:
        """Load a TARGET generator artifact with a DRAFT generator
        artifact attached as one speculative serving instance the lane-group key stays ``name@version`` — speculation is
        a serving configuration of the target, not a separate alias —
        and the HBM budget charges the PAIR jointly (target priced at
        its k+1-token verify shape, draft at its masked decode shape,
        both pools and parameter sets resident at once) BEFORE either
        model is built.  Each artifact mounts its own ``compiled/`` AOT
        cache, so a pre-compiled pair serves its draft/verify/cow
        executables from disk (zero process compiles)."""
        name, version = str(name), str(version)
        key = f"{name}@{version}"
        self._reserve_load(key)
        try:
            def _dir(n, v, explicit):
                if explicit is not None:
                    return explicit
                if self.root is None:
                    raise ValueError("registry has no root; pass "
                                     "dirname= and draft_dirname=")
                return fluid.io.model_version_dir(self.root, n, v)

            t_dir = _dir(name, version, dirname)
            d_dir = _dir(draft_name, draft_version, draft_dirname)
            for d in (t_dir, d_dir):
                if not os.path.isdir(d):
                    raise FileNotFoundError(f"no artifact at {d}")
            from ...resilience.chaos import injector

            injector().maybe_fail("registry.load")
            t_manifest, d_manifest = self._manifest(t_dir), \
                self._manifest(d_dir)
            if t_manifest.get("kind") != "generator" or \
                    d_manifest.get("kind") != "generator":
                raise ValueError(
                    "load_speculative: both artifacts must be "
                    "generator artifacts (target kind "
                    f"{t_manifest.get('kind')!r}, "
                    f"draft kind {d_manifest.get('kind')!r})")
            t_cfg = dict(t_manifest.get("config", {}))
            d_cfg = dict(d_manifest.get("config", {}))
            donation = os.environ.get(
                "PADDLE_TPU_AOT_DISABLE", "") == "1"
            plan = estimate_speculative_hbm(t_cfg, d_cfg, k=int(k),
                                            assume_donation=donation)
            cost = int(plan.peak_bytes)
            self._charge(cost, key, dict(plan.components))
            target = self._build_generator(t_dir, t_cfg)
            draft = self._build_generator(d_dir, d_cfg)
            instance = SpeculativeGenerator(target, draft, k=int(k),
                                            draft_name=str(draft_name))
            with self._lock:
                self._entries[key] = _Entry(key, name, version,
                                            "speculative", instance,
                                            cost, t_dir)
                self._alias.setdefault(name, version)
        finally:
            with self._lock:
                self._loading.discard(key)
        return key

    def _build_generator(self, dirname: str,
                         config: Dict) -> PagedTransformerGenerator:
        bad = set(config) - set(_GENERATOR_KEYS)
        if bad:
            raise ValueError(f"{dirname}: unknown generator config keys "
                             f"{sorted(bad)}")
        exe = fluid.Executor(self.place,
                             compile_cache=_artifact_cache(dirname))
        gen = PagedTransformerGenerator(place=self.place, executor=exe,
                                        **config)
        for n in os.listdir(dirname):
            path = os.path.join(dirname, n)
            if n == MANIFEST_NAME or not os.path.isfile(path):
                continue
            gen.scope.set_var(n, fluid.io.load_tensor(path))
        # one upload at load, not per first request (the engine
        # to_device contract); the pool vars are already device zeros
        fluid.io.device_put_persistables(gen.scope, gen._unified[0],
                                         device=gen.exe.device)
        return gen

    def register(self, name: str, version: str, instance,
                 hbm_bytes: Optional[int] = None) -> str:
        """Adopt an already-constructed instance (in-process loads,
        tests, bench).  Costed by the instance's own static planner
        estimate when it has one (the same number ``load`` computes
        from a manifest), else its legacy byte accounting."""
        name, version = str(name), str(version)
        key = f"{name}@{version}"
        components = None
        if hbm_bytes is None:
            est = getattr(instance, "static_hbm_estimate", None)
            if callable(est):
                plan = est()
                hbm_bytes = plan.peak_bytes
                components = dict(plan.components)
            elif hasattr(instance, "page_bytes"):
                hbm_bytes = instance.page_bytes * instance.num_pages
            elif hasattr(instance, "kv_bytes_per_slot"):
                hbm_bytes = instance.kv_bytes_per_slot()
            else:
                hbm_bytes = 0
        self._charge(int(hbm_bytes), key, components)
        kind = ("generator"
                if isinstance(instance, PagedTransformerGenerator)
                else "speculative"
                if isinstance(instance, SpeculativeGenerator)
                else "engine" if isinstance(instance, InferenceEngine)
                else type(instance).__name__)
        with self._lock:
            if key in self._entries:
                raise ValueError(f"{key} already loaded")
            self._entries[key] = _Entry(key, name, version, kind,
                                        instance, hbm_bytes)
            self._alias.setdefault(name, version)
        return key

    def _check_unload_locked(self, key: str) -> "_Entry":
        entry = self._entries.get(key)
        if entry is None:
            raise KeyError(f"{key} not loaded")
        if self._alias.get(entry.name) == entry.version:
            others = [e for e in self._entries.values()
                      if e.name == entry.name and e.key != key]
            if others:
                raise ValueError(
                    f"{key} is the current alias target; "
                    f"set_alias to another version first")
        return entry

    def check_unload(self, key: str) -> None:
        """Raise exactly what ``unload`` would, without removing
        anything — callers that must tear down OTHER state (scheduler
        lanes) before the registry entry validate first, so a refused
        unload never leaves the model half-torn."""
        with self._lock:
            self._check_unload_locked(str(key))

    def unload(self, key: str):
        """Forget a loaded version and release its budget; returns the
        instance (the caller drops the last reference — the scope, and
        the paged KV pool inside it, free with it).  Refuses to unload
        the alias target: flip or remove the alias first."""
        with self._lock:
            entry = self._check_unload_locked(key)
            if self._alias.get(entry.name) == entry.version:
                del self._alias[entry.name]
            del self._entries[key]
            return entry.instance

    # -- alias resolution (the scheduler's resolve hook) ---------------------
    def set_alias(self, name: str, version: str) -> str:
        """Atomically point ``name`` at ``version`` (must be loaded);
        returns the previous key or None.  This is THE hot-swap flip:
        submissions and queued requests resolve through it at admission,
        so after the flip no new work reaches the old version."""
        name, version = str(name), str(version)
        key = f"{name}@{version}"
        with self._lock:
            if key not in self._entries:
                raise KeyError(f"{key} not loaded")
            prev = self._alias.get(name)
            self._alias[name] = version
        return f"{name}@{prev}" if prev is not None else None

    def resolve(self, alias: str) -> str:
        """Model alias -> lane-group key.  Pinned ``name@version``
        addresses pass through; bare names follow the alias map.
        Unknown names return themselves (the scheduler rejects unknown
        groups with its own error path)."""
        alias = str(alias)
        if "@" in alias:
            return alias
        with self._lock:
            version = self._alias.get(alias)
        return f"{alias}@{version}" if version is not None else alias

    def current_key(self, name: str) -> Optional[str]:
        with self._lock:
            version = self._alias.get(str(name))
        return f"{name}@{version}" if version is not None else None

    def instance(self, alias_or_key: str):
        key = self.resolve(alias_or_key)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                raise KeyError(f"no model loaded for {alias_or_key!r}")
            return entry.instance

    # -- accounting ----------------------------------------------------------
    def entries(self) -> List[Dict[str, object]]:
        with self._lock:
            return [{
                "key": e.key, "name": e.name, "version": e.version,
                "kind": e.kind, "hbm_bytes": e.hbm_bytes,
                "loaded_at": e.loaded_at,
                "current": self._alias.get(e.name) == e.version,
            } for e in sorted(self._entries.values(),
                              key=lambda e: e.key)]

    def stats(self) -> Dict[str, object]:
        entries = self.entries()
        out: Dict[str, object] = {
            "models": entries,
            "aliases": dict(sorted(self._alias.items())),
            "hbm_used_bytes": sum(e["hbm_bytes"] for e in entries),
        }
        if self.hbm_budget_bytes is not None:
            out["hbm_budget_bytes"] = self.hbm_budget_bytes
        if self.root is not None:
            out["root"] = self.root
            with self._lock:
                names = sorted({e.name for e in self._entries.values()})
            out["versions_on_disk"] = {
                n: fluid.io.list_model_versions(self.root, n)
                for n in names}
        return out
