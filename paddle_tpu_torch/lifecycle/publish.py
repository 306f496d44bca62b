"""Candidate publishers — the trainer's half of the release loop; the
port of ``paddle_tpu/lifecycle/publish.py``.

A publisher turns the live training scope into a versioned artifact in
the model store, through the crash-safe staged publish
(``fluid.io.publish_model_version``): the trainer can be SIGKILLed at
any instruction and the store holds either the complete version or no
version — never a torn artifact for ``ModelRegistry.load``.

Two artifact shapes, matching what the registry serves:

* ``CandidatePublisher`` — a ``save_versioned_inference_model`` engine
  artifact (batch inference through ``InferenceEngine``); with
  ``int8=True`` the version ships a ``gateway.json`` manifest asking
  the registry to run the per-channel int8 PTQ at load
  (``quantize="int8"``), so the deployable artifact stays fp32 on disk
  and the int8 rewrite happens against the loaded copy.
* ``GeneratorPublisher`` — a paged-generator artifact
  (``ModelRegistry.save_generator_artifact``): trained weights are
  snapshotted into a serving clone via ``copy_weights`` under the
  ``param_prefix`` naming contract, so the trainer's scope and the
  decode programs agree on every parameter name.  ``kv_dtype="int8"``
  in the generator config publishes the block-scaled int8-KV server.

Both are duck-typed to the ``ResilientTrainer`` hook:
``publish(step, program=None, scope=None) -> version``.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List, Optional

from ..fluid import io as fio

__all__ = ["CandidatePublisher", "GeneratorPublisher"]


def _aot_prewarm(dirname: str, **kw) -> None:
    """Pre-compile the just-published version's bucket set into its
    ``compiled/`` subdir so candidates arrive at the release controller
    pre-compiled — ``Gateway._warm`` on the canary then restores its
    plans and kernel libraries instead of building them (no ``nvcc``).  ADVISORY like the publish
    hook itself: the cache is exactly that, so a failed pre-warm logs
    and the (complete, loadable) version stands."""
    from ..tools.aot_compile import precompile

    try:
        precompile(dirname, **kw)
    except Exception as e:
        print(f"paddle_tpu_torch.lifecycle: aot pre-warm of {dirname} failed "
              f"({type(e).__name__}: {e}); the version will compile at "
              f"load instead", file=sys.stderr)


class CandidatePublisher:
    """Versioned engine-artifact publisher for a live training scope."""

    def __init__(self, root: str, name: str, feed_names: List[str],
                 target_vars, executor, main_program=None, scope=None,
                 int8: bool = False,
                 version_fn: Optional[Callable[[int], str]] = None,
                 aot_warm: bool = False,
                 aot_max_time: Optional[int] = None):
        self.root = str(root)
        self.name = str(name)
        self.feed_names = list(feed_names)
        self.target_vars = list(target_vars)
        self.executor = executor
        self.main_program = main_program
        self.scope = scope
        self.int8 = bool(int8)
        self.version_fn = version_fn or str
        # pre-compile the published version's bucket set so the
        # candidate ships its plans and kernel libraries (aot_max_time closes
        # ragged feeds' time axis for the enumeration)
        self.aot_warm = bool(aot_warm)
        self.aot_max_time = aot_max_time

    def manifest(self) -> Optional[Dict]:
        if not self.int8:
            return None
        return {"kind": "engine", "config": {"quantize": "int8"}}

    def publish(self, step: int, program=None, scope=None) -> str:
        version = str(self.version_fn(int(step)))
        dirname = fio.save_versioned_inference_model(
            self.root, self.name, version, self.feed_names,
            self.target_vars, self.executor,
            main_program=program or self.main_program,
            scope=scope or self.scope, manifest=self.manifest())
        if self.aot_warm:
            _aot_prewarm(dirname, max_time=self.aot_max_time)
        return version


class GeneratorPublisher:
    """Paged-generator artifact publisher: snapshot the trained
    parameters into a serving clone, publish the clone's persistables
    plus its constructor manifest as one atomic version."""

    def __init__(self, root: str, name: str, generator_config: Dict,
                 scope=None, place=None,
                 version_fn: Optional[Callable[[int], str]] = None,
                 aot_warm: Optional[int] = None):
        self.root = str(root)
        self.name = str(name)
        # the PagedTransformerGenerator constructor surface (the same
        # keys a gateway.json manifest carries) — validated by the
        # generator itself at first publish
        self.generator_config = dict(generator_config)
        self.scope = scope
        self.place = place
        self.version_fn = version_fn or str
        # lane count to pre-compile each published version at
        # (match the gateway's n_slots); None = ship uncompiled
        self.aot_warm = aot_warm
        self._gen = None            # built lazily: one clone, reused

    def _generator(self):
        if self._gen is None:
            from ..serving import PagedTransformerGenerator

            self._gen = PagedTransformerGenerator(
                place=self.place, **self.generator_config)
        return self._gen

    def publish(self, step: int, program=None, scope=None) -> str:
        from ..serving import copy_weights
        from ..serving.gateway import ModelRegistry

        version = str(self.version_fn(int(step)))
        gen = self._generator()
        src_scope = scope or self.scope
        if src_scope is None:
            raise ValueError("GeneratorPublisher.publish: no scope "
                             "(pass one at construction or publish)")
        copy_weights(src_scope, gen.scope,
                     prefix=self.generator_config.get("param_prefix"))
        dirname = ModelRegistry.save_generator_artifact(
            gen, self.root, self.name, version)
        if self.aot_warm:
            _aot_prewarm(dirname, n_slots=int(self.aot_warm))
        return version
