"""paddle_tpu_torch.lifecycle — the closed train→evaluate→deploy loop;
the port of ``paddle_tpu.lifecycle``.

The integration layer that connects the guarded ``ResilientTrainer``,
the versioned ``ModelRegistry`` with the gateway's hot swap, and the
gateway's telemetry into one supervised loop:

  publish.py    CandidatePublisher / GeneratorPublisher — the
                trainer-side hook (``ResilientTrainer(publisher=...,
                publish_every_steps=N)``) emitting versioned engine or
                paged-generator artifacts through the crash-safe
                staged publish (fp32, optionally with an int8 PTQ
                manifest), optionally pre-compiled
                (``tools.aot_compile.precompile``).
  canary.py     CanarySlice — deterministic canary routing through the
                scheduler's pluggable admission_policy hook: a seeded
                slice of the alias's admissions pins to the candidate
                lane group via ``Request.route_to``.
  journal.py    ReleaseJournal / fold_state — fsynced jsonl of every
                pipeline transition, torn-tail-tolerant replay; the
                record that makes the controller restartable.
  controller.py ReleaseController — discover → evaluate (offline
                gate) → canary → observe (live ``paddle_gateway_*``
                error/p95/queue-depth series + pinned quality probes)
                → promote (atomic alias flip + CURRENT marker) or
                auto-rollback; ``resume()`` re-arms a mid-flight
                canary after a restart; operator promote/rollback
                directives ride the same journal
                (``python -m paddle_tpu_torch.tools.lifecycle``).
"""

from .canary import CanarySlice
from .controller import ReleaseConfig, ReleaseController
from .journal import ReleaseJournal, ReleaseState, fold_state
from .publish import CandidatePublisher, GeneratorPublisher

__all__ = ["CanarySlice", "ReleaseConfig", "ReleaseController",
           "ReleaseJournal", "ReleaseState", "fold_state",
           "CandidatePublisher", "GeneratorPublisher"]
