"""paddle_tpu_torch.resilience — the fault-tolerance layer; the port of
``paddle_tpu.resilience``.

  retry.py    RetryPolicy — backoff + decorrelated jitter + deadline;
              wired into MasterClient so a master restart is a pause,
              not a crash.
  chaos.py    FaultInjector — seeded, deterministic fault injection
              threaded through the master client/server, the reader,
              the guarded step and CheckpointManager; off by default,
              env-configured.
  trainer.py  ResilientTrainer — CheckpointManager.restore() composed
              with the master's lease protocol: a SIGKILLed run
              resumes from the newest valid checkpoint and re-leases
              expired chunks.
  guardrails.py  GuardPolicy + the finiteness sentinel, the gated
              state publish and rollback-and-skip recovery captured in
              the step's CUDA graph, and the hung-step watchdog behind
              ``Executor.run(..., guard=...)``.
  service.py  run_supervised / SupervisedService — single-process
              services (the serving gateway) respawned on non-zero
              exit, with journal-driven recovery owned by the service.

`ResilientTrainer` imports the fluid/parallel layers, which themselves
use chaos hooks from here — it loads lazily to keep this package
importable from anywhere in the stack.
"""

from .retry import RetryPolicy
from .chaos import ChaosError, FaultInjector, injector, install
from .guardrails import (GuardPolicy, NonFiniteError, NonFiniteEscalation,
                         StepFault, StepTimeout)
from .service import SupervisedService, run_supervised

__all__ = ["RetryPolicy", "ChaosError", "FaultInjector", "injector",
           "install", "ResilientTrainer", "GuardPolicy", "NonFiniteError",
           "NonFiniteEscalation", "StepFault", "StepTimeout",
           "run_supervised", "SupervisedService"]


def __getattr__(name):
    if name == "ResilientTrainer":
        from .trainer import ResilientTrainer

        return ResilientTrainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
