"""paddle_tpu_torch.resilience — the port of ``paddle_tpu.resilience``,
cut to its seeded fault injector (``chaos.py``): the session store's
``kv.spill_corrupt`` point draws from it.  The reference's retry policy,
guarded steps, resilient trainer and supervised service are not ported
yet."""

from .chaos import ChaosError, FaultInjector, injector, install

__all__ = ["ChaosError", "FaultInjector", "injector", "install"]
