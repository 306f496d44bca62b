"""The serving gateway — the port of ``paddle_tpu/serving/gateway/``:
one front door over the scheduler, the paged generator and the inference
engine.

* ``ModelRegistry`` (registry.py) — versioned ``save_inference_model``
  / generator artifacts under ``<root>/<name>/<version>/``, loaded into
  named ``InferenceEngine`` / ``PagedTransformerGenerator`` instances
  under an HBM budget, with atomic alias flips for zero-downtime hot
  swap; each artifact's ``compiled/`` directory is mounted as its
  persistent compile cache (``fluid/compile_cache.py``).
* ``TenantRouter`` (router.py) — per-tenant token buckets, SLO classes
  (latency preempts batch AT ADMISSION only), weighted fair share.
* ``Gateway`` + ``TokenStream`` (gateway.py) — submit/generate/
  submit_stream with cancellation, the request journal for restarts,
  per-tenant latency accounting.
* ``GatewayServer`` (server.py) — ``/v1/generate`` (blocking + chunked
  streaming) and ``/v1/models`` (load/swap/unload) over
  ThreadingHTTPServer; ``python -m paddle_tpu_torch.tools.gateway`` is
  the CLI.

Host-only but for the models it serves: those run on the card unless
the registry is given ``CPUPlace``.
"""

from .gateway import Gateway, GatewayDraining, TokenStream  # noqa: F401
from .journal import RequestJournal  # noqa: F401
from .registry import HBMBudgetError, ModelRegistry  # noqa: F401
from .router import RateLimited, TenantConfig, TenantRouter  # noqa: F401
from .server import GatewayServer  # noqa: F401

__all__ = ["Gateway", "GatewayDraining", "TokenStream", "RequestJournal",
           "ModelRegistry", "HBMBudgetError", "TenantRouter",
           "TenantConfig", "RateLimited", "GatewayServer"]
