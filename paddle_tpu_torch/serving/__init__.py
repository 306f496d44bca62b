"""Serving on one GPU — the port of ``paddle_tpu.serving``'s paged path.

* ``PagedTransformerGenerator`` (paged_decoder.py) + ``PageAllocator``
  (paging.py): block-table paged KV over ONE pooled device tensor, the
  ragged paged-attention CUDA kernel, chunked causal prefill interleaved
  with decode in one step (the Fluid program ``build_unified_program``,
  run through ``fluid.Executor``: one captured CUDA graph per lane count
  on the card), and prefix sharing with refcounts; ``copy_weights``
  carries weights between scopes.
* ``ContinuousBatchingScheduler`` (scheduler.py): a request queue
  admitting prompts into fixed in-flight slots by page budget; finished
  sequences retire and queued requests backfill their slot; ``serve()``
  runs the loop on a thread with per-request latency accounting.

The dense ``TransformerGenerator``, beam search, speculative decoding,
sessions and the gateway are not ported yet.
"""

from .paged_decoder import (PagedTransformerGenerator,
                            build_unified_program, copy_weights,
                            default_num_pages, kv_page_bytes)
from .paging import PageAllocator, PoolCapacityError, chunk_hashes
from .scheduler import (ContinuousBatchingScheduler, Request,
                        RequestCancelled, SchedulerShutdown)

__all__ = ["PagedTransformerGenerator", "build_unified_program",
           "copy_weights", "PageAllocator", "kv_page_bytes",
           "default_num_pages", "chunk_hashes", "PoolCapacityError",
           "ContinuousBatchingScheduler", "Request", "RequestCancelled",
           "SchedulerShutdown"]
