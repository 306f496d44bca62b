"""Serving on one GPU — the port of ``paddle_tpu.serving``'s paged and
dense paths.

* ``PagedTransformerGenerator`` (paged_decoder.py) + ``PageAllocator``
  (paging.py): block-table paged KV over ONE pooled device tensor, the
  ragged paged-attention CUDA kernel, chunked causal prefill interleaved
  with decode in one step (the Fluid program ``build_unified_program``,
  run through ``fluid.Executor``: one captured CUDA graph per lane count
  on the card), prefix sharing with refcounts, and beam search over
  shared pages with copy-on-write; ``copy_weights`` carries weights
  between scopes.
* ``TransformerGenerator`` / ``FullRerunDecoder`` (decoder.py): dense
  per-lane KV caches (one prefill per request, then one step per token;
  greedy and beam, the beam's cache reorder in the step), and the
  baseline that re-runs the whole forward per token.
* ``ContinuousBatchingScheduler`` (scheduler.py): a request queue
  admitting prompts into fixed in-flight slots by page budget; finished
  sequences retire and queued requests backfill their slot; ``serve()``
  runs the loop on a thread with per-request latency accounting.

``InferenceEngine``, speculative decoding, sessions and the gateway are
not ported yet.
"""

from .decoder import FullRerunDecoder, TransformerGenerator
from .paged_decoder import (PagedTransformerGenerator,
                            build_unified_program, copy_weights,
                            default_num_pages, kv_page_bytes)
from .paging import PageAllocator, PoolCapacityError, chunk_hashes
from .scheduler import (ContinuousBatchingScheduler, Request,
                        RequestCancelled, SchedulerShutdown)

__all__ = ["TransformerGenerator", "FullRerunDecoder",
           "PagedTransformerGenerator", "build_unified_program",
           "copy_weights", "PageAllocator", "kv_page_bytes",
           "default_num_pages", "chunk_hashes", "PoolCapacityError",
           "ContinuousBatchingScheduler", "Request", "RequestCancelled",
           "SchedulerShutdown"]
