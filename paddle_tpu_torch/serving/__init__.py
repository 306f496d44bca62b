"""Serving on one GPU — the port of ``paddle_tpu.serving``'s paged and
dense paths.

* ``PagedTransformerGenerator`` (paged_decoder.py) + ``PageAllocator``
  (paging.py): block-table paged KV over ONE pooled device tensor, the
  ragged paged-attention CUDA kernel, chunked causal prefill interleaved
  with decode in one step (the Fluid program ``build_unified_program``,
  run through ``fluid.Executor``: one captured CUDA graph per lane count
  on the card), prefix sharing with refcounts, and beam search over
  shared pages with copy-on-write; ``copy_weights`` carries weights
  between scopes.  With ``host_pages`` evicted prefix chunks demote to
  a host-RAM tier (promoted back bit for bit on the next hit), and with
  a ``SessionStore`` (sessions.py) whole lanes suspend to checksummed,
  fingerprint-keyed host/disk artifacts and resume without re-prefill.
* ``SpeculativeGenerator`` (speculative.py) + ``constraints.py``: draft
  k tokens with a cheap draft model, verify all k in ONE target step
  (``verify_step``'s per-lane token axis over the paged pool, the
  ragged kernel at C = k+1 queries a lane), accept/reject with
  host-side page-table truncation and copy-on-write before the write,
  and per-request grammar-constrained generation through token masks
  fed as data.  Token for token equal to plain greedy at any accept
  rate.
* ``TransformerGenerator`` / ``FullRerunDecoder`` (decoder.py): dense
  per-lane KV caches (one prefill per request, then one step per token;
  greedy and beam, the beam's cache reorder in the step), and the
  baseline that re-runs the whole forward per token.
* ``ContinuousBatchingScheduler`` (scheduler.py): a request queue
  admitting prompts into fixed in-flight slots by page budget; finished
  sequences retire and queued requests backfill their slot; ``serve()``
  runs the loop on a thread with per-request latency accounting.

* ``InferenceEngine`` (engine.py): any pruned Fluid program (a
  ``save_inference_model`` directory, or a program over a trained
  scope) served in batch and time buckets, float or int8
  (``quantize="int8"``: the post-training rewrite of
  ``fluid.transforms``).

The gateway is not ported yet.
"""

from .decoder import FullRerunDecoder, TransformerGenerator
from .paged_decoder import (PagedTransformerGenerator,
                            build_unified_program, copy_weights,
                            default_num_pages, kv_page_bytes)
from .paging import PageAllocator, PoolCapacityError, chunk_hashes
from .scheduler import (ContinuousBatchingScheduler, Request,
                        RequestCancelled, SchedulerShutdown)
from .constraints import (Constraint, DFAConstraint, TokenSetConstraint,
                          compile_constraint)
from .speculative import SpeculativeGenerator
from .sessions import SessionStore
from .engine import InferenceEngine

__all__ = ["TransformerGenerator", "FullRerunDecoder",
           "PagedTransformerGenerator", "build_unified_program",
           "copy_weights", "PageAllocator", "kv_page_bytes",
           "default_num_pages", "chunk_hashes", "PoolCapacityError",
           "ContinuousBatchingScheduler", "Request", "RequestCancelled",
           "SchedulerShutdown", "SpeculativeGenerator", "Constraint",
           "TokenSetConstraint", "DFAConstraint", "compile_constraint",
           "SessionStore", "InferenceEngine"]
