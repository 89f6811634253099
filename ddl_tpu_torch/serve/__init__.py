"""Continuous-batching serving engine with a paged KV cache (counterpart of
``ddl_tpu/serve/``, one device):

* ``kv_pool``   — block-granular KV slots: per-layer device pools
                  (``init_kv_cache``'s fused layouts chopped along the
                  sequence axis), the host-side refcounted
                  ``BlockAllocator`` (allocate/share/free/defrag, LRU-
                  evictable cached blocks) and the content-keyed
                  ``PrefixIndex`` (shared prompt prefixes are shared
                  blocks).
* ``scheduler`` — the continuous batch: lanes, admit/retire, reservations
                  split into shared-prefix and private blocks.
* ``admission`` — bounded queue and shed policies (reject-new /
                  shed-oldest) with ``serve_shed`` obs events.
* ``engine``    — the program families (bucketed single-request prefill
                  and first token; chunked prefill continuing a
                  pool-resident context; the K-step batched decode over
                  gathered block tables, through the decode-attention and
                  int8 matmul kernels on CUDA) and the serving loop.
* ``bench``     — ``serve-bench``: N synthetic concurrent clients, the
                  scenario matrix, the percentile report and the
                  sequential comparison.
"""

from ddl_tpu_torch.serve.admission import AdmissionController
from ddl_tpu_torch.serve.engine import ServeEngine, make_serve_step_fns
from ddl_tpu_torch.serve.kv_pool import BlockAllocator, PrefixIndex, init_kv_pool
from ddl_tpu_torch.serve.scheduler import ContinuousScheduler, Request

__all__ = [
    "AdmissionController",
    "BlockAllocator",
    "ContinuousScheduler",
    "PrefixIndex",
    "Request",
    "ServeEngine",
    "init_kv_pool",
    "make_serve_step_fns",
]
