"""Serving subsystem of the port: requests, slot scheduler, slotted and
paged KV pools, prefix index, the continuous-batching engine and the
fixed-batch (sequential) oracle."""

from repro_torch.serve.cache import (scatter_slot, scatter_slot_,
                                     seed_decode_caches)
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.paged import (BlockPool, SwapState, TRASH_BLOCK,
                                     default_buckets)
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.request import (Request, RequestResult,
                                       shared_prefix_trace, synthetic_request,
                                       synthetic_trace)
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.serve.sequential import serve_fixed_batch, serve_sequential
from repro_torch.serve.speculative import (SpecConfig, accept_greedy,
                                           draft_propose_k)

__all__ = ["scatter_slot", "scatter_slot_", "seed_decode_caches",
           "serve_fixed_batch", "serve_sequential", "ServeEngine",
           "BlockPool", "SwapState", "TRASH_BLOCK", "default_buckets", "PrefixIndex", "Request",
           "RequestResult", "shared_prefix_trace", "synthetic_request",
           "synthetic_trace", "SlotScheduler", "SpecConfig", "accept_greedy",
           "draft_propose_k"]
