"""Serving subsystem of the port: requests, slot scheduler, paged KV pool,
prefix index and the continuous-batching engine."""

from repro_torch.serve.cache import seed_decode_caches
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.paged import (BlockPool, SwapState, TRASH_BLOCK,
                                     default_buckets)
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.request import (Request, RequestResult,
                                       shared_prefix_trace, synthetic_request,
                                       synthetic_trace)
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.serve.speculative import (SpecConfig, accept_greedy,
                                           draft_propose_k)

__all__ = ["seed_decode_caches", "ServeEngine", "BlockPool", "SwapState",
           "TRASH_BLOCK", "default_buckets", "PrefixIndex", "Request",
           "RequestResult", "shared_prefix_trace", "synthetic_request",
           "synthetic_trace", "SlotScheduler", "SpecConfig", "accept_greedy",
           "draft_propose_k"]
