"""Paged KV-cache + continuous-batching serving.

paged_cache.py   host-side block pool: pages, page tables, slot lifecycle
scheduler.py     request admission / preemption / retirement + decode plans
sampler.py       device-side temperature/top-k/top-p/penalty sampling
spec.py          prompt-lookup draft proposer (self-speculation)
engine.py        ServingEngine: paged prefill/decode/verify over the model
"""
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.paged_cache import PagedKVCache
from repro_torch.serving.sampler import SamplingParams, branch_seed
from repro_torch.serving.scheduler import (FinishedRequest,
                                           InvalidRequestError, Request,
                                           Scheduler)
from repro_torch.serving.spec import propose_draft

__all__ = ["FinishedRequest", "InvalidRequestError", "PagedKVCache",
           "Request", "SamplingParams", "Scheduler", "ServingEngine",
           "branch_seed", "propose_draft"]
