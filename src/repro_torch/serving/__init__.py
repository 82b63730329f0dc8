"""Paged KV-cache + continuous-batching serving.

paged_cache.py   host-side block pool: pages, page tables, slot lifecycle
scheduler.py     request admission / preemption / retirement + decode plans
sampler.py       device-side temperature/top-k/top-p/penalty sampling
spec.py          prompt-lookup draft proposer (self-speculation)
engine.py        ServingEngine: paged prefill/decode/verify over the model
frontend.py      AsyncFrontend: asyncio token streaming + cancellation
http.py          HttpServer: dependency-free HTTP/1.1 + SSE transport
disagg.py        DisaggPair: prefill/decode workers + KV page handoff
router.py        Router: prefix-cache-aware multi-replica placement
"""
from repro_torch.serving.disagg import DisaggPair, Handoff
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.frontend import AsyncFrontend
from repro_torch.serving.http import (HttpError, HttpServer, http_json,
                                      stream_generate)
from repro_torch.serving.paged_cache import PagedKVCache
from repro_torch.serving.sampler import SamplingParams, branch_seed
from repro_torch.serving.scheduler import (BATCH, INTERACTIVE,
                                           LATENCY_CLASSES, STANDARD,
                                           Completion, DecodeStep,
                                           FinishedRequest,
                                           InvalidRequestError,
                                           LatencyClass, PrefillChunk,
                                           Request, Scheduler,
                                           SequenceGroup)
from repro_torch.serving.router import Router, RouterCore
from repro_torch.serving.spec import propose_draft

__all__ = ["AsyncFrontend", "BATCH", "Completion", "DecodeStep",
           "DisaggPair", "Handoff", "HttpError", "HttpServer",
           "INTERACTIVE", "InvalidRequestError", "LATENCY_CLASSES",
           "LatencyClass", "PagedKVCache", "PrefillChunk", "Request",
           "FinishedRequest", "Router", "RouterCore", "STANDARD",
           "SamplingParams", "Scheduler",
           "SequenceGroup", "ServingEngine", "branch_seed", "http_json",
           "propose_draft", "stream_generate"]
