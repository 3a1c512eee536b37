"""Generative serving of the port (counterpart of ``paddle_tpu/serving``):
paged KV cache with refcounted pages, copy-on-write prefix sharing,
continuous-batching engine with speculative decoding, disaggregated
prefill and decode tiers with the KV handoff, in-process service and the
``:generate`` / ``:prefill`` / ``:decode`` HTTP endpoint."""
from __future__ import annotations

from .admission import (AdmissionController, DeadlineExceededError,
                        ModelUnavailableError, OverloadError, ServingError)
from .batcher import bucket_for, padding_buckets
from .disagg import HandoffArtifact, PrefillEngine, ship
from .generator import (GenerationEngine, GenRequest, GenResult,
                        reference_decode, sample_token)
from .httpd import make_server, serve_until_shutdown
from .kvcache import BlockTable, PagePool, PoolExhausted, pages_for
from .prefix import PrefixCache, chunk_keys
from .service import InferenceService
from .speculative import DraftEngine

__all__ = ["AdmissionController", "BlockTable", "DeadlineExceededError",
           "DraftEngine", "GenRequest", "GenResult", "GenerationEngine",
           "HandoffArtifact", "InferenceService", "ModelUnavailableError",
           "OverloadError", "PagePool", "PoolExhausted", "PrefillEngine",
           "PrefixCache", "ServingError", "bucket_for", "chunk_keys",
           "make_server", "padding_buckets", "pages_for",
           "reference_decode", "sample_token", "serve_until_shutdown",
           "ship"]
