"""Continuous-batching serving of the port: paged KV cache, scheduler,
engine."""
from repro_torch.serve.engine import Engine, EngineConfig, sample_tokens  # noqa: F401
from repro_torch.serve.paging import PageAllocator, PagedLayout  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    Request, Scheduler, StreamError, SubmitError)
