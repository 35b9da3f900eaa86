from repro_torch.serve.batcher import (
    ContinuousBatcher,
    PagePool,
    PagePoolError,
    Request,
    RequestResult,
)
from repro_torch.serve.engine import ServeEngine

__all__ = [
    "ContinuousBatcher",
    "PagePool",
    "PagePoolError",
    "Request",
    "RequestResult",
    "ServeEngine",
]
