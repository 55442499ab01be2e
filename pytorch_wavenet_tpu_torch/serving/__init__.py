from .batcher import (
    ContinuousBatcher,
    GenerationHandle,
    PoolOverloaded,
    RequestCancelled,
)

__all__ = [
    "ContinuousBatcher",
    "GenerationHandle",
    "PoolOverloaded",
    "RequestCancelled",
]
