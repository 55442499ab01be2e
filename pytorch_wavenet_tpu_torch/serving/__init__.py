from .batcher import (
    ContinuousBatcher,
    GenerationHandle,
    PoolOverloaded,
    RequestCancelled,
    follow_pool,
)

__all__ = [
    "ContinuousBatcher",
    "GenerationHandle",
    "PoolOverloaded",
    "RequestCancelled",
    "follow_pool",
]
