"""The inference-serving layer (``repro/serve``): one slot-based
continuous-batching core (``SlotServeCore``) with two engines on it,
``ServeEngine`` (LM decode over a static KV cache) and
``GraphServeEngine`` (GCN node prediction through bucketed compiled plans:
sample, pad into a shape bucket, replay the bucket's one CUDA graph)."""

from repro_torch.serve.core import SlotServeCore
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.graph_engine import (Bucket, GraphRequest,
                                            GraphServeEngine,
                                            default_buckets)

__all__ = [
    "SlotServeCore", "ServeEngine", "Request",
    "GraphServeEngine", "GraphRequest", "Bucket", "default_buckets",
]
