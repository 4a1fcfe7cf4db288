"""repro_torch.serve — the LM serving engine (continuous batching over a
Hilbert-paged KV cache) and the streaming §7 data-mining services, all on
the tick core."""
from .apps import StreamKMeans, StreamSimJoin
from .engine import Request, ServeEngine
from .kv_pages import TRASH_PAGE, PagedKVCache
from .tick import StatsRing, Ticket, TickCore, TickStats

__all__ = [
    "PagedKVCache",
    "Request",
    "ServeEngine",
    "StatsRing",
    "StreamKMeans",
    "StreamSimJoin",
    "TRASH_PAGE",
    "Ticket",
    "TickCore",
    "TickStats",
]
