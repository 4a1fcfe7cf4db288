"""repro_torch.serve — the streaming §7 data-mining services on the tick
core (the LM serving engine and its KV pages arrive with the LM serving
slice of the port)."""
from .apps import StreamKMeans, StreamSimJoin
from .tick import StatsRing, Ticket, TickCore, TickStats

__all__ = [
    "StatsRing",
    "StreamKMeans",
    "StreamSimJoin",
    "Ticket",
    "TickCore",
    "TickStats",
]
