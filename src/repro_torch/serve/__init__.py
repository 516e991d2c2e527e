"""Serving tier: the batched engine and headroom-aware fleet routing."""

from repro_torch.serve.engine import ServeEngine, ServeStats
from repro_torch.serve.router import (HeadroomRouter, RequestLedger,
                                      RoundRobinRouter, rail_headroom)
from repro_torch.serve.traffic import Request, TrafficTrace, bursty_trace

__all__ = [
    "HeadroomRouter", "Request", "RequestLedger", "RoundRobinRouter",
    "ServeEngine", "ServeStats", "TrafficTrace", "bursty_trace",
    "rail_headroom",
]
