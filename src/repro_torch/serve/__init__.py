"""Serving tier: the batched engine (`engine.ServeEngine`)."""

from repro_torch.serve.engine import ServeEngine, ServeStats

__all__ = ["ServeEngine", "ServeStats"]
