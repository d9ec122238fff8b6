"""Serving: the continuous-batching engine over a fixed-slot KV cache."""
from .engine import Request, ServeEngine  # noqa: F401
