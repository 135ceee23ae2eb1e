"""Serving steps of the port's LM stack (prefill and decode)."""
from .decode import make_prefill_cache_step, make_prefill_step, make_serve_step

__all__ = ["make_prefill_cache_step", "make_prefill_step", "make_serve_step"]
