"""Serving of the port: paged KV cache, sampling and the engine."""
