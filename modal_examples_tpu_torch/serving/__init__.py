"""Serving: paged KV cache, sampling, the engine and the OpenAI server."""
