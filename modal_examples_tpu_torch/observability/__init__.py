"""The port's observability layer: copies of the JAX package's jax-free
modules (``catalog``, ``metrics``, ``trace``, ``journal``, ``reqtrace``,
``profiler``, ``usage``, ``timeseries``, ``slo``, ``alerts``, ``incident``,
``export``), so the port keeps its own registry, trace stores, journals,
metrics history and incident bundles, and ``canary``, whose golden store
names this card's numeric identity. ``usage`` takes the card's peaks, not a
TPU's.

User code inside a remote function can nest its own spans::

    from modal_examples_tpu_torch.observability import span

    @app.function()
    def work(x):
        with span("load-model"):
            ...
"""

from .trace import span

__all__ = ["span"]
