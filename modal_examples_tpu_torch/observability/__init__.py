"""The port's observability layer: copies of the JAX package's jax-free
modules (``catalog``, ``metrics``, ``trace``, ``journal``, ``reqtrace``,
``profiler``, ``usage``), so the port keeps its own registry, trace stores
and journals. ``usage`` takes the card's peaks, not a TPU's."""
