"""Macro-step decode runtime.

Counterpart of ``modal_examples_tpu/serving/multistep/``: N decode+sample
steps per dispatch (``ops.scan_loop.masked_scan`` over the engine's decode
step, (seed, position)-keyed sampling, stop-token and length-budget early
exit), so the host pays one blocking read per N tokens, with per-slot
validity masks for an exact harvest; detokenization moves off the scheduler
thread onto :class:`DetokWorker`.

The knob is ``LLMEngine(decode_steps=...)`` / ``MTPU_DECODE_STEPS``, mutable
at runtime; 1 (the default) is the engine's decode-block path.
"""

from .detok import DetokWorker
from .runtime import DECODE_STEPS_ENV, build_multistep_fn, resolve_decode_steps

__all__ = [
    "DECODE_STEPS_ENV",
    "DetokWorker",
    "build_multistep_fn",
    "resolve_decode_steps",
]
