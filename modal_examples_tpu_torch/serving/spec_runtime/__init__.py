"""Speculative decoding on the engine's scheduler.

Counterpart of ``modal_examples_tpu/serving/spec_runtime/``: one
propose+verify+accept round per dispatch (:mod:`.runtime`, on
``ops.scan_loop.masked_scan``, emitting the macro-step harvest plane) and the
acceptance-driven per-request γ policy (:mod:`.controller`). The
single-sequence loop of ``serving/speculative.py`` is not on the serving
path: it is the oracle the round is tested against, and nothing in the
package imports it.
"""

from .controller import AdaptiveGammaController
from .runtime import SPEC_ADAPTIVE_ENV, accept_reject, build_ngram_round_fn, build_spec_round_fn, resolve_spec_adaptive

__all__ = [
    "AdaptiveGammaController",
    "SPEC_ADAPTIVE_ENV",
    "accept_reject",
    "build_ngram_round_fn",
    "build_spec_round_fn",
    "resolve_spec_adaptive",
]
