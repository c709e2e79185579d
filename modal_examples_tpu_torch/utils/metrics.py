"""Copy of ``modal_examples_tpu/utils/metrics.py``: transcription error
rates (``word_error_rate``, ``character_error_rate``) and the cold-start
memory-snapshot recorder :func:`record_snapshot_boot`, pushed from the
executor's supervisor on every snapshot-enabled container boot. Edit
distances run in Python; the reference's optional native Levenshtein gives
the same numbers."""

from __future__ import annotations

#: Prometheus metric names for memory-snapshot cold-start accounting
#: (``snapshot/``). Labels: function=<spec tag>, and result=hit|miss|fallback
#: on the boots counter. Declared in the catalog (observability.catalog).
from ..observability.catalog import (  # noqa: F401
    SNAPSHOT_BOOTS_METRIC,
    SNAPSHOT_CAPTURES_METRIC,
)


def record_snapshot_boot(
    tag: str, result: str, *, captured: bool = False, registry=None
) -> None:
    """Count one snapshot-enabled container boot.

    ``result`` is the boot's snapshot outcome: ``"hit"`` (restored past
    ``snap=True`` hooks), ``"miss"`` (no entry yet; cold boot + capture), or
    ``"fallback"`` (an entry existed but couldn't be used; cold boot).
    ``captured=True`` additionally counts a published snapshot. The executor
    calls this on the supervisor side from the container's ready message, so
    the registry lives in the client process that serves /metrics."""
    from .prometheus import default_registry

    reg = registry if registry is not None else default_registry
    reg.counter_inc(
        SNAPSHOT_BOOTS_METRIC,
        1.0,
        labels={"function": tag, "result": result},
        help="snapshot-enabled container boots by outcome (hit/miss/fallback)",
    )
    if captured:
        reg.counter_inc(
            SNAPSHOT_CAPTURES_METRIC,
            1.0,
            labels={"function": tag},
            help="memory snapshots captured and published to the store",
        )


def _levenshtein(a: list[str], b: list[str]) -> int:
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, wa in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, wb in enumerate(b, 1):
            cur[j] = min(
                prev[j] + 1,  # deletion
                cur[j - 1] + 1,  # insertion
                prev[j - 1] + (wa != wb),  # substitution
            )
        prev = cur
    return prev[-1]


def word_error_rate(references: list[str], hypotheses: list[str]) -> float:
    """Corpus-level WER: total edits / total reference words."""
    edits = 0
    words = 0
    for ref, hyp in zip(references, hypotheses):
        r, h = ref.split(), hyp.split()
        edits += _levenshtein(r, h)
        words += len(r)
    return edits / max(words, 1)


def character_error_rate(references: list[str], hypotheses: list[str]) -> float:
    edits = 0
    chars = 0
    for ref, hyp in zip(references, hypotheses):
        edits += _levenshtein(list(ref), list(hyp))
        chars += len(ref)
    return edits / max(chars, 1)
