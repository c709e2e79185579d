"""Transcription error rates: a copy of ``word_error_rate`` and
``character_error_rate`` from ``modal_examples_tpu/utils/metrics.py`` (the
rest of that file belongs to the platform layer). Edit distances run in
Python; the reference's optional native Levenshtein gives the same
numbers."""

from __future__ import annotations


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
