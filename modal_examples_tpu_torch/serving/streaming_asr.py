"""Streaming ASR: incremental windowed Whisper with local-agreement
stabilization.

Counterpart of ``modal_examples_tpu/serving/streaming_asr.py``
(``StreamingResult``, ``StreamingTranscriber``) over the port's
``whisper.greedy_transcribe``. Whisper's encoder attends globally over its
window, so there is no causal encoder cache; the streaming recipe
(whisper_streaming's LocalAgreement) is:

1. buffer incoming PCM; every ``hop_s`` seconds re-transcribe the current
   segment (audio since the last segment boundary);
2. emit only the stable prefix: tokens that two consecutive updates agree
   on (LocalAgreement-2);
3. when the segment reaches ``window_s``, commit its full transcription
   and roll over to a fresh segment, so an update's cost is bounded by the
   window and committed text never slides.

Every update transcribes one mel shape (the segment padded to the full
window). The mel is computed on the host and moved to the device that
holds the parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class StreamingResult:
    stable_text: str  # newly committed text this update ("" if none)
    partial_text: str  # best current guess past the committed point
    committed_text: str  # everything committed so far


class StreamingTranscriber:
    """Incremental transcription over window-bounded segments.

    feed() accepts arbitrary-size float32 PCM chunks (16 kHz mono) and
    returns a StreamingResult per update; flush() commits the tail.
    """

    def __init__(
        self,
        params,
        cfg,
        *,
        bos_id: int,
        eos_id: int,
        sample_rate: int = 16000,
        window_s: float = 8.0,
        hop_s: float = 1.0,
        max_tokens: int = 48,
        decode_text=None,  # token list -> str (defaults to chr() join)
    ):
        from ..models import whisper
        from ..utils import audio

        self.params = params
        self.cfg = cfg
        self.bos_id, self.eos_id = bos_id, eos_id
        self.sr = sample_rate
        self.window = int(window_s * sample_rate)
        self.hop = int(hop_s * sample_rate)
        self.max_tokens = max_tokens
        self._decode_text = decode_text or (
            lambda toks: "".join(chr(t) for t in toks)
        )
        self._audio = audio
        self._device = params["tok_emb"].device

        self._segment = np.zeros((0,), np.float32)  # current segment's PCM
        self._pending = np.zeros((0,), np.float32)  # beyond the window cap
        self._since_update = 0
        self._committed: list[int] = []  # across all segments
        self._seg_committed = 0  # committed tokens in the CURRENT segment
        self._prev_tail: list[int] = []

        def transcribe(mel):
            return whisper.greedy_transcribe(
                params, mel, cfg, bos_id=bos_id, eos_id=eos_id,
                max_tokens=max_tokens,
            )

        self._transcribe = transcribe

    # -- internals ----------------------------------------------------------

    def _segment_tokens(self) -> list[int]:
        """Transcribe the current segment padded to the full window."""
        pcm = self._segment
        if len(pcm) < self.window:
            pcm = np.concatenate(
                [pcm, np.zeros(self.window - len(pcm), np.float32)]
            )
        mel = self._audio.log_mel_spectrogram(
            pcm, n_mels=self.cfg.n_mels
        )[None]  # [1, T, n_mels]
        mel = torch.from_numpy(mel).to(self._device)
        toks = self._transcribe(mel)[0].cpu().numpy()
        out = []
        for t in toks.tolist():
            if t == self.eos_id:
                break
            out.append(t)
        return out

    @staticmethod
    def _common_prefix(a: list[int], b: list[int]) -> int:
        n = 0
        for x, y in zip(a, b):
            if x != y:
                break
            n += 1
        return n

    def _update(self) -> StreamingResult:
        toks = self._segment_tokens()
        # committed tokens stay at the front of the segment's output (the
        # segment never slides); later updates may "revise" them but commits
        # are final — the standard streaming contract
        tail = toks[self._seg_committed:]
        agree = self._common_prefix(self._prev_tail, tail)
        newly = tail[:agree]
        self._committed.extend(newly)
        self._seg_committed += agree
        self._prev_tail = tail[agree:]
        return StreamingResult(
            stable_text=self._decode_text(newly),
            partial_text=self._decode_text(self._prev_tail),
            committed_text=self._decode_text(self._committed),
        )

    def _rollover(self) -> StreamingResult:
        """Segment hit the window cap: commit its full transcription and
        start a fresh segment from the pending audio."""
        toks = self._segment_tokens()
        newly = toks[self._seg_committed:]
        self._committed.extend(newly)
        # the next segment is capped at the window too (one huge feed()
        # chunk can leave more than a window pending — it must not break
        # the one-static-mel-shape contract or chunk-size invariance)
        self._segment = self._pending[: self.window]
        self._pending = self._pending[self.window:]
        self._seg_committed = 0
        self._prev_tail = []
        return StreamingResult(
            stable_text=self._decode_text(newly),
            partial_text="",
            committed_text=self._decode_text(self._committed),
        )

    # -- public API ---------------------------------------------------------

    def feed(self, pcm: np.ndarray) -> StreamingResult | None:
        """Append a PCM chunk; runs an update every ``hop_s`` of audio.
        Returns None when not enough new audio has arrived yet."""
        pcm = np.asarray(pcm, np.float32).reshape(-1)
        room = self.window - len(self._segment)
        self._segment = np.concatenate([self._segment, pcm[:room]])
        if len(pcm) > room:
            self._pending = np.concatenate([self._pending, pcm[room:]])
        self._since_update += len(pcm)
        if len(self._segment) >= self.window:
            self._since_update = 0
            return self._rollover()
        if self._since_update < self.hop:
            return None
        self._since_update = 0
        return self._update()

    def flush(self) -> StreamingResult:
        """End of stream: commit every remaining segment in full. Empty
        segments are skipped — transcribing pure padding would commit the
        model's hallucination for silence (the classic Whisper failure)."""
        out = None
        while True:
            if len(self._segment) == 0:
                newly = []
            else:
                toks = self._segment_tokens()
                newly = toks[self._seg_committed:]
            self._committed.extend(newly)
            if len(self._pending) == 0:
                out = StreamingResult(
                    stable_text=self._decode_text(newly),
                    partial_text="",
                    committed_text=self._decode_text(self._committed),
                )
                self._segment = np.zeros((0,), np.float32)
                self._seg_committed = 0
                self._prev_tail = []
                return out
            self._segment = self._pending[: self.window]
            self._pending = self._pending[self.window:]
            self._seg_committed = 0
            self._prev_tail = []
