"""Audio frontend: log-mel spectrograms (whisper-style), in numpy.

A copy of ``modal_examples_tpu/utils/audio.py`` (the port imports nothing of
the JAX package): Slaney-scale mel filterbank, 25ms/10ms framing at 16kHz,
80 bins — whisper's geometry — and a synthetic tone for tests and benches.
"""

from __future__ import annotations

import functools

import numpy as np

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 80
CHUNK_SECONDS = 30
N_FRAMES = CHUNK_SECONDS * SAMPLE_RATE // HOP  # 3000


def _hz_to_mel(f):
    # slaney scale: linear below 1kHz, log above
    f = np.asarray(f, np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3)
    logstep = np.log(6.4) / 27.0
    mel = f / (200.0 / 3)
    above = f >= min_log_hz
    mel = np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3)
    logstep = np.log(6.4) / 27.0
    f = m * (200.0 / 3)
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


@functools.lru_cache(maxsize=4)
def mel_filterbank(n_mels: int = N_MELS, n_fft: int = N_FFT, sr: int = SAMPLE_RATE):
    """[n_mels, n_fft//2 + 1] slaney-normalized triangular filters."""
    fft_freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lo, center, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lo) / max(center - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - center, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        fb[i] *= 2.0 / max(hi - lo, 1e-10)  # slaney area normalization
    return fb.astype(np.float32)


def log_mel_spectrogram(
    audio: np.ndarray, n_mels: int = N_MELS, pad_to_chunk: bool = True
) -> np.ndarray:
    """waveform [T] float32 (16kHz) -> log-mel [n_frames, n_mels]."""
    audio = np.asarray(audio, np.float32)
    if pad_to_chunk:
        target = CHUNK_SECONDS * SAMPLE_RATE
        audio = np.pad(audio[:target], (0, max(0, target - len(audio))))
    elif len(audio) < N_FFT:  # guarantee at least one frame
        audio = np.pad(audio, (0, N_FFT - len(audio)))
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    n_frames = 1 + (len(audio) - N_FFT) // HOP
    frames = np.lib.stride_tricks.as_strided(
        audio,
        shape=(n_frames, N_FFT),
        strides=(audio.strides[0] * HOP, audio.strides[0]),
    )
    spec = np.abs(np.fft.rfft(frames * window, axis=-1)) ** 2  # [T, F]
    mel = spec @ mel_filterbank(n_mels).T  # [T, n_mels]
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def synth_tone_audio(freqs: list[float], seconds: float = 1.0) -> np.ndarray:
    """Deterministic synthetic audio (test/dev corpus in a zero-egress env)."""
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    wave = sum(np.sin(2 * np.pi * f * t) for f in freqs) / max(len(freqs), 1)
    return wave.astype(np.float32)
