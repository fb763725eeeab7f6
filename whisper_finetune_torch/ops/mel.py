"""Log-mel spectrogram, the port of ``whisper_finetune_tpu/ops/mel.py``.

16 kHz audio -> 400-point periodic-hann STFT (hop 160, centred, reflect pad)
-> power spectrum with the last frame dropped -> Slaney mel filterbank (80 or
128 bins) -> log10 -> clamp at (max - 8) -> (x + 4) / 4, all in float32.

Precision: the reference runs the framing convolution and the mel projection
at ``Precision.HIGHEST``. A float32 ``conv1d`` on the card goes through cuDNN
in TF32 by default, so the framing here is ``unfold`` (a strided view of the
padded audio) followed by a float32 ``matmul`` against the windowed
[cos | sin] DFT basis. A float32 matmul runs in full float32 unless the
process turns TF32 on (``torch.backends.cuda.matmul.allow_tf32``, off by
default); this module leaves that switch as it finds it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH  # 100


def _hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    """Slaney-style (librosa default) Hz -> mel."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    return np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = mels * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    return np.where(
        log_region,
        min_log_hz * np.exp(logstep * (np.maximum(mels, min_log_mel) - min_log_mel)),
        freqs,
    )


@lru_cache(maxsize=4)
def mel_filterbank(n_mels: int, sr: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_fft//2+1, n_mels)
    (``librosa.filters.mel`` transposed for right-multiplication)."""
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2, n_freqs)
    mel_min = _hz_to_mel_slaney(np.array(0.0))
    mel_max = _hz_to_mel_slaney(np.array(sr / 2.0))
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights = weights * enorm.reshape(-1, 1)
    return weights.T.astype(np.float32)


@lru_cache(maxsize=1)
def _dft_basis(n_fft: int = N_FFT) -> tuple:
    """Windowed real-DFT cos/sin matrices, each (n_fft, n_fft//2+1)."""
    n_freqs = n_fft // 2 + 1
    window = np.hanning(n_fft + 1)[:-1]  # periodic hann
    k = np.arange(n_freqs).reshape(1, -1)
    n = np.arange(n_fft).reshape(-1, 1)
    angle = 2.0 * np.pi * n * k / n_fft
    cos_mat = (np.cos(angle) * window.reshape(-1, 1)).astype(np.float32)
    sin_mat = (-np.sin(angle) * window.reshape(-1, 1)).astype(np.float32)
    return cos_mat, sin_mat


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio (..., n_samples) float -> (..., n_mels, n_samples // 160) float32
    log-mel features, on the audio's device."""
    dev = audio.device
    cos_np, sin_np = _dft_basis()
    n_freqs = cos_np.shape[1]
    basis = torch.from_numpy(np.concatenate([cos_np, sin_np], axis=1)).to(dev)
    filters = torch.from_numpy(mel_filterbank(n_mels)).to(dev)

    n_samples = audio.shape[-1]
    batch_shape = audio.shape[:-1]
    flat = audio.reshape(-1, n_samples).float()
    pad = N_FFT // 2
    padded = F.pad(flat[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)  # (B, n_frames, n_fft) view
    spec = torch.matmul(frames[:, :-1], basis)  # drop the final frame
    real = spec[..., :n_freqs]
    imag = spec[..., n_freqs:]
    power = real * real + imag * imag
    mel = torch.matmul(power, filters)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    max_per_sample = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, max_per_sample - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    out = log_spec.transpose(-1, -2)
    return out.reshape(*batch_shape, *out.shape[1:])
