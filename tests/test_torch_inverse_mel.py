"""The port's mel inversion (``whisper_finetune_torch/data/inverse_mel.py``)
against the contract of ``tests/test_inverse_mel.py``: the same three cases,
run on the port's module and its own mel filterbank. The JAX package's
module is not in the repository, so there is no JAX function to compare
with; the cases are the contract."""

import numpy as np
import torch
from scipy.signal import stft

from whisper_finetune_torch.data.inverse_mel import (
    griffin_lim,
    inverse_mel_to_audio,
    mel_to_stft,
)
from whisper_finetune_torch.ops.mel import HOP_LENGTH, N_FFT, SAMPLE_RATE, mel_filterbank


def _power_stft(audio: np.ndarray) -> np.ndarray:
    _, _, Z = stft(audio, fs=1.0, window="hann", nperseg=N_FFT, noverlap=N_FFT - HOP_LENGTH,
                   boundary="zeros", padded=True)
    return np.abs(Z) ** 2


def _tone(freqs, seconds=1.0):
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    return sum(a * np.sin(2 * np.pi * f * t) for f, a in freqs).astype(np.float32)


def test_mel_to_stft_solves_the_mel_system():
    audio = _tone([(440.0, 0.5), (1337.0, 0.3)])
    S_true = _power_stft(audio)
    FB = mel_filterbank(128)
    M = FB.T @ S_true
    mag = mel_to_stft(M)
    resid = np.linalg.norm(FB.T @ (mag**2) - M) / np.linalg.norm(M)
    assert resid < 1e-3


def test_griffin_lim_recovers_dominant_tone():
    audio = _tone([(440.0, 0.7)])
    mag = np.sqrt(_power_stft(audio))
    out = griffin_lim(mag)
    assert out.dtype == np.float32
    assert abs(len(out) - mag.shape[1] * HOP_LENGTH) <= N_FFT
    spec = np.abs(np.fft.rfft(out[HOP_LENGTH * 10: HOP_LENGTH * 80]))
    peak_hz = np.argmax(spec) * SAMPLE_RATE / (HOP_LENGTH * 70)
    assert abs(peak_hz - 440.0) < 15.0


def test_inverse_mel_to_audio_api_parity():
    audio = _tone([(440.0, 0.5)], seconds=0.5)
    FB = mel_filterbank(80)
    M = FB.T @ _power_stft(audio)
    log_mel = (np.log10(np.maximum(M, 1e-10)) + 4.0) / 4.0
    out_np = inverse_mel_to_audio(log_mel.astype(np.float32))
    out_torch = inverse_mel_to_audio(torch.from_numpy(log_mel.astype(np.float32)))
    assert out_np.dtype == np.float32 and out_np.ndim == 1
    np.testing.assert_allclose(out_np, out_torch, rtol=0, atol=1e-5)
    out_sane = inverse_mel_to_audio(M, power=1)
    spec = np.abs(np.fft.rfft(out_sane))
    peak_hz = np.argmax(spec) * SAMPLE_RATE / len(out_sane)
    assert abs(peak_hz - 440.0) < 20.0
