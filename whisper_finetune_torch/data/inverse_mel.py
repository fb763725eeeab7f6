"""Mel spectrogram back to audio (Griffin-Lim), numpy/scipy on the host.

The reference's ``inverse_mel_to_audio`` (its data/utils.py:407-444) wraps
librosa: raise the (log-)mel elementwise to ``power``, invert the mel
filterbank to a linear-frequency magnitude, and recover a phase with
Griffin-Lim. librosa is not part of this stack, so the three steps are
written here:

* :func:`mel_to_stft` solves ``FB.T @ P = M`` for a non-negative power
  spectrogram ``P`` frame by frame (non-negative least squares, scipy's
  ``nnls``) and returns its square root, the magnitude;
* :func:`griffin_lim` alternates scipy's STFT and inverse STFT (periodic
  Hann window, ``N_FFT`` / ``HOP_LENGTH``), keeping the given magnitude and
  the estimate's phase, with the fast Griffin-Lim momentum; the initial
  phase is drawn from a seeded generator, so the result is deterministic
  (a zero phase would make every frame a zero-phase pulse, and their
  overlap-add a 100 Hz comb);
* :func:`inverse_mel_to_audio` is the public call, with the reference's
  elementwise power pre-emphasis kept as it is.

It serves exploratory tooling (listening to augmented features); nothing on
the training path calls it.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import nnls
from scipy.signal import istft, stft

from whisper_finetune_torch.ops.mel import HOP_LENGTH, N_FFT, SAMPLE_RATE, mel_filterbank


def mel_to_stft(mel: np.ndarray, sample_rate: int = SAMPLE_RATE,
                n_fft: int = N_FFT) -> np.ndarray:
    """Power mel (n_mels, T) -> linear magnitude (n_fft // 2 + 1, T): per
    frame the non-negative power spectrum whose mel projection is closest to
    the frame, square-rooted."""
    mel = np.asarray(mel, dtype=np.float64)
    fb = mel_filterbank(mel.shape[0], sr=sample_rate, n_fft=n_fft).astype(np.float64)
    a = fb.T  # (n_mels, n_freq)
    power = np.empty((a.shape[1], mel.shape[1]))
    for t in range(mel.shape[1]):
        power[:, t], _ = nnls(a, mel[:, t])
    return np.sqrt(power)


def _stft(x: np.ndarray, n_fft: int, hop_length: int) -> np.ndarray:
    return stft(x, fs=1.0, window="hann", nperseg=n_fft, noverlap=n_fft - hop_length,
                boundary="zeros", padded=True)[2]


def _istft(z: np.ndarray, n_fft: int, hop_length: int) -> np.ndarray:
    return istft(z, fs=1.0, window="hann", nperseg=n_fft, noverlap=n_fft - hop_length,
                 boundary=True)[1]


_MOMENTUM = 0.99  # fast Griffin-Lim (librosa's default)


def griffin_lim(magnitude: np.ndarray, n_iter: int = 32, n_fft: int = N_FFT,
                hop_length: int = HOP_LENGTH) -> np.ndarray:
    """Magnitude (n_fft // 2 + 1, T) -> float32 audio of about
    ``T * hop_length`` samples."""
    mag = np.asarray(magnitude, dtype=np.float64)
    phase = np.random.default_rng(0).uniform(0.0, 2.0 * np.pi, mag.shape)
    angles = np.exp(1j * phase)
    rebuilt = np.zeros(mag.shape, dtype=np.complex128)
    for _ in range(n_iter):
        prev = rebuilt
        audio = _istft(mag * angles, n_fft, hop_length)
        rebuilt = _stft(audio, n_fft, hop_length)[:, : mag.shape[1]]
        if rebuilt.shape[1] < mag.shape[1]:
            rebuilt = np.pad(rebuilt, ((0, 0), (0, mag.shape[1] - rebuilt.shape[1])))
        angles = rebuilt - (_MOMENTUM / (1.0 + _MOMENTUM)) * prev
        angles /= np.maximum(np.abs(angles), 1e-16)
    return _istft(mag * angles, n_fft, hop_length).astype(np.float32)


def inverse_mel_to_audio(mel_spectrogram, sample_rate: int = SAMPLE_RATE,
                         n_fft: int = N_FFT, hop_length: int = HOP_LENGTH,
                         power: float = 10.0, n_iter: int = 32) -> np.ndarray:
    """(n_mels, T) mel, a numpy array or a torch tensor -> float32 audio.
    The input is raised elementwise to ``power`` first (the reference's
    pre-emphasis of a normalised log-mel; ``power=1`` for a power mel)."""
    if hasattr(mel_spectrogram, "detach"):
        mel_spectrogram = mel_spectrogram.detach().cpu().numpy()
    mel = np.asarray(mel_spectrogram, dtype=np.float64) ** power
    magnitude = mel_to_stft(mel, sample_rate=sample_rate, n_fft=n_fft)
    return griffin_lim(magnitude, n_iter=n_iter, n_fft=n_fft, hop_length=hop_length)
