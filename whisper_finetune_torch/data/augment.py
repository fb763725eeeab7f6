"""Host-side audio augmentation pipelines.

The reference composes audiomentations transforms into three pipelines
(src/whisper_finetune/model/augment.py:31-150): baseline (TimeStretch only),
advanced (noise / filter bank / gain / pitch) and office (reverb + lo-fi
codecs). audiomentations (and its ffmpeg/pyroomacoustics backends) are not
part of this stack, so the transforms are implemented here directly in
numpy/scipy. Augmentation is stochastic regularization — the contract is the
same *family* of perturbations with the same composition structure and
probabilities, not bit-identical DSP. Known approximations, each documented
on its class: background noise uses a synthetic noise bank when no wav files
are provided (the reference bundles mp3s; no mp3 decoder here), RoomSimulator
uses a synthetic exponential-decay impulse response instead of a full
image-source model, Mp3Compression is modeled as bandwidth reduction +
spectral quantization.

Audio stays host-side CPU work (pre-device, inside loader workers) exactly as
in the reference — none of this touches the device.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
from scipy import signal as sps

SAMPLE_RATE = 16000


def _rng(rng: Optional[np.random.Generator]) -> np.random.Generator:
    return rng if rng is not None else np.random.default_rng()


def _db_to_amp(db: float) -> float:
    return 10.0 ** (db / 20.0)


def _rms(x: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(x)) + 1e-12))


class Transform:
    """Base augmentation: applied with probability ``p``."""

    def __init__(self, p: float = 0.5):
        self.p = float(p)

    def __call__(self, samples: np.ndarray, sample_rate: int = SAMPLE_RATE,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = _rng(rng)
        if rng.random() < self.p:
            return self.apply(np.asarray(samples, dtype=np.float32), sample_rate, rng)
        return samples

    def apply(self, samples, sample_rate, rng):  # pragma: no cover - abstract
        raise NotImplementedError


class Compose(Transform):
    def __init__(self, transforms: Sequence[Transform], p: float = 1.0):
        super().__init__(p)
        self.transforms = list(transforms)

    def apply(self, samples, sample_rate, rng):
        for t in self.transforms:
            samples = t(samples, sample_rate, rng)
        return samples


class OneOf(Transform):
    def __init__(self, transforms: Sequence[Transform], p: float = 1.0):
        super().__init__(p)
        self.transforms = list(transforms)

    def apply(self, samples, sample_rate, rng):
        t = self.transforms[int(rng.integers(len(self.transforms)))]
        # audiomentations OneOf forces the chosen transform to run.
        return t.apply(np.asarray(samples, dtype=np.float32), sample_rate, rng)


# ---------------------------------------------------------------------------
# Tempo / pitch
# ---------------------------------------------------------------------------

def _phase_vocoder_stretch(x: np.ndarray, rate: float, n_fft: int = 1024,
                           hop: int = 256) -> np.ndarray:
    """Classic phase-vocoder time stretch (tempo change, pitch preserved)."""
    if abs(rate - 1.0) < 1e-3 or len(x) < n_fft * 2:
        return x
    _, _, stft = sps.stft(x, nperseg=n_fft, noverlap=n_fft - hop, padded=True)
    n_bins, n_frames = stft.shape
    out_frames = int(n_frames / rate)
    time_steps = np.arange(out_frames) * rate

    mag = np.abs(stft)
    phase = np.angle(stft)
    expected = 2.0 * np.pi * hop * np.arange(n_bins) / n_fft

    # Fully vectorized over output frames: the per-frame phase accumulator
    # is acc_t = phase[:, 0] + sum_{u<t} (expected + wrapped dphase_u), a
    # cumulative sum — the loop form cost ~430 ms per 30 s clip on this
    # 1-core host (host-starving the chip ~3x for augment-enabled configs);
    # this form is ~linear-algebra only.
    # float32 throughout (the loop form accumulated in float32 too);
    # float64 temporaries + complex exp were the remaining hot spots.
    two_pi = np.float32(2.0 * np.pi)
    mag = mag.astype(np.float32, copy=False)
    phase = phase.astype(np.float32, copy=False)
    expected = expected.astype(np.float32)[:, None]
    i0 = np.minimum(time_steps.astype(np.int64), n_frames - 1)
    i1 = np.minimum(i0 + 1, n_frames - 1)
    frac = (time_steps - np.floor(time_steps)).astype(np.float32)
    m = (np.float32(1.0) - frac) * mag[:, i0] + frac * mag[:, i1]
    dphase = phase[:, i1] - phase[:, i0] - expected
    dphase -= two_pi * np.round(dphase / two_pi)
    inc = expected + dphase
    acc = phase[:, :1] + np.concatenate(
        [np.zeros((n_bins, 1), np.float32), np.cumsum(inc[:, :-1], axis=1)],
        axis=1,
    )
    out = np.empty(acc.shape, dtype=np.complex64)
    out.real = m * np.cos(acc)
    out.imag = m * np.sin(acc)
    _, y = sps.istft(out, nperseg=n_fft, noverlap=n_fft - hop)
    return y.astype(np.float32)


class TimeStretch(Transform):
    def __init__(self, min_rate=0.8, max_rate=1.25, leave_length_unchanged=False, p=0.5):
        super().__init__(p)
        self.min_rate, self.max_rate = min_rate, max_rate
        self.leave_length_unchanged = leave_length_unchanged

    def apply(self, samples, sample_rate, rng):
        rate = rng.uniform(self.min_rate, self.max_rate)
        out = _phase_vocoder_stretch(samples, rate)
        if self.leave_length_unchanged:
            if len(out) >= len(samples):
                out = out[: len(samples)]
            else:
                out = np.pad(out, (0, len(samples) - len(out)))
        return out.astype(np.float32)


class PitchShift(Transform):
    def __init__(self, min_semitones=-4.0, max_semitones=4.0, p=0.5):
        super().__init__(p)
        self.min_semitones, self.max_semitones = min_semitones, max_semitones

    def apply(self, samples, sample_rate, rng):
        semitones = rng.uniform(self.min_semitones, self.max_semitones)
        factor = 2.0 ** (semitones / 12.0)
        # stretch to 1/factor length (pitch preserved), then resample back to
        # the original length -> pitch scaled by factor, duration unchanged.
        stretched = _phase_vocoder_stretch(samples, 1.0 / factor)
        idx = np.linspace(0, len(stretched) - 1, len(samples))
        return np.interp(idx, np.arange(len(stretched)), stretched).astype(np.float32)


# ---------------------------------------------------------------------------
# Noise
# ---------------------------------------------------------------------------

class AddGaussianNoise(Transform):
    def __init__(self, min_amplitude=0.001, max_amplitude=0.015, p=0.5):
        super().__init__(p)
        self.min_amplitude, self.max_amplitude = min_amplitude, max_amplitude

    def apply(self, samples, sample_rate, rng):
        amp = rng.uniform(self.min_amplitude, self.max_amplitude)
        return (samples + amp * rng.standard_normal(len(samples))).astype(np.float32)


class AddGaussianSNR(Transform):
    def __init__(self, min_snr_db=5.0, max_snr_db=40.0, p=0.5):
        super().__init__(p)
        self.min_snr_db, self.max_snr_db = min_snr_db, max_snr_db

    def apply(self, samples, sample_rate, rng):
        snr_db = rng.uniform(self.min_snr_db, self.max_snr_db)
        noise_rms = _rms(samples) / _db_to_amp(snr_db)
        return (samples + noise_rms * rng.standard_normal(len(samples))).astype(
            np.float32
        )


def _synthetic_noise_bank(rng: np.random.Generator, n: int = 4,
                          length: int = SAMPLE_RATE * 30) -> List[np.ndarray]:
    """Colored-noise stand-ins for the reference's bundled office mp3s
    (model/bg_noise/*.mp3; no mp3 decoder in this image)."""
    bank = []
    for i in range(n):
        white = rng.standard_normal(length).astype(np.float32)
        # shape the spectrum: 1/f^alpha with alpha in [0.5, 1.5]
        spec = np.fft.rfft(white)
        freqs = np.maximum(np.fft.rfftfreq(length, 1 / SAMPLE_RATE), 1.0)
        alpha = 0.5 + i * (1.0 / max(n - 1, 1))
        colored = np.fft.irfft(spec / freqs**alpha, n=length).astype(np.float32)
        bank.append(colored / (_rms(colored) + 1e-9))
    return bank


class AddBackgroundNoise(Transform):
    def __init__(self, sounds_path=None, noise_rms="relative",
                 min_absolute_rms_db=-45.0, max_absolute_rms_db=-15.0,
                 min_snr_db=3.0, max_snr_db=30.0, p=0.5):
        super().__init__(p)
        self.noise_rms = noise_rms
        self.min_absolute_rms_db = min_absolute_rms_db
        self.max_absolute_rms_db = max_absolute_rms_db
        self.min_snr_db, self.max_snr_db = min_snr_db, max_snr_db
        self._bank = self._load_bank(sounds_path)

    @staticmethod
    def _load_bank(sounds_path) -> List[np.ndarray]:
        import glob
        import os

        if sounds_path is None:
            # packaged office-ambience bank (the reference ships
            # model/bg_noise/*.mp3; ours is assets/bg_noise/*.wav, generated
            # deterministically by tools/make_bg_noise_bank.py)
            packaged = os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "assets", "bg_noise",
            )
            if os.path.isdir(packaged):
                sounds_path = packaged

        bank: List[np.ndarray] = []
        if sounds_path and os.path.isdir(sounds_path):
            from scipy.io import wavfile

            for path in sorted(glob.glob(os.path.join(sounds_path, "*.wav"))):
                try:
                    sr, data = wavfile.read(path)
                    data = np.asarray(data, dtype=np.float32)
                    if data.ndim > 1:
                        data = data.mean(axis=1)
                    peak = np.abs(data).max() or 1.0
                    bank.append(data / peak)
                except Exception:
                    continue
        if not bank:
            bank = _synthetic_noise_bank(np.random.default_rng(0))
        return bank

    def apply(self, samples, sample_rate, rng):
        noise = self._bank[int(rng.integers(len(self._bank)))]
        if len(noise) < len(samples):
            reps = int(math.ceil(len(samples) / len(noise)))
            noise = np.tile(noise, reps)
        start = int(rng.integers(0, len(noise) - len(samples) + 1))
        noise = noise[start : start + len(samples)]

        if self.noise_rms == "absolute":
            target = _db_to_amp(
                rng.uniform(self.min_absolute_rms_db, self.max_absolute_rms_db)
            )
            noise = noise * (target / (_rms(noise) + 1e-9))
        else:
            snr_db = rng.uniform(self.min_snr_db, self.max_snr_db)
            noise = noise * (_rms(samples) / _db_to_amp(snr_db) / (_rms(noise) + 1e-9))
        return (samples + noise).astype(np.float32)


# ---------------------------------------------------------------------------
# Levels
# ---------------------------------------------------------------------------

class Gain(Transform):
    def __init__(self, min_gain_db=-12.0, max_gain_db=12.0, p=0.5):
        super().__init__(p)
        self.min_gain_db, self.max_gain_db = min_gain_db, max_gain_db

    def apply(self, samples, sample_rate, rng):
        return samples * _db_to_amp(rng.uniform(self.min_gain_db, self.max_gain_db))


class GainTransition(Transform):
    def __init__(self, min_gain_db=-24.0, max_gain_db=6.0, p=0.5):
        super().__init__(p)
        self.min_gain_db, self.max_gain_db = min_gain_db, max_gain_db

    def apply(self, samples, sample_rate, rng):
        g0 = _db_to_amp(rng.uniform(self.min_gain_db, self.max_gain_db))
        g1 = _db_to_amp(rng.uniform(self.min_gain_db, self.max_gain_db))
        n = len(samples)
        a = int(rng.integers(0, max(n - 1, 1)))
        b = int(rng.integers(a + 1, n + 1))
        ramp = np.ones(n, dtype=np.float32) * g0
        ramp[a:b] = np.linspace(g0, g1, b - a)
        ramp[b:] = g1
        return samples * ramp


class LoudnessNormalization(Transform):
    """RMS-based loudness normalization to a random target level
    (approximation of LUFS normalization)."""

    def __init__(self, min_lufs=-31.0, max_lufs=-13.0, p=0.5):
        super().__init__(p)
        self.min_lufs, self.max_lufs = min_lufs, max_lufs

    def apply(self, samples, sample_rate, rng):
        target = _db_to_amp(rng.uniform(self.min_lufs, self.max_lufs))
        return samples * (target / (_rms(samples) + 1e-9))


class Shift(Transform):
    def __init__(self, min_shift=-0.5, max_shift=0.5, rollover=True, p=0.5):
        super().__init__(p)
        self.min_shift, self.max_shift = min_shift, max_shift
        self.rollover = rollover

    def apply(self, samples, sample_rate, rng):
        frac = rng.uniform(self.min_shift, self.max_shift)
        k = int(round(frac * len(samples)))
        out = np.roll(samples, k)
        if not self.rollover:
            if k > 0:
                out[:k] = 0
            elif k < 0:
                out[k:] = 0
        return out


class ClippingDistortion(Transform):
    def __init__(self, min_percentile_threshold=0, max_percentile_threshold=40, p=0.5):
        super().__init__(p)
        self.min_pct, self.max_pct = min_percentile_threshold, max_percentile_threshold

    def apply(self, samples, sample_rate, rng):
        pct = rng.integers(self.min_pct, self.max_pct + 1)
        lo, hi = np.percentile(samples, [pct / 2, 100 - pct / 2])
        return np.clip(samples, lo, hi).astype(np.float32)


# ---------------------------------------------------------------------------
# Filters (biquads / butterworth)
# ---------------------------------------------------------------------------

def _sos_filter(samples, sos):
    return sps.sosfilt(sos, samples).astype(np.float32)


class LowPassFilter(Transform):
    def __init__(self, min_cutoff_freq=150.0, max_cutoff_freq=7500.0, p=0.5):
        super().__init__(p)
        self.lo, self.hi = min_cutoff_freq, max_cutoff_freq

    def apply(self, samples, sample_rate, rng):
        cutoff = min(rng.uniform(self.lo, self.hi), sample_rate / 2 * 0.99)
        sos = sps.butter(4, cutoff, "lowpass", fs=sample_rate, output="sos")
        return _sos_filter(samples, sos)


class HighPassFilter(Transform):
    def __init__(self, min_cutoff_freq=20.0, max_cutoff_freq=2400.0, p=0.5):
        super().__init__(p)
        self.lo, self.hi = min_cutoff_freq, max_cutoff_freq

    def apply(self, samples, sample_rate, rng):
        cutoff = min(rng.uniform(self.lo, self.hi), sample_rate / 2 * 0.99)
        sos = sps.butter(4, cutoff, "highpass", fs=sample_rate, output="sos")
        return _sos_filter(samples, sos)


class BandPassFilter(Transform):
    def __init__(self, min_center_freq=200.0, max_center_freq=4000.0, p=0.5):
        super().__init__(p)
        self.lo, self.hi = min_center_freq, max_center_freq

    def apply(self, samples, sample_rate, rng):
        center = rng.uniform(self.lo, self.hi)
        bw = center * rng.uniform(0.5, 1.99)
        lo = max(center - bw / 2, 10.0)
        hi = min(center + bw / 2, sample_rate / 2 * 0.99)
        sos = sps.butter(2, [lo, hi], "bandpass", fs=sample_rate, output="sos")
        return _sos_filter(samples, sos)


class BandStopFilter(BandPassFilter):
    def apply(self, samples, sample_rate, rng):
        center = rng.uniform(self.lo, self.hi)
        bw = center * rng.uniform(0.5, 1.99)
        lo = max(center - bw / 2, 10.0)
        hi = min(center + bw / 2, sample_rate / 2 * 0.99)
        sos = sps.butter(2, [lo, hi], "bandstop", fs=sample_rate, output="sos")
        return _sos_filter(samples, sos)


def _rbj_shelf(samples, sample_rate, freq, gain_db, kind):
    """RBJ audio-EQ-cookbook shelf biquad."""
    A = 10 ** (gain_db / 40.0)
    w0 = 2 * math.pi * freq / sample_rate
    alpha = math.sin(w0) / 2 * math.sqrt(2.0)
    cosw = math.cos(w0)
    sqA = math.sqrt(A)
    if kind == "low":
        b0 = A * ((A + 1) - (A - 1) * cosw + 2 * sqA * alpha)
        b1 = 2 * A * ((A - 1) - (A + 1) * cosw)
        b2 = A * ((A + 1) - (A - 1) * cosw - 2 * sqA * alpha)
        a0 = (A + 1) + (A - 1) * cosw + 2 * sqA * alpha
        a1 = -2 * ((A - 1) + (A + 1) * cosw)
        a2 = (A + 1) + (A - 1) * cosw - 2 * sqA * alpha
    else:
        b0 = A * ((A + 1) + (A - 1) * cosw + 2 * sqA * alpha)
        b1 = -2 * A * ((A - 1) + (A + 1) * cosw)
        b2 = A * ((A + 1) + (A - 1) * cosw - 2 * sqA * alpha)
        a0 = (A + 1) - (A - 1) * cosw + 2 * sqA * alpha
        a1 = 2 * ((A - 1) - (A + 1) * cosw)
        a2 = (A + 1) - (A - 1) * cosw - 2 * sqA * alpha
    b = np.array([b0, b1, b2]) / a0
    a = np.array([1.0, a1 / a0, a2 / a0])
    return sps.lfilter(b, a, samples).astype(np.float32)


class LowShelfFilter(Transform):
    def __init__(self, min_center_freq=50.0, max_center_freq=4000.0,
                 min_gain_db=-18.0, max_gain_db=18.0, p=0.5):
        super().__init__(p)
        self.flo, self.fhi = min_center_freq, max_center_freq
        self.glo, self.ghi = min_gain_db, max_gain_db

    def apply(self, samples, sample_rate, rng):
        return _rbj_shelf(
            samples, sample_rate,
            rng.uniform(self.flo, self.fhi), rng.uniform(self.glo, self.ghi), "low",
        )


class HighShelfFilter(LowShelfFilter):
    def __init__(self, min_center_freq=300.0, max_center_freq=7500.0,
                 min_gain_db=-18.0, max_gain_db=18.0, p=0.5):
        super().__init__(min_center_freq, max_center_freq, min_gain_db, max_gain_db, p)

    def apply(self, samples, sample_rate, rng):
        return _rbj_shelf(
            samples, sample_rate,
            rng.uniform(self.flo, self.fhi), rng.uniform(self.glo, self.ghi), "high",
        )


class PeakingFilter(Transform):
    def __init__(self, min_center_freq=50.0, max_center_freq=7500.0,
                 min_gain_db=-24.0, max_gain_db=24.0, p=0.5):
        super().__init__(p)
        self.flo, self.fhi = min_center_freq, max_center_freq
        self.glo, self.ghi = min_gain_db, max_gain_db

    def apply(self, samples, sample_rate, rng):
        freq = rng.uniform(self.flo, self.fhi)
        gain_db = rng.uniform(self.glo, self.ghi)
        A = 10 ** (gain_db / 40.0)
        w0 = 2 * math.pi * freq / sample_rate
        Q = 1.0
        alpha = math.sin(w0) / (2 * Q)
        cosw = math.cos(w0)
        b = np.array([1 + alpha * A, -2 * cosw, 1 - alpha * A])
        a = np.array([1 + alpha / A, -2 * cosw, 1 - alpha / A])
        return sps.lfilter(b / a[0], a / a[0], samples).astype(np.float32)


class AirAbsorption(Transform):
    """Distance-dependent high-frequency rolloff (approximation of
    audiomentations' table-based air absorption)."""

    def __init__(self, min_distance=10.0, max_distance=50.0, p=0.5):
        super().__init__(p)
        self.min_distance, self.max_distance = min_distance, max_distance

    def apply(self, samples, sample_rate, rng):
        distance = rng.uniform(self.min_distance, self.max_distance)
        cutoff = max(sample_rate / 2 * math.exp(-distance / 60.0), 800.0)
        sos = sps.butter(1, min(cutoff, sample_rate / 2 * 0.99), "lowpass",
                         fs=sample_rate, output="sos")
        return _sos_filter(samples, sos)


class Aliasing(Transform):
    def __init__(self, min_sample_rate=8000, max_sample_rate=30000, p=0.5):
        super().__init__(p)
        self.lo, self.hi = min_sample_rate, max_sample_rate

    def apply(self, samples, sample_rate, rng):
        target = int(rng.integers(self.lo, self.hi))
        n_down = max(int(len(samples) * target / sample_rate), 1)
        idx_down = np.linspace(0, len(samples) - 1, n_down)
        down = samples[np.round(idx_down).astype(int)]  # no anti-alias: aliasing
        idx_up = np.linspace(0, n_down - 1, len(samples))
        return np.interp(idx_up, np.arange(n_down), down).astype(np.float32)


# ---------------------------------------------------------------------------
# Codecs / room
# ---------------------------------------------------------------------------

class BitCrush(Transform):
    def __init__(self, min_bit_depth=5, max_bit_depth=14, p=0.5):
        super().__init__(p)
        self.min_bit_depth, self.max_bit_depth = min_bit_depth, max_bit_depth

    def apply(self, samples, sample_rate, rng):
        bits = int(rng.integers(self.min_bit_depth, self.max_bit_depth + 1))
        q = 2.0 ** (bits - 1)
        return (np.round(samples * q) / q).astype(np.float32)


class Mp3Compression(Transform):
    """Lo-fi codec approximation: bitrate-dependent bandwidth reduction plus
    coarse spectral quantization (stand-in for the reference's
    pydub/ffmpeg-backed Mp3Compression; no mp3 codec in this image)."""

    def __init__(self, min_bitrate=8, max_bitrate=64, backend=None, p=0.5):
        super().__init__(p)
        self.min_bitrate, self.max_bitrate = min_bitrate, max_bitrate

    def apply(self, samples, sample_rate, rng):
        bitrate = int(rng.integers(self.min_bitrate, self.max_bitrate + 1))
        # empirical mp3 bandwidths: ~8kbps -> ~2.5kHz ... 64kbps -> ~7.5kHz
        cutoff = float(np.interp(bitrate, [8, 16, 32, 64], [2500, 4000, 6500, 7500]))
        sos = sps.butter(6, min(cutoff, sample_rate / 2 * 0.99), "lowpass",
                         fs=sample_rate, output="sos")
        out = _sos_filter(samples, sos)
        q = 2.0 ** max(6, int(bitrate / 4))
        return (np.round(out * q) / q).astype(np.float32)


class RoomSimulator(Transform):
    """Small-room reverberation via a synthetic impulse response: direct path
    + sparse early reflections + exponentially decaying diffuse tail, with
    the decay rate derived from the sampled absorption (Sabine's formula) —
    an approximation of the reference's pyroomacoustics image-source room
    (model/augment.py:117-138)."""

    def __init__(self, min_size_x=3.0, max_size_x=5.0, min_size_y=2.5,
                 max_size_y=4.0, min_size_z=2.4, max_size_z=3.0,
                 calculation_mode="absorption", min_absorption_value=0.05,
                 max_absorption_value=0.20, leave_length_unchanged=True,
                 max_order=3, p=0.5):
        super().__init__(p)
        self.size_ranges = ((min_size_x, max_size_x), (min_size_y, max_size_y),
                            (min_size_z, max_size_z))
        self.min_absorption, self.max_absorption = (
            min_absorption_value, max_absorption_value)
        self.leave_length_unchanged = leave_length_unchanged

    def apply(self, samples, sample_rate, rng):
        dims = [rng.uniform(lo, hi) for lo, hi in self.size_ranges]
        absorption = rng.uniform(self.min_absorption, self.max_absorption)
        volume = dims[0] * dims[1] * dims[2]
        surface = 2 * (dims[0] * dims[1] + dims[0] * dims[2] + dims[1] * dims[2])
        rt60 = max(0.161 * volume / (absorption * surface), 0.05)  # Sabine

        ir_len = int(min(rt60, 1.0) * sample_rate)
        t = np.arange(ir_len) / sample_rate
        tail = rng.standard_normal(ir_len).astype(np.float32) * np.exp(
            -6.91 * t / rt60
        )
        ir = np.zeros(ir_len, dtype=np.float32)
        ir[0] = 1.0
        # sparse early reflections from the first-order images
        c = 343.0
        for d in dims:
            delay = int(2 * d / c * sample_rate)
            if 0 < delay < ir_len:
                ir[delay] += (1 - absorption) * 0.6
        ir += 0.3 * tail
        out = sps.fftconvolve(samples, ir)[: len(samples) if self.leave_length_unchanged else None]
        peak_in = np.abs(samples).max() + 1e-9
        peak_out = np.abs(out).max() + 1e-9
        return (out * (peak_in / peak_out)).astype(np.float32)


# ---------------------------------------------------------------------------
# The three reference pipelines (model/augment.py:31-150)
# ---------------------------------------------------------------------------

def get_audio_augments_baseline(min_rate: float = 0.8, max_rate: float = 1.25) -> Compose:
    return Compose([
        TimeStretch(min_rate=min_rate, max_rate=max_rate,
                    leave_length_unchanged=False, p=1.0),
    ])


def get_audio_augments_advanced(bg_noise_path: Optional[str] = None) -> Compose:
    return Compose([
        OneOf([
            AddBackgroundNoise(sounds_path=bg_noise_path, noise_rms="absolute",
                               min_absolute_rms_db=-30, max_absolute_rms_db=-10),
            AddBackgroundNoise(sounds_path=bg_noise_path,
                               min_snr_db=2, max_snr_db=4),
        ], p=0.3),
        OneOf([
            AddGaussianNoise(min_amplitude=0.001, max_amplitude=0.015, p=1.0),
            AddGaussianSNR(min_snr_db=5.0, max_snr_db=40.0, p=1.0),
            LoudnessNormalization(p=1.0),
            Aliasing(p=1.0),
        ], p=0.3),
        OneOf([
            LowPassFilter(p=1.0),
            LowShelfFilter(p=1.0),
            HighPassFilter(p=1.0),
            HighShelfFilter(p=1.0),
            BandPassFilter(p=1.0),
            BandStopFilter(p=1.0),
            ClippingDistortion(p=0.8),
            AirAbsorption(p=0.8),
            PeakingFilter(p=0.8),
        ], p=0.6),
        OneOf([
            Gain(min_gain_db=-6.0, max_gain_db=6.0, p=1.0),
            GainTransition(p=1.0),
            PitchShift(min_semitones=-4, max_semitones=4, p=0.5),
            Shift(p=0.5),
        ], p=0.3),
    ])


def get_audio_augments_office() -> Compose:
    lo_fi_codecs = OneOf([
        Mp3Compression(min_bitrate=8, max_bitrate=64, p=1.0),
        BitCrush(min_bit_depth=6, max_bit_depth=14, p=1.0),
    ], p=0.5)
    office_reverb = OneOf([
        RoomSimulator(leave_length_unchanged=True, p=1.0),
    ], p=0.5)
    return Compose([lo_fi_codecs, office_reverb])


if __name__ == "__main__":  # audition a file, like the reference's CLI
    import argparse
    from pathlib import Path

    from scipy.io import wavfile

    parser = argparse.ArgumentParser(
        description="Apply the random augmentation stack to a single wav file"
    )
    parser.add_argument("infile", type=Path)
    parser.add_argument("--out", dest="outfile", type=str, default=None)
    parser.add_argument("--sr", type=int, default=SAMPLE_RATE)
    args = parser.parse_args()

    sr, samples = wavfile.read(args.infile)
    samples = np.asarray(samples, dtype=np.float32)
    if samples.ndim > 1:
        samples = samples.mean(axis=1)
    if np.abs(samples).max() > 1.5:  # int-range wav
        samples = samples / 32768.0
    if sr != args.sr:
        idx = np.linspace(0, len(samples) - 1, int(len(samples) * args.sr / sr))
        samples = np.interp(idx, np.arange(len(samples)), samples).astype(np.float32)

    augment = Compose([
        get_audio_augments_office(),
        get_audio_augments_baseline(),
        get_audio_augments_advanced(),
    ])
    augmented = augment(samples, args.sr)

    out_path = Path(args.outfile or args.infile.stem + "_aug.wav")
    wavfile.write(out_path, args.sr, np.clip(augmented, -1, 1))
    print(f"Augmented audio written to {out_path.resolve()}")
