"""Plain float32 log-mel features and SpecAugment, the reference's own.

Log-mel as openai-whisper computes it: a 400-point periodic-Hann STFT (hop
160, centred, reflect padding) by ``torch.stft``, the power spectrum without
its last frame, the Slaney mel filterbank (librosa's), log10 clamped at 1e-10
and at the clip's maximum less 8, then (x + 4) / 4.

SpecAugment follows the recipe the program's configuration states (one
Bernoulli(p) gate a clip, a cubic-Hermite time warp through the warp point,
one time and one frequency mask of torchaudio's widths) from draws handed in:
:func:`spec_augment_draws` replays them from a ``torch.Generator`` state in
the order the recipe draws them, so the reference sees the same random
numbers as the program without calling it.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict

import numpy as np
import torch

SAMPLE_RATE, N_FFT, HOP = 16000, 400, 160


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    lin = f / f_sp
    log = min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    lin = m * f_sp
    log = min_log_hz * np.exp(logstep * (np.maximum(m, min_log_mel) - min_log_mel))
    return np.where(m >= min_log_mel, log, lin)


@lru_cache(maxsize=4)
def mel_filters(n_mels: int) -> np.ndarray:
    """librosa.filters.mel(sr=16000, n_fft=400, n_mels, htk=False,
    norm="slaney"): (n_mels, 201)."""
    fft_f = np.linspace(0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return w.astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, 480000) float32 -> (B, n_mels, 3000) float32."""
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float32, device=audio.device)
    stft = torch.stft(audio.float(), N_FFT, HOP, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = stft[..., :-1].abs() ** 2
    filters = torch.from_numpy(mel_filters(n_mels)).to(audio.device)
    mel = torch.matmul(filters, power)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def crop_min_pad(mel: torch.Tensor, crop_frames: torch.Tensor) -> torch.Tensor:
    """Frames at or past each clip's crop count take the clip's minimum over
    the kept frames."""
    T = mel.shape[-1]
    valid = (torch.arange(T, device=mel.device)[None, :] < crop_frames[:, None])[:, None, :]
    low = torch.where(valid, mel, torch.full_like(mel, float("inf"))).amin(dim=(1, 2),
                                                                           keepdim=True)
    return torch.where(valid, mel, low)


def spec_augment_draws(gen_state: torch.Tensor, rows: int, microbatches: int, T: int,
                       warp_w: int, device) -> list:
    """The recipe's draws for ``microbatches`` feature passes of ``rows``
    clips each, replayed from a generator state on ``device``: per pass a
    gate (B,), a warp point in [W, T - W), a warp distance in [-W, W),
    (B, 2) time-mask and (B, 2) frequency-mask draws."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    out = []
    for _ in range(microbatches):
        d: Dict[str, torch.Tensor] = {"gate": torch.rand((rows,), generator=gen, device=device)}
        if T > 2 * warp_w + 1:
            d["warp_p"] = torch.randint(warp_w, T - warp_w, (rows,), generator=gen, device=device)
            d["warp_d"] = torch.randint(-warp_w, warp_w, (rows,), generator=gen, device=device)
        d["time"] = torch.rand((rows, 2), generator=gen, device=device)
        d["freq"] = torch.rand((rows, 2), generator=gen, device=device)
        out.append(d)
    return out


def _warp_positions(T: int, p: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Source position in [-1, 1] of every output frame: the cubic Hermite
    curve through (0, -1), (p, p - dist scaled), (T - 1, 1) with slopes at
    the ends equal to the secants and the mean of both in the middle."""
    x0 = torch.zeros_like(p, dtype=torch.float32)
    x1 = p.float()
    x2 = torch.full_like(x1, T - 1.0)
    y0 = torch.full_like(x1, -1.0)
    y1 = (p - dist).float() * 2.0 / (T - 1.0) - 1.0
    y2 = torch.ones_like(x1)
    s0, s1 = (y1 - y0) / (x1 - x0), (y2 - y1) / (x2 - x1)
    m0, m1, m2 = s0, (s0 + s1) / 2.0, s1
    xs = torch.arange(T, dtype=torch.float32, device=p.device)[None, :]

    def seg(xa, xb, ya, yb, ma, mb):
        dx = (xb - xa)[:, None]
        t = (xs - xa[:, None]) / dx
        return ((1 + 2 * t) * (1 - t) ** 2 * ya[:, None] + t * (1 - t) ** 2 * ma[:, None] * dx
                + t ** 2 * (3 - 2 * t) * yb[:, None] + t ** 2 * (t - 1) * mb[:, None] * dx)

    return torch.where(xs < x1[:, None], seg(x0, x1, y0, y1, m0, m1), seg(x1, x2, y1, y2, m1, m2))


def _keep(draws: torch.Tensor, size: int, param: int) -> torch.Tensor:
    width = draws[:, :1] * param
    start = draws[:, 1:2] * (size - width)
    idx = torch.arange(size, dtype=torch.float32, device=draws.device)[None, :]
    return torch.where((idx >= start) & (idx < start + width), 0.0, 1.0)


def spec_augment(mel: torch.Tensor, d: Dict[str, torch.Tensor], p: float, time_param: int,
                 freq_param: int, warp_w: int) -> torch.Tensor:
    """SpecAugment of (B, M, T) features with one pass's draws ``d``."""
    B, M, T = mel.shape
    aug = mel
    if "warp_p" in d:
        ys = _warp_positions(T, d["warp_p"], d["warp_d"])
        pos = (ys + 1.0) * (T - 1) / 2.0
        i0 = torch.clamp(torch.floor(pos), 0, T - 1).long()
        i1 = torch.clamp(i0 + 1, 0, T - 1)
        w1 = pos - i0.float()
        g0 = torch.gather(aug, 2, i0[:, None, :].expand(B, M, T))
        g1 = torch.gather(aug, 2, i1[:, None, :].expand(B, M, T))
        warped = g0 * (1.0 - w1)[:, None, :] + g1 * w1[:, None, :]
        aug = torch.where(((ys >= -1.0) & (ys <= 1.0))[:, None, :], warped, 0.0)
    aug = aug * _keep(d["time"], T, time_param)[:, None, :] * _keep(d["freq"], M, freq_param)[:, :, None]
    return torch.where((d["gate"] < p)[:, None, None], aug, mel)
