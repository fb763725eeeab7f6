"""On-device SpecAugment and the fused featurize stage, the port of
``whisper_finetune_tpu/ops/spec_augment.py``.

    audio (B, 480000) -> log-mel (ops/mel.py) -> crop + min-pad
    -> time warp (Hermite curve) -> time mask -> freq mask -> extremes mask

Every op takes its random draws as tensors; :func:`featurize_impl` makes them
with one ``torch.Generator``. The distributions are the reference's: one
Bernoulli(p) gate per sample, warp point ~ U{W, T-W}, warp distance
~ U{-W, W}, torchaudio mask widths, and one shared ratio for the low/high
extremes bands.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from whisper_finetune_torch.ops.mel import log_mel_spectrogram


@dataclasses.dataclass(frozen=True)
class FeaturizeConfig:
    """Static configuration for the fused feature stage."""

    n_mels: int = 80
    spec_augment: bool = False
    time_mask_param: int = 100
    freq_mask_param: int = 43
    time_warp_w: int = 80
    p: float = 1.0
    extremes: bool = False
    low_freq_range: int = 10
    high_freq_range: int = 20


def crop_and_min_pad(mel: torch.Tensor, crop_frames: torch.Tensor) -> torch.Tensor:
    """Replace frames >= crop_frames[i] with the per-sample min over the kept
    region."""
    B, M, T = mel.shape
    idx = torch.arange(T, device=mel.device)
    valid = (idx[None, :] < crop_frames[:, None])[:, None, :]
    inf = torch.tensor(float("inf"), dtype=mel.dtype, device=mel.device)
    min_val = torch.where(valid, mel, inf).amin(dim=(1, 2), keepdim=True)
    return torch.where(valid, mel, min_val)


def _hermite_positions(T: int, warp_p: torch.Tensor, warp_d: torch.Tensor) -> torch.Tensor:
    """Cubic-Hermite warp curve through (0,-1), (warp_p, target), (T-1, 1) in
    normalized [-1, 1] coordinates, at every output frame: (B, T)."""
    x1 = warp_p.float()
    x0 = torch.zeros_like(x1)
    x2 = torch.full_like(x1, T - 1.0)
    y0 = torch.full_like(x1, -1.0)
    y1 = (warp_p - warp_d).float() * 2.0 / (T - 1.0) - 1.0
    y2 = torch.ones_like(x1)

    s0 = (y1 - y0) / (x1 - x0)
    s1 = (y2 - y1) / (x2 - x1)
    m0, m1, m2 = s0, (s0 + s1) / 2.0, s1
    xs = torch.arange(T, dtype=torch.float32, device=x1.device)[None, :]

    def hermite(xa, xb, ya, yb, ma, mb):
        dx = (xb - xa)[:, None]
        t = (xs - xa[:, None]) / dx
        h00 = (1 + 2 * t) * (1 - t) ** 2
        h10 = t * (1 - t) ** 2
        h01 = t**2 * (3 - 2 * t)
        h11 = t**2 * (t - 1)
        return (
            h00 * ya[:, None]
            + h10 * ma[:, None] * dx
            + h01 * yb[:, None]
            + h11 * mb[:, None] * dx
        )

    seg0 = hermite(x0, x1, y0, y1, m0, m1)
    seg1 = hermite(x1, x2, y1, y2, m1, m2)
    return torch.where(xs < x1[:, None], seg0, seg1)


def time_warp(mel: torch.Tensor, warp_p: torch.Tensor, warp_d: torch.Tensor,
              W: int) -> torch.Tensor:
    """Resample every sample's time axis along its warp curve (linear in
    time, zeros outside the grid). ``warp_p`` (B,) int in [W, T-W),
    ``warp_d`` (B,) int in [-W, W)."""
    B, M, T = mel.shape
    if T <= 2 * W + 1:
        return mel
    ys = _hermite_positions(T, warp_p, warp_d)
    pos = (ys + 1.0) * (T - 1) / 2.0
    in_range = (ys >= -1.0) & (ys <= 1.0)
    i0 = torch.clamp(torch.floor(pos), 0, T - 1).long()
    i1 = torch.clamp(i0 + 1, 0, T - 1)
    w1 = pos - i0.float()
    w0 = 1.0 - w1
    g0 = torch.gather(mel, 2, i0[:, None, :].expand(B, M, T))
    g1 = torch.gather(mel, 2, i1[:, None, :].expand(B, M, T))
    warped = g0 * w0[:, None, :] + g1 * w1[:, None, :]
    warped = torch.where(in_range[:, None, :], warped, 0.0)
    return warped.to(mel.dtype)


def _axis_masks(draws: torch.Tensor, size: int, mask_param: int) -> torch.Tensor:
    """(B, size) keep-masks from (B, 2) uniform draws [width, start]:
    width ~ U[0, mask_param), start ~ U[0, size - width)."""
    width = draws[:, :1] * mask_param
    start = draws[:, 1:2] * (size - width)
    idx = torch.arange(size, dtype=torch.float32, device=draws.device)[None, :]
    masked = (idx >= start) & (idx < start + width)
    return torch.where(masked, 0.0, 1.0)


def time_and_freq_mask(mel: torch.Tensor, time_draws: torch.Tensor,
                       freq_draws: torch.Tensor, time_mask_param: int,
                       freq_mask_param: int) -> torch.Tensor:
    B, M, T = mel.shape
    tmask = _axis_masks(time_draws, T, time_mask_param).to(mel.dtype)
    fmask = _axis_masks(freq_draws, M, freq_mask_param).to(mel.dtype)
    return mel * tmask[:, None, :] * fmask[:, :, None]


def extremes_freq_mask(mel: torch.Tensor, r: torch.Tensor, low_freq_range: int,
                       high_freq_range: int) -> torch.Tensor:
    """Zero the lowest/highest mel bins with one shared ratio ``r`` (B, 1)
    per sample."""
    B, M, T = mel.shape
    low_len = torch.round(r * low_freq_range)
    high_len = torch.round(r * high_freq_range)
    bins = torch.arange(M, dtype=torch.float32, device=mel.device)[None, :]
    kill = (bins < low_len) | (bins >= M - high_len)
    return mel * torch.where(kill, 0.0, 1.0)[:, :, None].to(mel.dtype)


def featurize_impl(audio: torch.Tensor, crop_frames: torch.Tensor,
                   generator: Optional[torch.Generator], cfg: FeaturizeConfig,
                   train: bool = False) -> torch.Tensor:
    """audio (B, n_samples) + per-sample crop counts -> augmented log-mel
    (B, n_mels, 3000). ``generator`` lives on the audio's device."""
    mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)
    mel = crop_and_min_pad(mel, crop_frames)
    if not train:
        return mel

    B, M, T = mel.shape
    dev = mel.device
    if cfg.spec_augment:
        gate = torch.rand((B,), generator=generator, device=dev) < cfg.p
        aug = mel
        W = cfg.time_warp_w
        if T > 2 * W + 1:
            warp_p = torch.randint(W, T - W, (B,), generator=generator, device=dev)
            warp_d = torch.randint(-W, W, (B,), generator=generator, device=dev)
            aug = time_warp(aug, warp_p, warp_d, W)
        time_draws = torch.rand((B, 2), generator=generator, device=dev)
        freq_draws = torch.rand((B, 2), generator=generator, device=dev)
        aug = time_and_freq_mask(aug, time_draws, freq_draws,
                                 cfg.time_mask_param, cfg.freq_mask_param)
        mel = torch.where(gate[:, None, None], aug, mel)

    if cfg.extremes:
        r = torch.rand((B, 1), generator=generator, device=dev)
        mel = extremes_freq_mask(mel, r, cfg.low_freq_range, cfg.high_freq_range)
    return mel
