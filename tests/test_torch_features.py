"""The port's feature path against the JAX package's: log-mel on full 30 s
audio, and each SpecAugment op given the same random draws (JAX draws them
from its key; the test replays the same splits and hands the values to the
port's op)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_finetune_tpu.ops import mel as jmel
from whisper_finetune_tpu.ops import spec_augment as jsa
from whisper_finetune_torch.ops import mel as tmel
from whisper_finetune_torch.ops import spec_augment as tsa


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax_on_30s_audio(n_mels):
    rng = np.random.default_rng(n_mels)
    audio = (rng.standard_normal((2, tmel.N_SAMPLES)) * 0.1).astype(np.float32)
    audio[1, 200000:] = 0.0  # a padded tail, as the loader produces
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio), n_mels=n_mels))
    out = tmel.log_mel_spectrogram(torch.from_numpy(audio), n_mels=n_mels).numpy()
    assert out.shape == ref.shape == (2, n_mels, 3000)
    # Both float32 at full precision, sums in other orders: measured 1.2e-7
    # on the CPU; the tolerance leaves ~100x for other BLAS summation orders.
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_filterbank_and_basis_are_the_jax_constants():
    for n in (80, 128):
        np.testing.assert_array_equal(tmel.mel_filterbank(n), jmel.mel_filterbank(n))
    for a, b in zip(tmel._dft_basis(), jmel._dft_basis()):
        np.testing.assert_array_equal(a, b)


def _mel(B=3, M=16, T=300, seed=0):
    return np.random.default_rng(seed).standard_normal((B, M, T)).astype(np.float32)


def test_crop_and_min_pad():
    mel = _mel()
    crop = np.array([300, 150, 10], np.int32)
    ref = jsa.crop_and_min_pad(jnp.asarray(mel), jnp.asarray(crop))
    out = tsa.crop_and_min_pad(_t(mel), _t(crop))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))  # exact: min and select


def _warp_draws(key, B, T, W):
    kp, kd = jax.random.split(key)
    return (np.asarray(jax.random.randint(kp, (B,), W, T - W)),
            np.asarray(jax.random.randint(kd, (B,), -W, W)))


@pytest.mark.parametrize("seed", [0, 1])
def test_hermite_positions(seed):
    B, T, W = 4, 300, 40
    wp, wd = _warp_draws(jax.random.PRNGKey(seed), B, T, W)
    ref = jsa._hermite_positions(T, jnp.asarray(wp), jnp.asarray(wd))
    out = tsa._hermite_positions(T, _t(wp), _t(wd))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_time_warp_same_draws(seed):
    B, T, W = 3, 300, 40
    mel = _mel(B=B, T=T, seed=seed)
    key = jax.random.PRNGKey(seed)
    wp, wd = _warp_draws(key, B, T, W)
    ref = np.asarray(jsa.time_warp(jnp.asarray(mel), key, W))
    out = tsa.time_warp(_t(mel), _t(wp), _t(wd), W).numpy()
    # Same float32 curve and interpolation: measured exact on the CPU.
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_time_warp_short_input_is_identity():
    mel = _mel(T=50)
    out = tsa.time_warp(_t(mel), torch.zeros(3, dtype=torch.long),
                        torch.zeros(3, dtype=torch.long), 40)
    np.testing.assert_array_equal(out.numpy(), mel)


def _mask_draws(key, B):
    k1, k2 = jax.random.split(key)
    return np.concatenate([np.asarray(jax.random.uniform(k1, (B, 1))),
                           np.asarray(jax.random.uniform(k2, (B, 1)))], axis=1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_time_and_freq_mask_same_draws(seed):
    B, M, T = 4, 16, 300
    mel = _mel(B=B, M=M, T=T, seed=seed)
    key = jax.random.PRNGKey(seed)
    kt, kf = jax.random.split(key)
    ref = np.asarray(jsa.time_and_freq_mask(jnp.asarray(mel), key, 100, 8))
    out = tsa.time_and_freq_mask(_t(mel), _t(_mask_draws(kt, B)), _t(_mask_draws(kf, B)),
                                 100, 8).numpy()
    np.testing.assert_array_equal(out, ref)  # exact: comparisons and multiplies by 0/1
    assert (out == 0).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_extremes_freq_mask_same_draws(seed):
    B, M = 4, 32
    mel = _mel(B=B, M=M, seed=seed)
    key = jax.random.PRNGKey(seed)
    r = np.asarray(jax.random.uniform(key, (B, 1)))
    ref = np.asarray(jsa.extremes_freq_mask(jnp.asarray(mel), key, 10, 20))
    out = tsa.extremes_freq_mask(_t(mel), _t(r), 10, 20).numpy()
    np.testing.assert_array_equal(out, ref)


def test_featurize_eval_matches_jax():
    rng = np.random.default_rng(5)
    audio = (rng.standard_normal((2, tmel.N_SAMPLES)) * 0.1).astype(np.float32)
    crop = np.array([3000, 1200], np.int32)
    cfg_j = jsa.FeaturizeConfig(n_mels=80, spec_augment=True)
    cfg_t = tsa.FeaturizeConfig(n_mels=80, spec_augment=True)
    ref = np.asarray(jsa.featurize_impl(jnp.asarray(audio), jnp.asarray(crop), None, cfg_j))
    out = tsa.featurize_impl(_t(audio), _t(crop), None, cfg_t).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_featurize_train_draws():
    """The port's own draws: gate p=0 leaves the features untouched; p=1
    masks, and the same generator seed repeats the result."""
    rng = np.random.default_rng(6)
    audio = _t((rng.standard_normal((2, 64000)) * 0.1).astype(np.float32))
    crop = torch.tensor([400, 400])
    plain = tsa.featurize_impl(audio, crop, None, tsa.FeaturizeConfig(n_mels=80))
    off = tsa.FeaturizeConfig(n_mels=80, spec_augment=True, p=0.0, time_warp_w=20)
    out = tsa.featurize_impl(audio, crop, torch.Generator().manual_seed(0), off, train=True)
    assert torch.equal(out, plain)
    on = tsa.FeaturizeConfig(n_mels=80, spec_augment=True, p=1.0, time_warp_w=20,
                             extremes=True)
    a = tsa.featurize_impl(audio, crop, torch.Generator().manual_seed(1), on, train=True)
    b = tsa.featurize_impl(audio, crop, torch.Generator().manual_seed(1), on, train=True)
    assert torch.equal(a, b) and not torch.equal(a, plain)
    assert a.shape == plain.shape and torch.isfinite(a).all()
