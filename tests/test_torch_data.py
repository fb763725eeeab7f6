"""The port's host data path against the JAX package's on the same records
and seeds: sample building (prompts, timestamps, truncation, BPE dropout,
invalid-record skipping), collation, sampler orders, the threaded loader
and its epoch stream, stacked microbatches, ``process_dataset`` over a
HuggingFace dataset, all exact; the audio augment pipelines to 1e-6. Plus
the pinned, non-blocking copy to the device (the CPU path here).

The JAX data package imports a module missing from the repository
(``inverse_mel``): ``jax_data`` stands a stub in for it for this module."""

import random

import numpy as np
import pytest
import torch

from test_torch_config import jax_data  # noqa: F401  (fixture)
from whisper_finetune_torch import data as D
from whisper_finetune_torch.data import augment as A
from whisper_finetune_torch.tokenizer import get_tokenizer

TEXTS = ["das ist ein test", "<|0.00|> heute scheint die sonne <|2.00|>",
         "<|0.00|> erster teil <|1.00|><|1.50|>", "", "guten morgen zürich " * 60,
         "<|0.00|> a <|1.00|><|1.00|> b <|2.50|>"]


def _records(n=24, seed=0):
    rng = np.random.default_rng(seed)
    return [{"audio": {"array": (0.1 * rng.standard_normal(int(rng.integers(8000, 520000))))
                       .astype(np.float32)},
             "text": TEXTS[i % len(TEXTS)], "language": ("de", "en", "fr")[i % 3],
             "prompt": ("vorheriger satz " * (1 + 40 * (i % 4 == 3))) if i % 2 else ""}
            for i in range(n)]


class InMemory:
    """``SampleDataset``'s contract: length, indexing, column names; some
    records raise."""

    column_names = ["audio", "text", "language", "prompt"]

    def __init__(self, records, bad=()):
        self.records, self.bad = records, set(bad)

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i):
        if i in self.bad:
            raise RuntimeError("corrupt record")
        return self.records[i]


def _assert_samples_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


BUILDERS = [
    dict(),
    dict(no_timestamp_training=True),
    dict(prompt_use_rate=1.0, no_timestamps_rate=0.0, max_prompt_length=30),
    dict(prompt_use_rate=0.0, no_timestamps_rate=1.0),
    dict(bpe_dropout=0.2),
]


@pytest.mark.parametrize("kwargs", BUILDERS)
def test_sample_builder_matches_jax(jax_data, kwargs):
    from whisper_finetune_tpu.tokenizer import get_tokenizer as j_get_tokenizer

    jb = jax_data.SampleBuilder(j_get_tokenizer(), **kwargs)
    tb = D.SampleBuilder(get_tokenizer(), **kwargs)
    for i, rec in enumerate(_records(12)):
        _assert_samples_equal(tb.build(rec, random.Random(i)), jb.build(rec, random.Random(i)))


def test_sample_dataset_and_collate_match_jax(jax_data):
    from whisper_finetune_tpu.tokenizer import get_tokenizer as j_get_tokenizer

    recs = _records(10)
    jd = jax_data.SampleDataset(InMemory(recs, bad={2, 3}),
                                jax_data.SampleBuilder(j_get_tokenizer()), seed=5)
    td = D.SampleDataset(InMemory(recs, bad={2, 3}), D.SampleBuilder(get_tokenizer()), seed=5)
    got = [td.get(i, salt=s) for i in range(10) for s in (0, 7)]
    want = [jd.get(i, salt=s) for i in range(10) for s in (0, 7)]
    for a, b in zip(got, want):
        _assert_samples_equal(a, b)
    assert td.invalid_indices == jd.invalid_indices == {2, 3}
    for pad_to in (448, (128, 256, 448), None):
        _assert_samples_equal(D.collate(got[:4], pad_to), jax_data.collate(want[:4], pad_to))
    with pytest.raises(ValueError, match="missing required columns"):
        D.SampleDataset(type("X", (), {"column_names": ["audio"]})(), None)


@pytest.mark.parametrize("world_size,shuffle,drop_last", [
    (1, True, True), (1, False, True), (3, True, True), (3, True, False)])
def test_samplers_match_jax(jax_data, world_size, shuffle, drop_last):
    for rank in range(world_size):
        t = D.ShardedSampler(23, rank, world_size, shuffle, seed=4, drop_last=drop_last)
        j = jax_data.ShardedSampler(23, rank, world_size, shuffle, seed=4, drop_last=drop_last)
        for epoch in range(3):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(t) == list(j) and len(t) == len(j)
    assert list(D.SequentialSampler(7)) == list(jax_data.SequentialSampler(7))
    sizes = [4, 0, 9, 2]
    assert D.get_dataset_boundary_indices(sizes) == jax_data.get_dataset_boundary_indices(sizes)


def test_warmup_sampler_matches_jax(jax_data):
    args = dict(warmup_indices=list(range(5, 9)), all_indices=list(range(20)),
                warmup_steps=3, batch_size=2, shuffle=True, seed=1)
    t, j = D.WarmupDatasetSampler(**args), jax_data.WarmupDatasetSampler(**args)
    for epoch in (0, 1):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        ti, ji = iter(t), iter(j)
        got, want = [next(ti) for _ in range(50)], [next(ji) for _ in range(50)]
        assert got == want and set(got[:6]) <= set(range(5, 9))
    with pytest.raises(ValueError, match="warmup_indices"):
        D.WarmupDatasetSampler([], [1], 1, 1)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_stream_and_stack_match_jax(jax_data, num_workers):
    from whisper_finetune_tpu.tokenizer import get_tokenizer as j_get_tokenizer

    recs = _records(11)
    kw = dict(batch_size=3, num_workers=num_workers, drop_last=True, seed=2,
              pad_to=(128, 256, 448))
    tl = D.BatchLoader(D.SampleDataset(InMemory(recs), D.SampleBuilder(get_tokenizer()), 3), **kw)
    jl = jax_data.BatchLoader(jax_data.SampleDataset(
        InMemory(recs), jax_data.SampleBuilder(j_get_tokenizer()), 3), **kw)
    assert len(tl) == len(jl) == 3
    ts, js = D.infinite_batches(tl), jax_data.infinite_batches(jl)
    got = [next(ts) for _ in range(8)]  # 3 epochs: per-epoch reshuffle and salts
    want = [next(js) for _ in range(8)]
    for a, b in zip(got, want):
        _assert_samples_equal(a, b)
    for i in (0, 4):
        _assert_samples_equal(D.stack_microbatches(got[i:i + 4]),
                              jax_data.stack_microbatches(want[i:i + 4]))


def test_to_device_cpu():
    batch = D.stack_microbatches([D.collate([
        {"audio": np.ones(4, np.float32), "crop_frames": 3000, "dec_input": [1, 2],
         "dec_output": [2, 3]}], pad_to=4)])
    out = D.to_device(batch, "cpu")
    assert out["dec_input"].dtype == out["dec_output"].dtype == torch.int64
    assert out["audio"].dtype == torch.float32 and out["crop_frames"].dtype == torch.int32
    for k in batch:
        np.testing.assert_array_equal(out[k].numpy(), batch[k])


def _hf(rows):
    import datasets

    return datasets.Dataset.from_dict({k: [r[k] for r in rows] for k in rows[0]})


def test_process_dataset_matches_jax(jax_data, tmp_path):
    import datasets

    rows = [{"sentence": f"satz {i}", "language": ("German", "english", "de")[i % 3],
             "speaker": f"s{i % 4}", "audio": [float(i)]} for i in range(40)]
    datasets.DatasetDict({"train": _hf(rows), "test": _hf(rows[:6])}).save_to_disk(
        str(tmp_path / "a"))
    _hf([{"text": f"b{i}", "audio": [0.0]} for i in range(9)]).save_to_disk(str(tmp_path / "b"))
    names = [str(tmp_path / "a"), str(tmp_path / "b")]
    for args, kwargs in (
            ((names, [None, 4], "train", [None]), {}),
            ((names, [3], "train", ["speaker", None]), dict(return_sizes=True)),
            ((names, [5, None], "validation", [None, None]),
             dict(select_language_tag=[["de"], None], return_sizes=True))):
        got = D.process_dataset(*args, rng=np.random.default_rng(0), **kwargs)
        want = jax_data.process_dataset(*args, rng=np.random.default_rng(0), **kwargs)
        if kwargs.get("return_sizes"):
            assert got[1] == want[1]
            got, want = got[0], want[0]
        assert got.column_names == want.column_names
        assert got.to_dict() == want.to_dict()
    assert D.normalize_language(" German ") == jax_data.normalize_language(" German ") == "de"


@pytest.mark.parametrize("name", ["baseline", "office", "advanced"])
def test_augment_pipelines_match_jax(jax_data, name):
    import whisper_finetune_tpu.data.augment as JA

    make = {"baseline": lambda m: m.get_audio_augments_baseline(0.8, 1.25),
            "office": lambda m: m.get_audio_augments_office(),
            "advanced": lambda m: m.get_audio_augments_advanced()}[name]
    t, j = make(A), make(JA)
    audio = (0.1 * np.sin(2 * np.pi * 440 * np.arange(32000) / 16000)
             + 0.01 * np.random.default_rng(0).standard_normal(32000)).astype(np.float32)
    for seed in range(4):
        got = t(audio, 16000, np.random.default_rng(seed))
        want = j(audio, 16000, np.random.default_rng(seed))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_background_noise_bank_is_the_ports_own():
    from pathlib import Path

    bank = A.AddBackgroundNoise(p=1.0)._bank
    assert len(bank) == 6 and all(len(b) == 160000 for b in bank)
    here = Path(A.__file__).resolve().parent.parent / "assets" / "bg_noise"
    assert len(list(here.glob("*.wav"))) == 6
