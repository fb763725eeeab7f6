"""The transcribe CLI (``python -m whisper_finetune_torch.scripts.transcribe``)
on the CPU (``--device cpu``) against the JAX package's CLI, on a small
``.pt`` and wav files the test writes: one ``path<TAB>text`` line a file,
the same texts; ``load_audio`` as JAX's; and the ``cuda`` default raising
without a card."""

import argparse
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from whisper_finetune_tpu.models import ModelDimensions, init_params, save_checkpoint
from whisper_finetune_tpu.scripts import transcribe as jcli
from whisper_finetune_torch.scripts import transcribe as tcli

ROOT = Path(__file__).resolve().parent.parent
DIMS = ModelDimensions(n_mels=80, n_audio_ctx=1500, n_audio_state=32, n_audio_head=2,
                       n_audio_layer=1, n_vocab=51866, n_text_ctx=448, n_text_head=2,
                       n_text_state=32, n_text_layer=1)
ARGS = ["--max-len", "12", "--dtype", "float32", "--attn-impl", "xla"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("transcribe")
    params = jax.tree.map(np.array, init_params(jax.random.PRNGKey(0), DIMS))
    params["decoder"]["tok_emb"] *= 20.0  # sharp logits: no near-ties between the packages
    ckpt = str(tmp / "small.pt")
    save_checkpoint(ckpt, params, DIMS)
    rng = np.random.default_rng(0)
    wavs = []
    for i, (sr, dtype) in enumerate(((16000, np.int16), (8000, np.float32))):
        audio = rng.standard_normal(sr * (3 + i)) * 0.1
        path = str(tmp / f"a{i}.wav")
        wavfile.write(path, sr, (audio * 32767).astype(np.int16) if dtype == np.int16
                      else audio.astype(np.float32))
        wavs.append(path)
    npy = str(tmp / "a2.npy")
    np.save(npy, (rng.standard_normal(16000) * 0.1).astype(np.float32))
    return ckpt, wavs + [npy]


def test_load_audio_matches_jax(files):
    for path in files[1]:
        got, want = tcli.load_audio(path), jcli.load_audio(path)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("temperatures", [["0"], ["0", "0.5", "1"]])
def test_cli_on_cpu_matches_jax(files, capsys, temperatures):
    """One line a file, in order. At temperature 0 alone the texts are JAX's;
    with the fallback ladder random weights fail the log-prob threshold at
    every rung, so the texts are the last rung's samples, which are the
    port's own (not bit-equal to JAX's sampler)."""
    ckpt, audio = files
    tcli.cli(["--checkpoint", ckpt, *audio, "--device", "cpu", *ARGS,
              "--temperatures", *temperatures])
    got = capsys.readouterr().out.strip().splitlines()
    jcli.main(argparse.Namespace(checkpoint=ckpt, audio=audio, language="de", max_len=12,
                                 dtype="float32", attn_impl="xla", beam_size=None,
                                 temperatures=[float(t) for t in temperatures],
                                 length_penalty=None))
    want = capsys.readouterr().out.strip().splitlines()
    assert [line.split("\t")[0] for line in got] == [line.split("\t")[0] for line in want] == audio
    if temperatures == ["0"]:
        assert got == want


def test_cli_as_a_module_on_cpu(files):
    ckpt, audio = files
    out = subprocess.run([sys.executable, "-m", "whisper_finetune_torch.scripts.transcribe",
                          "--checkpoint", ckpt, audio[0], "--device", "cpu", *ARGS,
                          "--beam-size", "2"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith(audio[0] + "\t")


def test_cli_defaults_to_the_card(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.cli(["--checkpoint", files[0], files[1][0]])
