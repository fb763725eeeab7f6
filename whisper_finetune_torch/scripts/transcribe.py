"""Transcription CLI: decode audio files with a trained checkpoint.

The port of ``whisper_finetune_tpu/scripts/transcribe.py``: the port's own
KV-cached decoder (``models/decoding.py``), greedy by default, beam search
with ``--beam-size``, whisper's temperature fallback on repetition loops and
low-confidence outputs. Audio is read with scipy (wav) or numpy (raw float32
``.npy``), resampled to 16 kHz where needed, and cut or padded to the 30 s
window. Prints ``path<TAB>text`` a file.

Usage (on the card; ``--device cpu`` for the CPU):
    python -m whisper_finetune_torch.scripts.transcribe \\
        --checkpoint best_model.pt audio1.wav audio2.wav [--language de]

``--checkpoint uni-moe-2.0-omni`` (or a file of that model) runs
Uni-MoE-2.0-Omni's speech-to-text path (``models/omni.py``): greedy only,
``--max-len`` new tokens after its prompt, transcripts printed as ids.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np


def load_audio(path: str, target_sr: int = 16000) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32).reshape(-1)
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    data = np.asarray(data, dtype=np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if np.abs(data).max() > 1.5:  # integer-range wav
        data = data / 32768.0
    if sr != target_sr:
        idx = np.linspace(0, len(data) - 1, int(len(data) * target_sr / sr))
        data = np.interp(idx, np.arange(len(data)), data).astype(np.float32)
    return data


def main(args) -> None:
    from whisper_finetune_torch._device import resolve_device
    from whisper_finetune_torch.models import ForwardConfig, load_model
    from whisper_finetune_torch.models.decoding import transcribe_batch
    from whisper_finetune_torch.models.omni import is_omni
    from whisper_finetune_torch.ops.attention import resolve_auto_impls
    from whisper_finetune_torch.tokenizer import get_tokenizer

    device = resolve_device(args.device)
    model, dims = load_model(args.checkpoint, device)
    # The speech LLM's tokenizer is not in the repository: its transcripts
    # are its ids, space-separated.
    tokenizer = (None if is_omni(dims) else
                 get_tokenizer(multilingual=True, language=args.language, task="transcribe"))

    batch = np.zeros((len(args.audio), 480000), np.float32)
    for i, path in enumerate(args.audio):
        audio = load_audio(path)[:480000]
        batch[i, : len(audio)] = audio

    # The training driver's attention resolution: on a card "auto" sends the
    # encoder's self-attentions through the kernels; the token loop is the
    # cached single-query path whatever the choice.
    attn_kwargs = (resolve_auto_impls(device) if args.attn_impl == "auto"
                   else {"attn_impl": args.attn_impl})
    texts = transcribe_batch(
        model.params(), dims, batch, tokenizer,
        fcfg=ForwardConfig(compute_dtype=args.dtype, **attn_kwargs),
        language=args.language, max_len=args.max_len, beam_size=args.beam_size,
        temperatures=tuple(args.temperatures), length_penalty=args.length_penalty,
    )
    for path, text in zip(args.audio, texts):
        print(f"{path}\t{text}")


def cli(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description="Transcribe audio files")
    parser.add_argument("audio", nargs="+", help="wav or .npy (f32 mono) files")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--language", default="de")
    parser.add_argument("--max-len", type=int, default=224,
                        help="positions with the prompt (the speech LLM: new tokens)")
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--attn-impl", default="auto",
                        help="xla | flash | splash | flash_fwd | auto (the kernels at the "
                             "encoder on a card)")
    parser.add_argument("--beam-size", type=int, default=None,
                        help="beam search width at temperature 0 (default greedy)")
    parser.add_argument("--temperatures", type=float, nargs="+",
                        default=[0.0, 0.2, 0.4, 0.6, 0.8, 1.0],
                        help="fallback temperature ladder")
    parser.add_argument("--length-penalty", type=float, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    main(parser.parse_args(argv))


if __name__ == "__main__":
    cli()
