"""Per-example sample construction: text/prompt tokenization, timestamp
tokens, decoder target masking, audio padding and host-side augmentation.

Behavioural parity with the reference's ``AudioDataset``
(src/whisper_finetune/data/data_loader.py:41-360) with one structural
difference: the host emits *raw padded audio* plus a per-sample crop count,
and the mel spectrogram + SpecAugment run on the card inside the train step
(ops/spec_augment.py::featurize_impl) instead of inside DataLoader workers. Everything
token-side is reproduced exactly:

* lazy skipping of corrupt records with forward probing, <=32 attempts
  (data_loader.py:163-188),
* prompt tokens w.p. ``prompt_use_rate``, last ``max_prompt_length`` tokens,
  ``sot_prev`` prefix (data_loader.py:190-200),
* ``<|t.tt|>`` timestamp parsing -> ``timestamp_begin + t*50`` token ids with
  validity checks (data_loader.py:234-271),
* partial-segment rule: trailing double timestamp => crop mel at the last
  timestamp when training without timestamps (data_loader.py:253-263),
* special-token prefix [sot, <|lang|>, <|transcribe|>, (<|notimestamps|>),
  (<|nospeech|>)] (data_loader.py:202-214),
* 448-context truncation by shortening the prompt (data_loader.py:331-338),
* decoder target = prompt masked to -100 except the kept sot
  (data_loader.py:303-320),
* zero-padding audio to 480k samples *before* the mel, per the upstream
  recommendation (data_loader.py:344-346),
* BPE dropout through the tokenizer's ``dropout_prob`` (data_loader.py:230).
"""

from __future__ import annotations

import random
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from whisper_finetune_torch.ops.mel import FRAMES_PER_SECOND, N_FRAMES, N_SAMPLES
from whisper_finetune_torch.runtime import span

_TIMESTAMP_PATTERN = re.compile(r"(<\|[123]?[0-9]\.[0-9][0-9]\|>)")
MODEL_N_TEXT_CTX = 448


class SampleBuilder:
    """Builds one numeric training sample from a dataset record."""

    def __init__(
        self,
        tokenizer,
        no_timestamp_training: bool = False,
        max_prompt_length: int = 223,
        prompt_use_rate: float = 0.5,
        no_timestamps_rate: float = 0.5,
        bpe_dropout: float = 0.0,
        audio_augment=None,
    ) -> None:
        self.tokenizer = tokenizer
        self.no_timestamp_training = no_timestamp_training
        self.max_prompt_length = max_prompt_length
        self.prompt_use_rate = prompt_use_rate
        self.no_timestamps_rate = no_timestamps_rate
        self.bpe_dropout = bpe_dropout
        self.audio_augment = audio_augment

    # -- token side ---------------------------------------------------------

    def _encode_with_timestamps(self, text: str, rng: random.Random) -> List[int]:
        tokens: List[int] = []
        for part in filter(None, _TIMESTAMP_PATTERN.split(text)):
            if _TIMESTAMP_PATTERN.fullmatch(part):
                ts = float(part[2:-2])
                if ts < 0 or ts > 30 or round(ts * 100) % 2 != 0:
                    raise ValueError(f"Invalid timestamp: {ts}")
                tokens.append(self.tokenizer.timestamp_begin + round(ts * 100) // 2)
            else:
                tokens.extend(
                    self.tokenizer.encode(part, dropout_prob=self.bpe_dropout, rng=rng)
                )
        return tokens

    def _encode_without_timestamps(self, text: str, rng: random.Random) -> List[int]:
        tokens: List[int] = []
        for part in filter(None, _TIMESTAMP_PATTERN.split(text)):
            if _TIMESTAMP_PATTERN.fullmatch(part):
                ts = float(part[2:-2])
                if ts < 0 or ts > 30 or round(ts * 100) % 2 != 0:
                    raise ValueError(f"Invalid timestamp: {ts}")
                continue
            tokens.extend(
                self.tokenizer.encode(part, dropout_prob=self.bpe_dropout, rng=rng)
            )
        return tokens

    def _prompt_tokens(self, record: Dict, no_timestamps: bool, rng: random.Random) -> List[int]:
        prompt = record.get("prompt", "") or ""
        if rng.random() < self.prompt_use_rate and len(prompt) > 0:
            encode = (
                self._encode_without_timestamps
                if no_timestamps
                else self._encode_with_timestamps
            )
            tokens = encode(prompt, rng)[-self.max_prompt_length :]
            return [self.tokenizer.sot_prev] + tokens
        return []

    def _special_tokens(self, is_text_empty: bool, language: str, no_timestamps: bool) -> List[int]:
        specials = [
            self.tokenizer.sot,
            self.tokenizer.special_tokens[f"<|{language}|>"],
            self.tokenizer.special_tokens["<|transcribe|>"],
        ]
        if no_timestamps:
            specials.append(self.tokenizer.no_timestamps)
        if is_text_empty:
            specials.append(self.tokenizer.no_speech)
        return specials

    def _partial_segment_start(self, tokens: List[int]) -> Optional[float]:
        if (
            len(tokens) >= 2
            and tokens[-2] >= self.tokenizer.timestamp_begin
            and tokens[-1] >= self.tokenizer.timestamp_begin
        ):
            return (tokens[-1] - self.tokenizer.timestamp_begin) * 0.02
        return None

    def _text_tokens(
        self, text: str, no_timestamps: bool, rng: random.Random
    ) -> Tuple[List[int], Optional[float]]:
        tokens = self._encode_with_timestamps(text, rng)
        partial_start = self._partial_segment_start(tokens)
        if no_timestamps:
            tokens = [t for t in tokens if t < self.tokenizer.timestamp_begin]
        return tokens, partial_start

    @staticmethod
    def _decoder_output(
        prompt_tokens: List[int], special_tokens: List[int], text_tokens: List[int], eot: int
    ) -> List[int]:
        if not prompt_tokens:
            return special_tokens[1:] + text_tokens + [eot]
        # -100 over the prompt except the sot kept: the pretrained model puts
        # high probability on sot after a prompt, so it stays supervised.
        return (
            [-100] * (len(prompt_tokens) - 1)
            + special_tokens
            + text_tokens
            + [eot]
        )

    # -- audio side ----------------------------------------------------------

    def _prepare_audio(self, audio: np.ndarray, rng: random.Random) -> np.ndarray:
        audio = np.asarray(audio, dtype=np.float32).reshape(-1)
        if audio.shape[0] > N_SAMPLES:
            audio = audio[:N_SAMPLES]
        audio = np.pad(audio, (0, N_SAMPLES - audio.shape[0]))
        if self.audio_augment is not None:
            np_rng = np.random.default_rng(rng.getrandbits(63))
            audio = np.asarray(
                self.audio_augment(audio, 16000, np_rng), dtype=np.float32
            ).reshape(-1)
            if audio.shape[0] > N_SAMPLES:
                audio = audio[:N_SAMPLES]
            elif audio.shape[0] < N_SAMPLES:
                audio = np.pad(audio, (0, N_SAMPLES - audio.shape[0]))
        return audio

    # -- main ----------------------------------------------------------------

    def build(self, record: Dict[str, Any], rng: random.Random) -> Dict[str, Any]:
        no_timestamps = (
            self.no_timestamp_training or rng.random() < self.no_timestamps_rate
        )

        prompt_tokens = self._prompt_tokens(record, no_timestamps, rng)
        text_tokens, partial_start = self._text_tokens(
            record["text"], no_timestamps, rng
        )
        special_tokens = self._special_tokens(
            len(text_tokens) == 0, record["language"], no_timestamps
        )

        decoder_input = prompt_tokens + special_tokens + text_tokens
        if len(decoder_input) > MODEL_N_TEXT_CTX:
            too_long_by = len(decoder_input) - MODEL_N_TEXT_CTX
            prompt_tokens = prompt_tokens[:-too_long_by]
            decoder_input = prompt_tokens + special_tokens + text_tokens
            if len(decoder_input) > MODEL_N_TEXT_CTX:
                print(f"Input is still too long (length: {len(decoder_input)}).")

        decoder_output = self._decoder_output(
            prompt_tokens, special_tokens, text_tokens, self.tokenizer.eot
        )

        audio = self._prepare_audio(record["audio"]["array"], rng)

        crop_frames = N_FRAMES
        if no_timestamps and partial_start is not None:
            crop_frames = int(partial_start * FRAMES_PER_SECOND)

        return {
            "audio": audio,
            "crop_frames": crop_frames,
            "dec_input": decoder_input,
            "dec_output": decoder_output,
        }


class SampleDataset:
    """Index-addressable dataset of built samples with lazy invalid-record
    skipping (reference data_loader.py:163-188)."""

    def __init__(self, hu_dataset, builder: SampleBuilder, seed: int = 0):
        self.hu_dataset = hu_dataset
        self.builder = builder
        self.seed = seed
        self.invalid_indices: set = set()
        required = {"audio", "text", "language"}
        missing = required - set(hu_dataset.column_names)
        if missing:
            raise ValueError(f"Dataset is missing required columns: {sorted(missing)}")

    def __len__(self) -> int:
        return len(self.hu_dataset)

    def _load_valid_record(self, index: int):
        n = len(self.hu_dataset)
        if n == 0:
            raise IndexError("Dataset is empty.")
        for offset in range(min(n, 32)):
            candidate = (index + offset) % n
            if candidate in self.invalid_indices:
                continue
            try:
                record = self.hu_dataset[int(candidate)]
                np.asarray(record["audio"]["array"], dtype=np.float32)
                if not isinstance(record["text"], str):
                    raise TypeError(f"Text is not a string: {record['text']}")
                return candidate, record
            except Exception as e:  # noqa: BLE001 - match reference's broad skip
                self.invalid_indices.add(candidate)
                print(f"Skipping invalid dataset record at index {candidate}: {e}")
        raise RuntimeError(
            f"Failed to load a valid record after {min(n, 32)} attempts starting "
            f"from index {index}. Known invalid records: {len(self.invalid_indices)}"
        )

    def get(self, index: int, salt: int = 0) -> Dict[str, Any]:
        """Build the sample at ``index``. ``salt`` (e.g. the global stream
        position) decorrelates repeated visits: per-(seed, salt, index)
        deterministic RNG is reproducible under any worker parallelism,
        unlike the reference's global torch RNG draws."""
        index, record = self._load_valid_record(index)
        rng = random.Random(hash((self.seed, salt, index)))
        return self.builder.build(record, rng)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return self.get(index)


def collate(samples: List[Dict[str, Any]], pad_to=MODEL_N_TEXT_CTX) -> Dict[str, np.ndarray]:
    """Batch samples with fixed-shape padding: decoder input padded with 0,
    target with -100 (reference collate_fn, data_loader.py:362-367), but to a
    static length (448 by default), so every step sees one shape.

    ``pad_to`` may also be a sequence of bucket lengths (e.g. (128, 256,
    448)): the smallest bucket holding the batch is chosen, skipping decoder
    compute on short batches.
    """
    with span("wft.collate"):
        max_len = max(len(s["dec_input"]) for s in samples)
        if pad_to is None:
            target_len = max_len
        elif isinstance(pad_to, (list, tuple)):
            fitting = [b for b in sorted(pad_to) if b >= max_len]
            if not fitting:
                raise ValueError(
                    f"Sequence length {max_len} exceeds largest bucket {max(pad_to)}"
                )
            target_len = fitting[0]
        else:
            target_len = pad_to
        if max_len > target_len:
            raise ValueError(f"Sequence length {max_len} exceeds pad_to={target_len}")

        audio = np.stack([s["audio"] for s in samples])
        crop = np.asarray([s["crop_frames"] for s in samples], dtype=np.int32)
        dec_in = np.zeros((len(samples), target_len), dtype=np.int32)
        dec_out = np.full((len(samples), target_len), -100, dtype=np.int32)
        for i, s in enumerate(samples):
            dec_in[i, : len(s["dec_input"])] = s["dec_input"]
            dec_out[i, : len(s["dec_output"])] = s["dec_output"]
        return {
            "audio": audio,
            "crop_frames": crop,
            "dec_input": dec_in,
            "dec_output": dec_out,
        }
