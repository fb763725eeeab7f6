"""Convert an OpenAI-format Whisper checkpoint to a HuggingFace Transformers
model directory: the port of
``whisper_finetune_tpu/scripts/convert_openai_to_hf.py``.

    python -m whisper_finetune_torch.scripts.convert_openai_to_hf \\
        --checkpoint path/to/model.pt --pytorch_dump_folder_path out_dir [--device cpu]

The OpenAI -> HF key renames, dims -> ``WhisperConfig`` (miniature
vocabularies get in-range special ids), the tied output projection
``proj_out``, multilinguality from the vocabulary size, and the generation
config: the matching ``openai/whisper-*`` one from the HF cache if it is
there (never the network), else synthesized offline from the port's
tokenizer. The in-memory ``WhisperForConditionalGeneration`` is built and
loaded on ``--device`` (the card by default, ``cpu`` for the CPU) and
returned there, so a caller can run it; the files written are the same on
either device. Needs ``transformers`` (imported when a conversion is asked
for).
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import torch

from whisper_finetune_torch._device import resolve_device

# vocab sizes: 51865 = multilingual v1/v2 (99 langs), 51866 = large-v3 family
# (+yue), 51864 = english-only.
_ENGLISH_VOCAB = 51864
_V3_VOCAB = 51866


def _rename_map(side: str) -> Dict[str, str]:
    """Per-block suffix renames, OpenAI -> HF."""
    table = {
        "attn.query": "self_attn.q_proj",
        "attn.key": "self_attn.k_proj",
        "attn.value": "self_attn.v_proj",
        "attn.out": "self_attn.out_proj",
        "attn_ln": "self_attn_layer_norm",
        "mlp.0": "fc1",
        "mlp.2": "fc2",
        "mlp_ln": "final_layer_norm",
    }
    if side == "decoder":
        table.update({
            "cross_attn.query": "encoder_attn.q_proj",
            "cross_attn.key": "encoder_attn.k_proj",
            "cross_attn.value": "encoder_attn.v_proj",
            "cross_attn.out": "encoder_attn.out_proj",
            "cross_attn_ln": "encoder_attn_layer_norm",
        })
    return table


_TOP_LEVEL = {
    "encoder.conv1.weight": "model.encoder.conv1.weight",
    "encoder.conv1.bias": "model.encoder.conv1.bias",
    "encoder.conv2.weight": "model.encoder.conv2.weight",
    "encoder.conv2.bias": "model.encoder.conv2.bias",
    "encoder.positional_embedding": "model.encoder.embed_positions.weight",
    "encoder.ln_post.weight": "model.encoder.layer_norm.weight",
    "encoder.ln_post.bias": "model.encoder.layer_norm.bias",
    "decoder.token_embedding.weight": "model.decoder.embed_tokens.weight",
    "decoder.positional_embedding": "model.decoder.embed_positions.weight",
    "decoder.ln.weight": "model.decoder.layer_norm.weight",
    "decoder.ln.bias": "model.decoder.layer_norm.bias",
}


def openai_to_hf_state_dict(state_dict: Dict) -> Dict:
    """Rename every OpenAI key into the HF ``model.*`` namespace; an unknown
    key raises ``KeyError``."""
    out = {}
    for key, value in state_dict.items():
        if key in _TOP_LEVEL:
            out[_TOP_LEVEL[key]] = value
            continue
        parts = key.split(".")
        if len(parts) >= 4 and parts[1] == "blocks":
            side, idx = parts[0], parts[2]
            suffix, tensor = ".".join(parts[3:-1]), parts[-1]
            renames = _rename_map(side)
            if suffix in renames:
                out[f"model.{side}.layers.{idx}.{renames[suffix]}.{tensor}"] = value
                continue
        raise KeyError(f"Unrecognized OpenAI checkpoint key: {key}")
    return out


def dims_to_config(dims: Dict):
    """OpenAI dims -> ``WhisperConfig``. A miniature vocabulary (at most
    GPT-2's 50257) puts every special id on its last token and drops the
    suppress lists, which the defaults would put out of range."""
    from transformers import WhisperConfig

    vocab = int(dims["n_vocab"])
    extra = {}
    if vocab <= 50257:
        extra = dict(
            pad_token_id=vocab - 1,
            bos_token_id=vocab - 1,
            eos_token_id=vocab - 1,
            decoder_start_token_id=vocab - 1,
            suppress_tokens=None,
            begin_suppress_tokens=None,
        )
    return WhisperConfig(
        **extra,
        vocab_size=vocab,
        num_mel_bins=int(dims["n_mels"]),
        d_model=int(dims["n_audio_state"]),
        encoder_layers=int(dims["n_audio_layer"]),
        encoder_attention_heads=int(dims["n_audio_head"]),
        encoder_ffn_dim=4 * int(dims["n_audio_state"]),
        decoder_layers=int(dims["n_text_layer"]),
        decoder_attention_heads=int(dims["n_text_head"]),
        decoder_ffn_dim=4 * int(dims["n_text_state"]),
        max_source_positions=int(dims["n_audio_ctx"]),
        max_target_positions=int(dims["n_text_ctx"]),
        activation_function="gelu",
    )


def infer_multilinguality(vocab_size: int) -> Tuple[bool, int]:
    """(is_multilingual, num_languages) from the vocabulary size."""
    is_multilingual = vocab_size != _ENGLISH_VOCAB
    num_languages = 99 + (vocab_size - _V3_VOCAB + 1) if is_multilingual else 0
    return is_multilingual, max(num_languages, 0)


def build_generation_config(is_multilingual: bool, num_languages: int = 100,
                            openai_version: str = None):
    """Generation config for the converted model: the matching
    ``openai/whisper-*`` config from the HF cache alone (no network, so no
    retry stalls), else one synthesized offline from the port's tokenizer
    (language and task ids, suppress lists, the decoder's start), which is
    all faster-whisper and HF ``generate`` need."""
    import warnings

    from transformers import GenerationConfig

    if openai_version is not None:
        repo = f"openai/whisper-{openai_version}"
    elif not is_multilingual:
        repo = "openai/whisper-medium.en"
    elif num_languages < 100:
        repo = "openai/whisper-large-v2"
    else:
        repo = "openai/whisper-large-v3"

    try:
        gen_cfg = GenerationConfig.from_pretrained(repo, local_files_only=True)
        if openai_version is None:
            gen_cfg.alignment_heads = None
            warnings.warn(
                "Alignment heads are only available for original OpenAI "
                "checkpoints; word-level timestamps need them set manually."
            )
        return gen_cfg
    except Exception:
        pass  # not in the cache: synthesize below

    from whisper_finetune_torch.tokenizer import LANGUAGES, get_tokenizer

    if not is_multilingual:
        # Only the multilingual vocabulary ships with the package; without the
        # cached Hub config, English-only models get a minimal one.
        warnings.warn(
            "Offline generation-config synthesis for English-only Whisper is "
            "minimal (no suppress lists); warm the HF cache for the official "
            "openai/whisper-medium.en config."
        )
        return GenerationConfig(max_length=448, is_multilingual=False)

    tok = get_tokenizer(multilingual=is_multilingual, task="transcribe")
    sp = tok.special_tokens
    langs = list(LANGUAGES)[: num_languages or 99]
    return GenerationConfig(
        max_length=448,
        begin_suppress_tokens=[220, sp["<|endoftext|>"]],
        bos_token_id=sp["<|endoftext|>"],
        eos_token_id=sp["<|endoftext|>"],
        pad_token_id=sp["<|endoftext|>"],
        decoder_start_token_id=sp["<|startoftranscript|>"],
        suppress_tokens=sorted(tok.non_speech_tokens),
        no_timestamps_token_id=sp["<|notimestamps|>"],
        prev_sot_token_id=sp["<|startofprev|>"],
        is_multilingual=is_multilingual,
        lang_to_id={f"<|{code}|>": sp[f"<|{code}|>"] for code in langs if f"<|{code}|>" in sp},
        task_to_id={"transcribe": sp["<|transcribe|>"], "translate": sp["<|translate|>"]},
        return_timestamps=False,
        alignment_heads=None,
    )


def convert_openai_whisper_to_tfms(checkpoint_path: str, pytorch_dump_folder_path: str,
                                   device="cuda"):
    """Load an OpenAI ``.pt``, build the HF model on ``device`` in float32,
    load the weights (the key checks raise), tie ``proj_out`` to the token
    embedding, save with ``save_pretrained`` when a folder is given.
    Returns (model on ``device``, is_multilingual, num_languages)."""
    from transformers import WhisperForConditionalGeneration

    dev = resolve_device(device)
    with open(checkpoint_path, "rb") as fp:
        ckpt = torch.load(fp, map_location="cpu", weights_only=True)
    config = dims_to_config(ckpt["dims"])
    with torch.device(dev):
        model = WhisperForConditionalGeneration(config)

    hf_state = openai_to_hf_state_dict({
        k: torch.as_tensor(v).to(device=dev, dtype=torch.float32)
        for k, v in ckpt["model_state_dict"].items()})
    missing, unexpected = model.model.load_state_dict(
        {k[len("model."):]: v for k, v in hf_state.items()}, strict=False)
    if unexpected:
        raise RuntimeError(f"Unexpected keys during conversion: {unexpected}")
    if set(missing) - {"proj_out.weight"}:
        raise RuntimeError(f"Missing keys during conversion: {missing}")
    model.proj_out.weight.data = hf_state["model.decoder.embed_tokens.weight"]

    is_multilingual, num_languages = infer_multilinguality(config.vocab_size)
    model.generation_config.is_multilingual = is_multilingual
    if config.vocab_size > 50257:  # real Whisper vocabularies only, not test minis
        try:
            model.generation_config = build_generation_config(
                is_multilingual, num_languages or 100)
        except Exception as exc:  # noqa: BLE001 - the default config stays usable
            print(f"generation config synthesis skipped: {exc}")

    if pytorch_dump_folder_path:
        model.save_pretrained(pytorch_dump_folder_path)
    return model, is_multilingual, num_languages


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Convert an OpenAI-format .pt to a HuggingFace Transformers directory")
    parser.add_argument("--checkpoint", required=True, help="OpenAI-format .pt path")
    parser.add_argument("--pytorch_dump_folder_path", required=True, help="Output HF model dir")
    parser.add_argument("--device", default="cuda",
                        help="Device the model is built on: cuda (default) or cpu")
    return parser


def cli(argv=None) -> None:
    args = build_parser().parse_args(argv)
    convert_openai_whisper_to_tfms(args.checkpoint, args.pytorch_dump_folder_path, args.device)
    print(f"Converted {args.checkpoint} -> {args.pytorch_dump_folder_path}")


if __name__ == "__main__":
    cli()
